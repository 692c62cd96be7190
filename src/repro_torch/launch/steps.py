"""Step builders of training (``build_train_step``, ``param_count``,
``pick_optimizer``), of the classic dense-cache serving path and of the
serving engine (PyTorch counterpart of ``repro.launch.steps``:
``build_prefill_step``, ``build_serve_step``, ``build_paged_step``,
``build_ragged_step``, ``build_recurrent_step`` and the build-time W8A8
check), and the engine's compiled step, :class:`StepGraphs`.

The builders validate the configuration once and return plain closures
that run eagerly.  Where the JAX package ``jax.jit``-compiles each serving
step once per shape, the port captures each step's whole device program
(the model step, the fused sampling and draft verification, the in-place
pool or cache writes) as one CUDA graph per step key and replays it:
:class:`StepGraphs`, which the engine and the classic path's decode loop
(:func:`run_serve_step`) share.

On a (data, model) mesh (``launch.mesh``) each rank builds the same steps
with ``mesh=``: the step body runs in the mesh's scope
(``distributed.sharding.activation_sharding``) on the rank's slices,
after the build-time refusals of :func:`_resolve_attn_kernel`.  Such
steps run eagerly: the ranks' collectives are not captured in a CUDA
graph (:class:`StepGraphs` refuses).

The reference's mesh wrappers (:func:`jit_train_step`,
:func:`jit_serve_step`, :func:`jit_prefill_step`) return one rank's step
with the whole abstract trees on the meta device (:func:`abstract_params`,
:func:`abstract_cache`, :func:`input_specs`) and their spec trees, which
the dry run (``launch.dryrun``) cuts to a rank.
"""
from __future__ import annotations

import contextlib
import gc
import math
from typing import Callable, Hashable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.qmodel import QuantContext, QuantMode
from repro_torch.core.tree import leaves, unflatten
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.collectives import fsdp_gather
from repro_torch.kernels import ops as kops
from repro_torch.models import model as M
from repro_torch.models.attention import KVCache
from repro_torch.optim import adafactor, adamw, clip_by_global_norm
from repro_torch.optim.optimizers import Optimizer, OptState

__all__ = ["param_count", "pick_optimizer", "loss_and_grads",
           "build_train_step", "abstract_params", "abstract_opt_state",
           "abstract_cache", "abstract_paged_cache", "input_specs",
           "batch_specs_tree", "jit_serve_step", "jit_prefill_step",
           "jit_train_step", "default_accum_steps", "serve_needs_fsdp",
           "SERVE_FSDP_BYTES", "GRAD_BUCKET", "mean_over_data",
           "ADAFACTOR_THRESHOLD", "check_matmul_kernel",
           "build_prefill_step", "build_serve_step",
           "build_paged_step", "build_ragged_step", "build_recurrent_step",
           "StepGraphs", "serve_step_key", "run_serve_step"]

ADAFACTOR_THRESHOLD = 30e9  # params; above it AdamW's 12 bytes a param


def param_count(cfg: ModelConfig) -> int:
    """Parameters of ``cfg``'s tree, counted from its shapes on the meta
    device (nothing allocated)."""
    return sum(t.numel() for t in leaves(abstract_params(cfg)))


def pick_optimizer(cfg: ModelConfig) -> Optimizer:
    return adafactor() if param_count(cfg) > ADAFACTOR_THRESHOLD \
        else adamw()


def abstract_params(cfg: ModelConfig) -> dict:
    """``cfg``'s whole params tree on the meta device (shapes and dtypes,
    nothing allocated)."""
    return M.init_params(cfg, device="meta")


def abstract_opt_state(cfg: ModelConfig, opt: Optimizer) -> OptState:
    """``opt``'s whole state for ``cfg``'s params, on the meta device."""
    return opt.init(abstract_params(cfg))


def abstract_cache(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """The classic path's whole cache (``models.model.init_cache``) for
    ``batch`` rows of ``max_seq`` positions, on the meta device."""
    return M.init_cache(cfg, batch, max_seq, device="meta", mesh=None)


def abstract_paged_cache(cfg: ModelConfig, num_blocks: int,
                         block_size: int) -> dict:
    """The engine's whole KV block pool (``models.model.
    init_paged_cache``), on the meta device."""
    return M.init_paged_cache(cfg, num_blocks, block_size, device="meta",
                              mesh=None)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The whole model inputs of one shape cell, on the meta device (the
    reference's ``ShapeDtypeStruct`` stand-ins): train / prefill a token
    batch (train with labels and a float32 mask; the audio family with
    stub ``encoder_features`` in bf16), decode one new token a row, the
    cache at ``seq_len`` and the position, a 0-d int32."""
    b, s = shape.global_batch, shape.seq_len

    def tok(*sh):
        return torch.empty(sh, dtype=torch.int32, device="meta")

    def features():
        return torch.empty((b, cfg.encdec.encoder_seq, cfg.d_model),
                           dtype=torch.bfloat16, device="meta")

    if shape.kind == "train":
        batch = {"tokens": tok(b, s), "labels": tok(b, s),
                 "mask": torch.empty((b, s), dtype=torch.float32,
                                     device="meta")}
        if cfg.family == "audio":
            batch["encoder_features"] = features()
        return {"batch": batch}
    if shape.kind == "prefill":
        batch = {"tokens": tok(b, s)}
        if cfg.family == "audio":
            batch["encoder_features"] = features()
        return {"batch": batch}
    return {"tokens": tok(b, 1), "cache": abstract_cache(cfg, b, s),
            "pos": tok()}


def batch_specs_tree(batch: dict, mesh) -> dict:
    """Each batch entry's spec: its batch dim over the composite data
    axis (``distributed.sharding.batch_sharding``)."""
    return {k: shd.batch_sharding(mesh, v.ndim) for k, v in batch.items()}


def loss_and_grads(params, batch, cfg, ctx, remat=False, *, mesh=None,
                   fsdp_dims=None):
    """``models.model.loss_fn`` and its gradients: (loss, metrics,
    gradients in ``leaves(params)``'s order), all detached.  A leaf
    the loss does not reach, and every leaf when nothing does (INT mode:
    each ``qlinear`` casts to codes), gets a zero gradient, the value the
    reference's autodiff gives there.  ``fsdp_dims``: for each leaf, the
    dim it is cut over ``mesh``'s data axis (FSDP) or None; such a leaf is
    gathered whole for the forward (``distributed.collectives.
    fsdp_gather``) and its gradient is the rank's piece, meaned over the
    data axis."""
    ls = leaves(params)
    for p in ls:
        p.requires_grad_(True)
    try:
        use = ls if fsdp_dims is None else [
            p if d is None else fsdp_gather(p, mesh, d)
            for p, d in zip(ls, fsdp_dims)]
        loss, metrics = M.loss_fn(unflatten(params, use), batch, cfg, ctx,
                                  remat=remat)
        gs = (torch.autograd.grad(loss, ls, allow_unused=True)
              if loss.requires_grad else [None] * len(ls))
    finally:
        for p in ls:
            p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(ls, gs)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


# the data axis's mean of the gradients goes through buckets of at most
# this many fp32 elements (one all-reduce a bucket: over gloo a CUDA
# tensor is staged through the host)
GRAD_BUCKET = 1 << 26


def mean_over_data(grads: list, specs: list, mesh) -> None:
    """The gradients (a rank's, in leaf order, their leaves cut as
    ``specs``) of the leaves the data axis does not cut, meaned over it
    IN PLACE, in flat fp32 buckets of at most :data:`GRAD_BUCKET`
    elements (a leaf FSDP cuts over ``data`` got its mean from its
    gather's backward)."""
    if mesh.shape["data"] == 1:
        return
    grads = [g for g, sp in zip(grads, specs)
             if "data" not in shd.spec_axes(sp)]
    n = mesh.shape["data"]
    bucket: list = []
    size = 0

    def flush():
        flat = torch.cat([g.reshape(-1).float() for g in bucket])
        flat = mesh.all_reduce(flat, "data") / n
        off = 0
        for g in bucket:
            g.copy_(flat[off:off + g.numel()].view(g.shape))
            off += g.numel()

    for g in grads:
        if bucket and size + g.numel() > GRAD_BUCKET:
            flush()
            bucket, size = [], 0
        bucket.append(g)
        size += g.numel()
    if bucket:
        flush()


def build_train_step(cfg: ModelConfig, ctx: QuantContext, opt: Optimizer,
                     lr_fn, *, remat=True, clip_norm: float = 1.0,
                     accum_steps: int = 1, mesh=None, fsdp: bool = False):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss's gradients (``models.model.loss_fn`` with
    ``remat``), clipped to a global norm of ``clip_norm``, then ``opt``'s
    update at ``lr_fn(opt_state.step)``; params and moments are updated
    IN PLACE and returned.  ``metrics``: ``loss``, ``grad_norm``, ``lr``
    and the loss's ``nll`` / ``z_loss`` / ``ppl_proxy`` (with
    accumulation ``nll`` alone, the mean loss), 0-d tensors on the
    device.

    ``accum_steps > 1`` splits the batch A x B/A into microbatches whose
    gradients accumulate in fp32 and are averaged (fp32 gradients then
    reach the update, as in the reference).

    On a (data, model) ``mesh`` (``launch.mesh.RankMesh``) the step runs
    on one rank: ``params`` and ``opt_state`` are its pieces, cut by the
    training rules (``distributed.sharding.param_sharding_rules(fsdp=
    fsdp)``; the state by ``_opt_spec_like``), ``batch`` its data block
    of the global batch (rows ``d B/D`` to ``(d + 1) B/D``), which
    accumulation splits A x B/(D A).  The loss is the global one; a
    leaf's gradient is meaned over the data axis (bucketed into flat fp32
    all-reduces), or, for a leaf FSDP cuts over it, reduce-scattered by
    the gather's backward; the clip's norm sums each leaf over the axes
    cutting it; the update runs on the rank's pieces.  The metrics are
    the same on every rank."""
    check_matmul_kernel(cfg, ctx)
    specs = p_spec = fsdp_dims = None
    if mesh is not None:
        _resolve_attn_kernel(cfg, mesh, train=True)
        if ctx.mode is QuantMode.FAKE_SF and shd.model_shards(mesh) > 1:
            raise NotImplementedError(
                "fake_sf's per-tensor maxima take no gradient through a "
                "model-axis all-reduce; training fake_sf over a cut model "
                "is ROADMAP Queue 1 item 8's")
        params_abs = abstract_params(cfg)
        p_spec = shd.param_sharding_rules(params_abs, mesh, fsdp=fsdp,
                                          cfg=cfg)
        specs = shd.spec_list(params_abs, p_spec)
        if fsdp:
            fsdp_dims = [shd.data_dim(sp) for sp in specs]
    on_mesh = {} if mesh is None else dict(mesh=mesh, specs=p_spec)

    def grads_of(params, batch):
        return loss_and_grads(params, batch, cfg, ctx, remat, mesh=mesh,
                              fsdp_dims=fsdp_dims)

    def train_step(params, opt_state: OptState, batch):
        with _mesh_scope(mesh, batch_split=True, train=True):
            if accum_steps == 1:
                loss, metrics, grads = grads_of(params, batch)
            else:
                micro = {k: v.reshape((accum_steps,
                                       v.shape[0] // accum_steps)
                                      + tuple(v.shape[1:]))
                         for k, v in batch.items()}
                grads = [torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
                         for p in leaves(params)]
                loss = 0.0
                for i in range(accum_steps):
                    mb_loss, _, g = grads_of(
                        params, {k: v[i] for k, v in micro.items()})
                    for acc, gi in zip(grads, g):
                        acc.add_(gi.float())
                    loss = loss + mb_loss
                grads = [g / accum_steps for g in grads]
                loss = loss / accum_steps
                metrics = {"nll": loss}
            if mesh is not None:
                mean_over_data(grads, specs, mesh)
        grads, gnorm = clip_by_global_norm(unflatten(params, grads),
                                           clip_norm, **on_mesh)
        lr = lr_fn(opt_state.step)
        params, opt_state = opt.update(grads, opt_state, params, lr,
                                       **on_mesh)
        return params, opt_state, dict(metrics, loss=loss, grad_norm=gnorm,
                                       lr=lr)

    return train_step


# replicate serving weights over the data axis below this many bytes a
# rank (the reference's measured re-gather cost of FSDP decode)
SERVE_FSDP_BYTES = 12e9


def serve_needs_fsdp(cfg: ModelConfig, mesh, bytes_per_param=2) -> bool:
    """Whether serving ``cfg`` on ``mesh`` must cut its weights over the
    data axis too (FSDP): above :data:`SERVE_FSDP_BYTES` a rank, counting
    the non-expert params (serving cuts the MoE expert stacks 2-D, never
    gathered), as the reference's."""
    n = param_count(cfg)
    if cfg.moe is not None:
        m = cfg.moe
        n -= (cfg.n_layers - m.n_dense_layers) * m.e_padded * 3 \
            * cfg.d_model * m.d_expert
    return n * bytes_per_param / mesh.shape["model"] > SERVE_FSDP_BYTES


def default_accum_steps(cfg: ModelConfig, shape: ShapeConfig, mesh) -> int:
    """Microbatches so that each data rank sees about one sequence a
    micro-step on configs above 10 B params; smaller ones take the whole
    batch in one step (the reference's)."""
    if param_count(cfg) < 10e9:
        return 1
    ds = shd.data_shards(mesh)
    return max(1, shape.global_batch // ds)


def jit_train_step(cfg: ModelConfig, ctx: QuantContext, mesh,
                   opt: Optimizer, lr_fn, *, remat: bool = True,
                   fsdp: bool = True, accum_steps: int = 1):
    """The reference's mesh wrapper of the train step, less its ``wire``
    (the port compiles nothing): ``(step, (params_abs, opt_abs, p_spec,
    o_spec))`` with ``step`` :func:`build_train_step` on ``mesh`` (one
    rank's), ``params_abs`` / ``opt_abs`` the whole params and optimizer
    state on the meta device, ``p_spec`` the params' spec tree by the
    training rules (``fsdp``: large leaves also cut over ``data``) and
    ``o_spec`` the state's (``distributed.sharding._opt_spec_like``).  A
    rank's state is ``shard_tree`` of the whole one, or ``rank_zeros`` of
    ``opt_abs`` for a fresh one."""
    params_abs = abstract_params(cfg)
    p_spec = shd.param_sharding_rules(params_abs, mesh, fsdp=fsdp, cfg=cfg)
    opt_abs = abstract_opt_state(cfg, opt)
    o_spec = shd._opt_spec_like(opt_abs, p_spec)
    step = build_train_step(cfg, ctx, opt, lr_fn, remat=remat,
                            accum_steps=accum_steps, mesh=mesh, fsdp=fsdp)
    return step, (params_abs, opt_abs, p_spec, o_spec)


def _serve_params(cfg: ModelConfig, mesh, fsdp: bool):
    if fsdp:
        raise NotImplementedError(
            "serving with FSDP (the weights cut over data too, gathered "
            "every step) is ROADMAP Queue 1 item 8's: the port serves with "
            "the weights whole over data")
    params_abs = abstract_params(cfg)
    return params_abs, shd.param_sharding_rules(params_abs, mesh,
                                                fsdp=False, serve=True,
                                                cfg=cfg)


def jit_serve_step(cfg: ModelConfig, ctx: QuantContext, mesh,
                   shape: ShapeConfig, *, fsdp: bool = True):
    """The reference's mesh wrapper of one decode cell's step, less its
    ``jax.jit`` (the port compiles nothing): ``(step, (params_abs,
    cache_abs, p_spec, c_spec))``, ``step`` :func:`build_serve_step` on
    ``mesh`` (one rank's; the data axis cuts the batch when it divides
    it, else its ranks are replicas), ``params_abs`` / ``cache_abs`` the
    whole params and the whole cache at ``seq_len`` on the meta device,
    ``p_spec`` the params' specs by serving's rules and ``c_spec`` the
    cache's (``distributed.sharding.cache_sharding_rules``, the
    head-cut form: the port's ranks hold their KV heads for either
    kernel).  A rank's trees are ``shard_tree`` of the whole ones.
    ``fsdp`` raises: the port serves without it (item 8)."""
    params_abs, p_spec = _serve_params(cfg, mesh, fsdp)
    cache_abs = abstract_cache(cfg, shape.global_batch, shape.seq_len)
    c_spec = shd.cache_sharding_rules(cache_abs, mesh, attn_kernel="flash",
                                      attn_shard_axis=cfg.attn_shard_axis)
    step = build_serve_step(cfg, ctx, mesh=mesh, batch_split=(
        shape.global_batch % shd.data_shards(mesh) == 0))
    return step, (params_abs, cache_abs, p_spec, c_spec)


def jit_prefill_step(cfg: ModelConfig, ctx: QuantContext, mesh,
                     shape: ShapeConfig, *, fsdp: bool = True):
    """As :func:`jit_serve_step` for a prefill cell: ``(step, (params_abs,
    batch_abs, p_spec))``, ``step`` :func:`build_prefill_step` on
    ``mesh``, ``batch_abs`` the whole batch (:func:`input_specs`), whose
    specs are :func:`batch_specs_tree`'s."""
    params_abs, p_spec = _serve_params(cfg, mesh, fsdp)
    step = build_prefill_step(cfg, ctx, mesh=mesh, batch_split=(
        shape.global_batch % shd.data_shards(mesh) == 0))
    return step, (params_abs, input_specs(cfg, shape)["batch"], p_spec)


def check_matmul_kernel(cfg: ModelConfig, ctx: QuantContext) -> None:
    """Build-time validation of the W8A8 matmul path: int8 weight codes
    only mean something on the calibrated grids of an INT-mode context, so
    any other mode is refused before the first step, not at the first
    decoded token."""
    if cfg.matmul_kernel not in ("dense", "int8"):
        raise ValueError(f"unknown matmul_kernel={cfg.matmul_kernel!r}; "
                         "expected 'dense' or 'int8'")
    if cfg.matmul_kernel == "int8" and ctx.mode is not QuantMode.INT:
        raise NotImplementedError(
            "matmul_kernel='int8' is the W8A8 deploy path: it requires a "
            "calibrated QuantContext in INT mode (serve_engine(w8a8=True) "
            f"builds one); got mode={ctx.mode.value!r}")


def _mesh_size(mesh) -> int:
    return 1 if mesh is None else math.prod(mesh.shape.values())


def _resolve_attn_kernel(cfg: ModelConfig, mesh=None, *,
                         train: bool = False) -> ModelConfig:
    """The step's config, checked against ``mesh``.  On a mesh of more
    than one rank the attention heads are cut over ``cfg.attn_shard_axis``
    (whole GQA groups, the KV heads and their cache or pool with them), so
    the builder refuses, as
    the reference's does: a shard axis other than ``model`` (the rules
    and the model code are wired to it), and an axis that does not divide
    the KV head count (``n_heads`` for MLA, whose kernels run with as many
    KV heads as query heads).  The reference refuses for its flash kernels
    only, its chunked path falling back to a sequence-cut cache; every
    attention of the port cuts heads, so it refuses for either kernel (the
    sequence cut is ROADMAP Queue 1 item 8's).  Then the family's and the
    layout's refusals (``distributed.sharding.local_config``; ``train``:
    under training's rules); and, serving the moe family, a mesh on which
    the reference would turn FSDP on (:func:`serve_needs_fsdp`)."""
    if _mesh_size(mesh) > 1:
        if cfg.attn_shard_axis != "model":
            raise NotImplementedError(
                f"attn_shard_axis='{cfg.attn_shard_axis}' is not wired "
                f"through the cache / activation sharding rules; only "
                f"'model' is supported on a mesh of more than one rank")
        tp = kops.attn_shard_size(mesh)
        kvh = cfg.n_heads if cfg.mla is not None else cfg.n_kv_heads
        if kvh % tp and cfg.family != "ssm":     # RWKV6 has no attention
            raise NotImplementedError(
                f"attention shards KV heads over mesh axis "
                f"'{cfg.attn_shard_axis}' (size {tp}), which must divide "
                f"the KV head count ({kvh}"
                + (", = n_heads for MLA" if cfg.mla is not None else
                   " = n_kv_heads")
                + f"); pick a mesh whose '{cfg.attn_shard_axis}' axis "
                f"divides it (the sequence-cut decode is ROADMAP Queue 1 "
                f"item 8's)")
        shd.local_config(cfg, mesh, train=train)
        if cfg.family == "moe" and not train \
                and serve_needs_fsdp(cfg, mesh):
            raise NotImplementedError(
                f"serving {cfg.name} on a model axis of "
                f"{mesh.shape['model']} would cut its non-expert weights "
                f"over data too (the reference's serve_needs_fsdp, over "
                f"{SERVE_FSDP_BYTES / 1e9:g} GB a rank); serving runs without "
                f"FSDP, whose gather is ROADMAP Queue 1 item 8's: take a "
                f"larger model axis")
    return cfg


def _mesh_scope(mesh, batch_split: bool = False, train: bool = False):
    """The mesh's scope for a step body (a null context without one)."""
    return (shd.activation_sharding(mesh, batch_split=batch_split,
                                    train=train)
            if mesh is not None else contextlib.nullcontext())


def build_prefill_step(cfg: ModelConfig, ctx: QuantContext,
                       max_seq: Optional[int] = None, *, mesh=None,
                       batch_split: bool = False):
    """``prefill_step(params, batch) -> (last logits (B, V), cache)`` with
    a cache of ``max_seq`` positions.  On ``mesh``: this rank's params and
    batch rows (``batch_split``: the data axis cuts the batch), its cache
    of its KV heads, every rank's logits."""
    cfg = _resolve_attn_kernel(cfg, mesh)
    check_matmul_kernel(cfg, ctx)

    def prefill_step(params, batch):
        with _mesh_scope(mesh, batch_split):
            return M.prefill(params, batch, cfg, ctx, max_seq=max_seq)

    return prefill_step


def build_serve_step(cfg: ModelConfig, ctx: QuantContext, *, mesh=None,
                     batch_split: bool = False):
    """One batched greedy decode step: ``serve_step(params, tokens (B, 1),
    cache, pos) -> (next tokens (B, 1) int32, cache)``, ``pos`` a host int
    or a 0-d integer tensor on the device (the form a captured step takes,
    :func:`run_serve_step`); ties take the first index, as ``jnp.argmax``
    does.  ``mesh`` as :func:`build_prefill_step`'s."""
    cfg = _resolve_attn_kernel(cfg, mesh)
    check_matmul_kernel(cfg, ctx)

    def serve_step(params, tokens, cache, pos):
        with _mesh_scope(mesh, batch_split):
            logits, cache = M.decode_step(params, tokens, cache, pos, cfg,
                                          ctx)
        return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], cache

    return serve_step


def build_paged_step(cfg: ModelConfig, ctx: QuantContext, *, mesh=None):
    """One step of the legacy per-shape engine over the paged KV block
    pool: ``paged_step(params, tokens (B, C), cache, positions (B, C),
    block_tables (B, W), work=None) -> (logits (B, C, V), cache)``, with
    ``work`` K4's work list for the positions (planned once per step).
    The same step serves the decode (n_slots, 1), prefill-chunk (1, C)
    and verify (n_slots, K + 1) shapes.  On ``mesh``: this rank's params
    and pool (its KV heads), every rank's tokens, positions and tables,
    every rank's logits."""
    cfg = _resolve_attn_kernel(cfg, mesh)
    check_matmul_kernel(cfg, ctx)

    def paged_step(params, tokens, cache, positions, block_tables,
                   work=None):
        with _mesh_scope(mesh):
            return M.paged_step(params, tokens, cache, positions,
                                block_tables, cfg, ctx, work=work)

    return paged_step


def build_ragged_step(cfg: ModelConfig, ctx: QuantContext, *, mesh=None):
    """One UNIFIED serving step over the flattened mixed stream:
    ``ragged_step(params, tokens (T,), cache, positions (T,), ragged
    RaggedBatch) -> (logits (T, V), cache)``, the pool updated in place.
    The engine captures it, with its sampling, once per (T_pad, S_pad)
    and sampling key (:class:`StepGraphs`), as the JAX engine's jit
    specializes per (T_pad, S_pad) only.  ``mesh`` as
    :func:`build_paged_step`'s."""
    cfg = _resolve_attn_kernel(cfg, mesh)
    check_matmul_kernel(cfg, ctx)

    def ragged_step(params, tokens, cache, positions, ragged):
        with _mesh_scope(mesh):
            return M.ragged_step(params, tokens, cache, positions, ragged,
                                 cfg, ctx)

    return ragged_step


def build_recurrent_step(cfg: ModelConfig, ctx: QuantContext, *,
                         mesh=None):
    """One serving step on the fixed-slab recurrent substrate:
    ``recurrent_step(params, tokens (B, C), cache, slab_ids (B,), q_len
    (B,), positions, block_tables, work=None) -> (logits (B, V), cache)``,
    the slabs (and the hybrid's KV pool) updated in place.  ONE fixed
    shape (B = n_slots, C = chunk) covers prefill chunks, decode rows and
    idle lanes at once (per-row ``q_len`` does the bucketing), so the
    engine captures it once per sampling key, as the JAX engine jits it
    once.  ``positions`` / ``block_tables`` are None for the pure
    recurrent family; the hybrid threads them, and K4's ``work`` list for
    the positions, into the shared attention block.  On ``mesh``: this
    rank's params and pool (its KV heads), the slabs and every staged
    array every rank's, every rank's logits."""
    cfg = _resolve_attn_kernel(cfg, mesh)
    check_matmul_kernel(cfg, ctx)

    def recurrent_step(params, tokens, cache, slab_ids, q_len,
                       positions=None, block_tables=None, work=None):
        with _mesh_scope(mesh):
            return M.paged_recurrent_step(params, tokens, cache, slab_ids,
                                          q_len, positions, block_tables,
                                          cfg, ctx, work=work)

    return recurrent_step


# ---------------------------------------------------------------------------
# the compiled serving step
# ---------------------------------------------------------------------------

_DTYPES = {np.dtype(np.int32): torch.int32,
           np.dtype(np.float32): torch.float32}


class _Staged:
    """A step's host arrays (int32 or float32) in static buffers, one per
    array: a host tensor (pinned on the card) and a device tensor, which
    :meth:`stage` fills with a queued copy.  ``inputs`` are the device
    tensors; on the CPU the host tensors are the step's inputs."""

    def __init__(self, arrays: dict, device: torch.device, pinned: bool):
        self.host, self.inputs = {}, {}
        for name, a in arrays.items():
            if a.dtype not in _DTYPES:
                raise TypeError(f"staged array {name!r} is {a.dtype}: the "
                                f"step stages int32 and float32 arrays")
            h = torch.empty(a.shape, dtype=_DTYPES[a.dtype],
                            pin_memory=pinned)
            self.host[name] = h
            self.inputs[name] = (h if device.type == "cpu" else
                                 torch.empty_like(h, device=device))

    def stage(self, arrays: dict) -> None:
        """Copy ``arrays`` (this step's names, shapes and types) in; the
        transfers are queued on the current stream."""
        layout = [(n, tuple(h.shape), h.dtype) for n, h in self.host.items()]
        got = [(n, a.shape, _DTYPES.get(a.dtype)) for n, a in arrays.items()]
        if got != layout:
            raise ValueError(f"staged arrays {got} do not match the step's "
                             f"layout {layout}")
        for name, a in arrays.items():
            h = self.host[name]
            h.numpy()[...] = a
            d = self.inputs[name]
            if d is not h:
                d.copy_(h, non_blocking=True)


class _CUDAStepGraph:
    """One step captured by ``torch.cuda.graph`` on the helper's side
    stream into the memory pool every key shares, with the engine's
    generator registered, so that a replay advances it as the eager step
    does (the default CUDA generator is registered by ``torch.cuda.graph``
    itself)."""

    def __init__(self, generator, pool, stream):
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            register = getattr(self.graph, "register_generator_state", None)
            if register is None:
                raise RuntimeError(
                    f"torch {torch.__version__} cannot register a generator "
                    f"with a CUDA graph (CUDAGraph.register_generator_state)"
                    f": the sampled step cannot be captured")
            register(generator)
        self.pool, self.stream = pool, stream
        self.output: Optional[torch.Tensor] = None

    def capture(self, fn: Callable[[], torch.Tensor]) -> None:
        # no cyclic garbage collection while capturing: it may destroy a
        # dead engine's CUDA graphs, which a capture does not permit (the
        # capture fails, cudaErrorStreamCaptureInvalidated)
        enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, pool=self.pool,
                                  stream=self.stream):
                self.output = fn()
        finally:
            if enabled:
                gc.enable()

    def replay(self) -> None:
        self.graph.replay()


class _Entry:
    """A step key's static buffers and, from its second call, its graph
    and the launches each kernel wrapper counted while it was captured."""

    def __init__(self, staged: _Staged):
        self.staged = staged
        self.graph = None
        self.launches: dict = {}


class StepGraphs:
    """The compiled serving step: one CUDA graph per step key, replayed.

    :meth:`run` takes a step key (the engine's: ``("ragged", T_pad, S_pad,
    k_cap, has_top_k, sampled)``, ``(B, C, verify, k_cap, has_top_k,
    sampled)`` or ``("recurrent", B, C, k_cap, has_top_k, sampled)``; the
    classic path's ``("decode", B, S_max)`` (:func:`serve_step_key`;
    over a recurrent cache, its tensors' shapes): everything a step's device
    program depends on beyond its staged arrays), the step function
    ``fn(inputs) -> output`` over the staged arrays' device tensors, and
    the step's host arrays.

    * Without capture (``capture=False``: the CPU, or an engine built with
      ``graphs=False``) the arrays are staged into fresh buffers and
      ``fn`` runs eagerly over them.
    * The first call of a key stages the arrays into the key's own static
      buffers (pinned on the host) and runs ``fn`` eagerly over them on
      the capture stream: the real step, which also warms the key up for
      its capture (first-use builds, the kernels' one-time attributes).
    * The second call stages its arrays, captures ``fn`` as a graph into
      the pool every key shares, and replays it; every later call stages
      its arrays and replays the graph.

    Every launch that runs on the card is counted once in
    ``kernels.ops.LAUNCHES``: an eager call's by its kernel wrappers; a
    capture launches nothing, so its counts are taken back out and kept
    with the key, and each replay adds them.  Nothing is caught: a failed
    capture or replay raises, the step never runs eagerly in its place.
    ``fn`` may read nothing back to the host and its launches must depend
    only on the key and the arrays' shapes (the padded work lists of
    ``kernels.ragged_flash.pad_work``).  ``graph_factory(generator, pool,
    stream)`` makes a graph object with ``capture(fn)``, ``replay()`` and
    ``output`` (the tests pass a stand-in); its default is a CUDA graph.
    ``mesh``: the rank's mesh, if any; one of more than one rank refuses
    ``capture`` (its gloo collectives cannot be captured)."""

    def __init__(self, device, generator: Optional[torch.Generator] = None,
                 *, capture: bool, graph_factory=None, mesh=None):
        if capture and _mesh_size(mesh) > 1:
            raise ValueError(
                "a mesh of more than one rank runs its steps eagerly: its "
                "collectives (gloo through the host) cannot be captured in "
                "a CUDA graph (graphs=False)")
        self.device = torch.device(device)
        self.generator = generator
        self.capture = capture
        if capture and graph_factory is None and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs capture steps on a CUDA device, "
                             f"not {self.device}")
        self._factory = graph_factory or _CUDAStepGraph
        self._entries: dict[Hashable, _Entry] = {}
        self._pool = self._stream = None
        self.first_calls = 0        # since start / reset_counts
        self.captures = 0
        self.replays = 0
        self.last = None            # how the last run ran its key: "eager",
        #                             "capture" (and replay) or "replay"

    @property
    def keys(self) -> list:
        return list(self._entries)

    def reset_counts(self) -> None:
        self.first_calls = self.captures = self.replays = 0

    @torch.no_grad()
    def run(self, key: Hashable, fn: Callable[[dict], torch.Tensor],
            arrays: dict) -> torch.Tensor:
        """One step: ``fn``'s output on the device (on a replay, the
        graph's static output, valid until the key's next replay)."""
        if not self.capture:
            self.last = "eager"
            staged = _Staged(arrays, self.device, pinned=False)
            staged.stage(arrays)
            return fn(staged.inputs)
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = _Entry(_Staged(
                arrays, self.device, pinned=self.device.type == "cuda"))
            entry.staged.stage(arrays)
            self.first_calls += 1
            self.last = "eager"
            with self._on_side_stream():
                return fn(entry.staged.inputs)
        entry.staged.stage(arrays)
        if entry.graph is None:
            self._capture(entry, fn)
            self.last = "capture"
        else:
            self.last = "replay"
        entry.graph.replay()
        for name, n in entry.launches.items():
            kops.LAUNCHES[name] += n
        self.replays += 1
        return entry.graph.output

    def _capture(self, entry: _Entry, fn) -> None:
        if self.device.type == "cuda" and self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        counts = dict(kops.LAUNCHES)
        graph = self._factory(self.generator, self._pool, self._stream)
        graph.capture(lambda: fn(entry.staged.inputs))
        entry.launches = {k: n - counts.get(k, 0)
                          for k, n in kops.LAUNCHES.items()
                          if n != counts.get(k, 0)}
        for k in entry.launches:            # a capture launches nothing
            kops.LAUNCHES[k] = counts.get(k, 0)
        entry.graph = graph
        self.captures += 1

    @contextlib.contextmanager
    def _on_side_stream(self):
        """The capture stream (on the card) as the current stream, after
        the work queued so far; the caller's stream waits on it after."""
        if self.device.type != "cuda":
            yield
            return
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            yield
        cur.wait_stream(self._stream)


def serve_step_key(tokens, cache: dict) -> tuple:
    """The classic decode step's key in :class:`StepGraphs`: ``("decode",
    B, S_max)`` over a dense KV cache; over any other cache (RWKV6's
    states, zamba2's states and dense KV, the MoE family's ``kv_dense``
    beside ``kv``, MLA's latent caches, the audio family's ``memory``
    tensor beside ``kv``) ``("decode", B, shapes)``, the shape of every
    cache tensor by name."""
    b = tokens.shape[0]
    if set(cache) == {"kv"} and isinstance(cache["kv"], KVCache):
        return ("decode", b, cache["kv"].k.shape[2])
    shapes = []
    for name, part in cache.items():
        if isinstance(part, torch.Tensor):
            shapes.append((name, tuple(part.shape)))
        else:
            shapes += [(f"{name}.{field}", tuple(t.shape))
                       for field, t in zip(part._fields, part)]
    return ("decode", b, tuple(shapes))


def run_serve_step(graphs: StepGraphs, serve_step, params, tokens,
                   cache: dict, pos: int) -> torch.Tensor:
    """One decode step of the classic path through ``graphs``:
    ``serve_step`` (:func:`build_serve_step`) over the tokens (B, 1) int32
    (a numpy array) and the position ``pos``, both staged into the step
    key's (:func:`serve_step_key`) buffers, ``pos`` as a 0-d int32 that
    the step reads only on the device.  Returns the next tokens (B, 1)
    int32 on the device (on a replay the graph's static output, valid
    until the key's next replay).  The cache (KV and recurrent states) is
    written in place, so a captured step's static memory is the cache
    prefill allocated: one ``graphs`` serves one (params, cache) pair."""
    if "kv" in cache:
        s_max = cache["kv"][0].shape[2]
        if not 0 <= pos < s_max:
            raise ValueError(f"pos {pos} outside the cache [0, {s_max})")

    def step(inputs):
        return serve_step(params, inputs["tokens"], cache, inputs["pos"])[0]

    return graphs.run(serve_step_key(tokens, cache), step,
                      {"tokens": np.asarray(tokens, dtype=np.int32),
                       "pos": np.asarray(pos, dtype=np.int32)})
