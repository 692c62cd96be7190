"""Partition rules of the (data, model) mesh: param path -> spec for every
architecture (PyTorch counterpart of ``repro.distributed.sharding``).

Strategy (as the reference's):
  * tensor parallelism on the ``model`` axis: attention heads (whole GQA
    groups), the MLP hidden, the experts, the vocab (embedding rows and
    LM-head columns);
  * data parallelism on ``data`` (x ``pod`` when both exist): the batch;
  * FSDP: large leaves also cut over ``data`` on a dim that divides.

A spec is a tuple with one entry a dim: None (whole), an axis name, or a
tuple of axis names (the reference's ``PartitionSpec`` entries).  The
rules read nothing of a mesh but ``shape`` (axis name -> size) and
``axis_names``, so any object with those two can stand in for one
(``launch.mesh.RankMesh`` is the port's).

The reference stacks each block leaf over the layers, (L, ...), and its
rules see that stacked leaf; the port keeps one dict a layer.  So a
per-layer leaf's spec is computed on the stacked shape the reference
would see (``(L,) + shape``, or ``(G, g) + shape`` for the hybrid's
Mamba blocks) and the stacking entries are dropped: the per-layer spec
is the stacked spec minus its leading entries, ``_add_fsdp`` keeps the
reference's start past the stacking axis and ``min_size`` counts the
stacked leaf's elements.  (The one spec that cannot drop to a layer: on
the hybrid's (G, g, ...) leaves the reference's FSDP may take the ``g``
axis, which a per-layer leaf does not have; the dropped entry is
ROADMAP Queue 3's.)

Where the JAX package constrains activations through GSPMD
(``constrain``), the port's ranks each hold their own slice and the
model code adds the collectives itself; the scope
(:func:`activation_sharding`) tells it the mesh, and
:func:`local_config` gives the per-rank view of a config under which the
blocks run unchanged (under serving's rules and training's alike: the
dense, recurrent and audio families' cuts are the same; FSDP's data cut
is gathered before a block runs; the moe family's expert cuts are
serving's or training's, as the scope says, its layer exchanging token
rows itself, ``models.mlp.moe``).  :func:`shard_params` cuts a full tree
down to one rank's leaves by these rules, :func:`shard_tree` any state tree
by a spec tree (the optimizer's by :func:`_opt_spec_like`), and
:func:`unshard_params` gathers a rank's tree back to the whole one.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import re
import threading
from typing import Any

import torch

from repro_torch.core.tree import leaves_with_paths, unflatten

__all__ = ["DATA_AXES", "param_sharding_rules", "opt_sharding_rules",
           "batch_sharding", "cache_sharding_rules", "activation_sharding",
           "current_mesh", "data_shards", "batch_shards", "model_shards",
           "tp_mesh", "training",
           "local_config", "shard_params", "leaf_spec", "reference_leaf",
           "spec_axes", "spec_list", "data_dim", "shard_leaf", "unshard_leaf",
           "shard_tree", "unshard_params", "rank_zeros"]

DATA_AXES = ("pod", "data")  # gradient-reduction axes when both exist


def _dp(mesh) -> Any:
    """The composite data-parallel axis spec entry for this mesh."""
    return tuple(a for a in DATA_AXES if a in mesh.axis_names) or None


# (regex on path, [candidate specs]).  First matching pattern wins; within
# a pattern the FIRST candidate whose cut dims all DIVIDE the leaf shape is
# chosen, else the first candidate with its non-dividing axes stripped
_RULES: list[tuple[str, list]] = [
    # embeddings / head: vocab over model, fall back to d_model
    (r"embed$",                 [("model", None), (None, "model"), ()]),
    (r"lm_head$",               [(None, "model"), ("model", None), ()]),
    # attention (GQA): heads over model
    (r"attn/w[qkv]$",           [(None, "model"), ("model", None)]),
    (r"attn/wo$",               [("model", None), (None, "model")]),
    (r"attn/b[qkv]$",           [("model",), ()]),
    # MLA: latent down-projections replicated, up-projections by head
    (r"attn/wq_a$|attn/wkv_a$", [(None, None)]),
    (r"attn/wq_b$|attn/wkv_b$", [(None, "model"), ("model", None)]),
    # cross attention (whisper decoder)
    (r"cross/w[qkv]$",          [(None, "model"), ("model", None)]),
    (r"cross/wo$",              [("model", None), (None, "model")]),
    (r"cross/b[qkv]$",          [("model",), ()]),
    # dense MLP: hidden over model
    (r"mlp/w1$|mlp/w3$",        [(None, "model"), ("model", None)]),
    (r"mlp/w2$",                [("model", None), (None, "model")]),
    # MoE: experts over model; fall back to TP inside each expert
    (r"moe/router$",            [(None, None)]),
    (r"moe/w[13]$",             [("model", None, None),
                                 (None, "model", None),
                                 (None, None, "model")]),
    (r"moe/w2$",                [("model", None, None),
                                 (None, None, "model"),
                                 (None, "model", None)]),
    (r"moe/shared/w[13]$",      [(None, "model"), ("model", None)]),
    (r"moe/shared/w2$",         [("model", None), (None, "model")]),
    # mamba2: contract-dim cut on in-proj, free-dim on out-proj
    (r"ssm/w_in$",              [("model", None)]),
    (r"ssm/w_out$",             [(None, "model"), ("model", None)]),
    (r"ssm/conv_w$|ssm/conv_b$", [()]),
    # rwkv6: contract-dim cut (the head layout stays local)
    (r"rwkv/w[rkvgo]$",         [("model", None)]),
    (r"rwkv/wk_ffn$|rwkv/wr_ffn$", [(None, "model"), ("model", None)]),
    (r"rwkv/wv_ffn$",           [("model", None), (None, "model")]),
    # zamba2 shared block input projection
    (r"shared/in_proj$|in_proj$", [(None, "model"), ("model", None)]),
    # norms, gains, scalars: replicated
    (r".*",                     [()]),
]

# serve-mode MoE: 2-D (expert x data) cut so expert weights are never
# gathered at decode
_SERVE_RULES: list[tuple[str, list]] = [
    (r"moe/w[13]$", [("model", None, "data"), ("model", None, None),
                     (None, "model", None)]),
    (r"moe/w2$",    [("model", "data", None), ("model", None, None),
                     (None, None, "model")]),
]


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, tuple):
        return math.prod(mesh.shape[a] for a in entry)
    return mesh.shape[entry]


def _fit_rank(spec: tuple, ndim: int) -> list:
    """Pad / truncate a spec to the leaf's rank; a stacked leaf's leading
    axes get None."""
    entries = list(spec)
    if len(entries) < ndim:
        entries = [None] * (ndim - len(entries)) + entries
    elif len(entries) > ndim:
        entries = entries[-ndim:] if ndim else []
    return entries


def _divisible(entries: list, shape: tuple, mesh) -> bool:
    return all(e is None or dim % _axis_size(mesh, e) == 0
               for dim, e in zip(shape, entries))


def _spec_for(path: str, shape: tuple, mesh) -> tuple:
    ndim = len(shape)
    for pat, candidates in _RULES:
        if re.search(pat, path):
            for cand in candidates:
                entries = _fit_rank(cand, ndim)
                if _divisible(entries, shape, mesh):
                    return tuple(entries)
            # last resort: strip non-dividing axes from the first candidate
            return tuple(
                e if e is not None and shape[i] % _axis_size(mesh, e) == 0
                else None
                for i, e in enumerate(_fit_rank(candidates[0], ndim)))
    return ()


def _add_fsdp(spec: tuple, path: str, shape: tuple, mesh,
              min_size: int = 1 << 20) -> tuple:
    """FSDP: also cut a large leaf over the data axis, on the first dim
    that is not cut already, that the data axis divides, and that is not
    a block leaf's (leading) layer-stack dim.  ``shape`` is the stacked
    leaf's."""
    if "data" not in mesh.axis_names:
        return spec
    if math.prod(shape) < min_size:
        return spec
    dsize = mesh.shape["data"]
    entries = list(spec)
    start = 1 if ("blocks" in path and len(shape) == len(entries)) else 0
    # stacked leaves got their scan dim as a prepended None in _spec_for
    if len(entries) and entries[0] is None and "blocks" in path:
        start = 1
    for i in range(start, len(entries)):
        if entries[i] is None and shape[i] % dsize == 0 and shape[i] >= dsize:
            entries[i] = "data"
            return tuple(entries)
    return spec


def leaf_spec(path: str, shape: tuple, mesh, *, fsdp: bool = True,
              serve: bool = False) -> tuple:
    """The reference's spec of one (stacked) leaf at ``path``."""
    shape = tuple(shape)
    if serve and "data" in mesh.axis_names:
        for pat, cands in _SERVE_RULES:
            if re.search(pat, path):
                for cand in cands:
                    entries = _fit_rank(cand, len(shape))
                    if _divisible(entries, shape, mesh):
                        return tuple(entries)
                break
    spec = _spec_for(path, shape, mesh)
    return _add_fsdp(spec, path, shape, mesh) if fsdp else spec


# ---------------------------------------------------------------------------
# the port's trees against the reference's stacked paths
# ---------------------------------------------------------------------------

_STACKS = ("blocks", "dense_blocks", "enc_blocks")


def reference_leaf(params: dict, path: str, shape: tuple, cfg):
    """(the reference's path, its stacked shape, the number of stacking
    dims) of the port's leaf ``path`` of shape ``shape`` in ``params``:
    a block leaf ``blocks/<i>/...`` is the reference's ``blocks/...``
    (the hybrid's ``blocks/mamba/...``) of shape (L,) + shape (the
    hybrid's (G, g) + shape)."""
    parts = path.split("/")
    if len(parts) > 2 and parts[0] in _STACKS and parts[1].isdigit():
        rest = "/".join(parts[2:])
        n = len(params[parts[0]])
        hybrid = parts[0] == "blocks" and cfg is not None \
            and cfg.family == "hybrid"
        if hybrid:
            g = cfg.hybrid.attn_every
            return f"blocks/mamba/{rest}", (n // g, g) + shape, 2
        if parts[0] == "blocks" and cfg is None and "shared" in params:
            raise ValueError("the hybrid family's blocks stack on (group, "
                             "block): pass its cfg")
        return f"{parts[0]}/{rest}", (n,) + shape, 1
    return path, shape, 0


def _param_specs(params: Any, mesh, fsdp: bool, serve: bool, cfg,
                 stacked: bool) -> list:
    """The specs of ``params``' leaves, in ``core.tree``'s order."""
    specs = []
    for path, leaf in leaves_with_paths(params):
        ref_path, shape, lead = reference_leaf(params, path,
                                               tuple(leaf.shape), cfg)
        spec = leaf_spec(ref_path, shape, mesh, fsdp=fsdp, serve=serve)
        specs.append(spec if stacked else spec[lead:])
    return specs


def param_sharding_rules(params: Any, mesh, fsdp: bool = True,
                         serve: bool = False, *, cfg=None) -> Any:
    """Spec tree matching the port's ``params`` (tensors, or anything with
    a ``shape``: ``init_params(cfg, device="meta")``).  A block leaf's
    spec is its stacked spec minus the stacking entries.  ``cfg`` names
    the hybrid family's (group, block) stacking."""
    return unflatten(params, _param_specs(params, mesh, fsdp, serve, cfg,
                                          False))


def opt_sharding_rules(opt_state: Any, param_specs_by_path: Any, mesh, *,
                       cfg=None, stacked: bool = False) -> Any:
    """Moments inherit their param's rule (``_spec_for`` on the moment's
    own shape: adafactor's factored rows / columns fall through to
    replicated); the step counter is replicated.  ``opt_state`` is an
    ``optim.OptState`` whose ``m`` / ``v`` trees are laid out as the
    params; ``param_specs_by_path`` is unused, as in the reference."""
    del param_specs_by_path

    def moments(tree):
        if tree is None:
            return None
        specs = []
        for path, leaf in leaves_with_paths(tree):
            ref_path, shape, lead = reference_leaf(tree, path,
                                                   tuple(leaf.shape), cfg)
            spec = _spec_for(ref_path, shape, mesh)
            specs.append(spec if stacked else spec[lead:])
        return unflatten(tree, specs)

    return type(opt_state)(step=(), m=moments(opt_state.m),
                           v=moments(opt_state.v))


def batch_sharding(mesh, batch_dims: int = 2) -> tuple:
    """(B, S, ...) activations: batch over the composite data axis."""
    return (_dp(mesh),) + (None,) * (batch_dims - 1)


def cache_sharding_rules(cache: Any, mesh, attn_kernel: str = "chunked",
                         attn_shard_axis: str = "model") -> Any:
    """Specs of the port's caches, whose tensors stack the layers as the
    reference's do: (L, B, S, H, D) KV -> batch over data when it divides,
    plus a kernel-dependent second axis; the engine's (L, NB, BS, KVH, D)
    pool KV heads over ``attn_shard_axis`` (block tables replicated: the
    blocks of one sequence land on every rank's pool at the same indices).

    ``attn_kernel='chunked'`` keeps a dense cache SEQUENCE-cut over model
    (the reference's context-parallel decode), ``'flash'`` HEAD-cut when
    the axis divides the KV heads; the port's ranks always hold their KV
    heads (``models.model.init_cache``), so the sequence cut is ROADMAP
    Queue 1 item 8's.  MLA's (L, B, S, lat) latents and rope keys are cut
    by batch and kept WHOLE over ``model`` (the reference cuts them by
    sequence there; ROADMAP Queue 3).

    The recurrent states (RWKV6's ``state``: (L, B, 1, d) token shifts and
    the (L, B, H, 64, 64) wkv; the hybrid's ``ssm``: (G, g, B, ...) conv
    windows and SSD states) are cut by batch over data and kept WHOLE over
    ``model``: every rank runs the scans on the whole state (their
    projections' outputs are whole on every rank), where the reference's
    rule reads any 5-d leaf as a stacked KV (ROADMAP Queue 3).  The
    engine's state slabs (a tree with the slabs' grid ``exp``) have no
    batch axis and are whole on every rank: the data ranks are replicas.
    whisper's encoder ``memory`` (B, T, d) is cut by batch and kept whole
    over ``model`` (the cross-attention's column-cut ``wk`` / ``wv`` read
    whole rows; the reference cuts ``d``; ROADMAP Queue 3)."""
    dp = _dp(mesh)
    dsize = _axis_size(mesh, dp) if dp else 1
    slabs = isinstance(cache, dict) and "exp" in cache

    def batch_only(shape: tuple, bdim: int) -> tuple:
        entries = [None] * len(shape)
        if not slabs and shape[bdim] % dsize == 0:
            entries[bdim] = dp
        return tuple(entries)

    def spec(ps: str, leaf) -> tuple:
        shape = tuple(leaf.shape)
        nd = len(shape)
        batch_ok = nd >= 2 and shape[1] % dsize == 0 if dsize else False
        bdim = dp if batch_ok else None
        if "paged" in ps and nd == 5:          # (L, NB, BS, KVH, D) pool
            hdim = (attn_shard_axis
                    if attn_shard_axis in mesh.axis_names
                    and shape[3] % mesh.shape[attn_shard_axis] == 0
                    else None)
            return (None, None, None, hdim, None)
        if ps.startswith("state/"):            # RWKV6: (L, B, ...)
            return batch_only(shape, 1)
        if ps.startswith("ssm/"):              # the hybrid: (G, g, B, ...)
            return batch_only(shape, 2)
        if "memory" in ps:                     # (B, T, d)
            return batch_only(shape, 0)
        if nd == 5:                            # (L, B, S, H, D) stacked KV
            if (attn_kernel == "flash"
                    and attn_shard_axis in mesh.axis_names
                    and shape[3] % mesh.shape[attn_shard_axis] == 0):
                return (None, bdim, None, attn_shard_axis, None)
            sdim = "model" if shape[2] % mesh.shape["model"] == 0 else None
            return (None, bdim, sdim, None, None)
        if ps.endswith(("c_kv", "k_pe")):      # (L, B, S, lat) MLA latents
            # whole over model: a rank's absorbed decode reads every
            # latent row for its own heads
            return (None, bdim, None, None)
        return (None,) * nd

    return unflatten(cache, [spec(p, leaf)
                             for p, leaf in leaves_with_paths(cache)])


# ---------------------------------------------------------------------------
# the scope model code reads
# ---------------------------------------------------------------------------

_TLS = threading.local()


@contextlib.contextmanager
def activation_sharding(mesh, *, batch_split: bool = False,
                        train: bool = False):
    """The mesh the model code in this scope runs on (one rank's slice of
    every cut tensor; collectives where the reference's GSPMD would
    reshard).  ``batch_split``: the data axis holds one slice of the
    batch each (classic ``serve``, training), not replicas (the engine).
    ``train``: the params are cut by training's rules (the moe family's
    experts whole in their hidden, :func:`local_config`)."""
    prev = getattr(_TLS, "scope", None)
    _TLS.scope = (mesh, batch_split, train)
    try:
        yield
    finally:
        _TLS.scope = prev


def current_mesh():
    """The mesh of the active :func:`activation_sharding` scope (None
    outside one)."""
    scope = getattr(_TLS, "scope", None)
    return None if scope is None else scope[0]


def data_shards(mesh=None) -> int:
    """Size of the composite data axis of ``mesh`` (default: the active
    scope's; 1 without a mesh)."""
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None:
        return 1
    dp = _dp(mesh)
    return _axis_size(mesh, dp) if dp else 1


def training() -> bool:
    """Whether the active scope cuts the params by training's rules."""
    scope = getattr(_TLS, "scope", None)
    return scope is not None and scope[2]


def batch_shards() -> int:
    """Slices the batch is cut into in the active scope: the data axis's
    size when the scope splits the batch, else 1."""
    scope = getattr(_TLS, "scope", None)
    return data_shards() if scope is not None and scope[1] else 1


def model_shards(mesh=None) -> int:
    """Size of the ``model`` axis of ``mesh`` (default: the scope's; 1
    without a mesh)."""
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None or "model" not in mesh.axis_names:
        return 1
    return mesh.shape["model"]


def tp_mesh():
    """The scope's mesh when its model axis has more than one rank (the
    model code's collectives run over it), else None."""
    mesh = current_mesh()
    return mesh if model_shards(mesh) > 1 else None


def _refuse(what: str):
    raise NotImplementedError(
        f"{what} is ROADMAP Queue 1 item 8's (serving and training over a "
        f"mesh cover the dense, vlm, moe, ssm, hybrid and audio families)")


_LM_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")


def local_config(cfg, mesh, *, train: bool = False):
    """The per-rank view of ``cfg`` on ``mesh``, under which a block runs
    unchanged on its rank's weights: heads and KV heads (under MLA the
    nominal KV heads, ``n_heads``; the hybrid's: its shared attention
    block's) divided by the model axis (the head dim pinned), and d_ff
    where the rules cut an MLP hidden (the dense layers', whisper's, the
    hybrid's shared MLP, RWKV6's channel mix); for the moe family the
    expert stacks over ``model`` and, where serving's 2-D rule cuts it,
    each expert's hidden over ``data`` (``MoEConfig.expert_shards`` /
    ``hidden_shards``; the router's experts, top-k and the capacity stay
    the whole model's).  ``train``: training's rules, under which each
    expert's hidden stays whole (``hidden_shards == 1``); the other
    families' views are serving's.  The vocab and d_model stay whole: the
    head gathers its logits, and the recurrent families' projections give
    whole outputs (RWKV6's heads, which its time mix reads from d_model,
    and the recurrent states stay whole on every rank).  Refuses what the
    port does not cut: a shard axis other than ``model``, and a model axis
    that does not divide the KV heads, d_ff, the padded vocab, the experts
    or (the ssm and hybrid families) d_model, where the rules fall back to
    another layout.  Without a mesh, or on a mesh of one rank, ``cfg``
    itself."""
    if mesh is None or math.prod(mesh.shape.values()) == 1:
        return cfg
    if cfg.family not in _LM_FAMILIES:
        _refuse(f"the {cfg.family!r} family under a mesh of more than one "
                f"rank")
    tp = model_shards(mesh)
    view = {}
    if cfg.moe is not None:
        view["moe"] = _moe_view(cfg, mesh, train)
    if tp > 1:
        if cfg.attn_shard_axis != "model":
            raise NotImplementedError(
                f"attn_shard_axis={cfg.attn_shard_axis!r} is not wired; "
                f"only 'model' is supported on a mesh of more than one rank")
        heads = cfg.family != "ssm"         # RWKV6 has no attention
        if heads:
            from repro_torch.kernels.ops import _check_head_divisibility
            _check_head_divisibility(cfg.n_kv_heads, tp)
        dense = cfg.moe is None or cfg.moe.n_dense_layers > 0
        cuts = [("d_ff", cfg.d_ff if dense else 0),
                ("padded vocab", cfg.vocab_padded)]
        if cfg.family in ("ssm", "hybrid"):
            # RWKV6's w[rkvgo] rows and wr_ffn columns; mamba2's w_in rows,
            # its w_out and the shared block's in_proj columns
            cuts.append(("d_model", cfg.d_model))
        for what, n in cuts:
            if n % tp:
                _refuse(f"a model axis ({tp}) that does not divide the "
                        f"{what} ({n}) (its fall-back layout)")
        view["d_ff"] = cfg.d_ff // tp if dense else cfg.d_ff
        if heads:
            view.update(n_heads=cfg.n_heads // tp,
                        n_kv_heads=cfg.n_kv_heads // tp,
                        head_dim=cfg.resolved_head_dim)
    return dataclasses.replace(cfg, **view) if view else cfg


def _moe_view(cfg, mesh, train: bool = False):
    """The rank's ``MoEConfig``: the cuts serving's rules (or with
    ``train`` training's) give an expert stack (``moe/w1``, ``moe/w2``:
    the experts over ``model``; serving's also each one's hidden over
    ``data`` when the axis divides it), refusing the rules' fall-back
    (experts the model axis does not divide) and a shared expert whose
    hidden the model axis does not divide.  FSDP's data cut of a
    training leaf is gathered before the layer runs, so it takes no part
    in the view."""
    m = cfg.moe
    lead = (cfg.n_layers - m.n_dense_layers,)
    w1 = leaf_spec("blocks/moe/w1", lead + (m.e_padded, cfg.d_model,
                                            m.d_expert),
                   mesh, fsdp=False, serve=not train)[1:]
    w2 = leaf_spec("blocks/moe/w2", lead + (m.e_padded, m.d_expert,
                                            cfg.d_model),
                   mesh, fsdp=False, serve=not train)[1:]
    tp = model_shards(mesh)
    if w1[0] != "model" or (w2[0], w2[1]) != (w1[0], w1[2]):
        _refuse(f"{m.e_padded} experts the model axis ({tp}) does not "
                f"divide (the rules' fall-back cuts each expert's hidden "
                f"over model)")
    if (m.d_expert * m.n_shared) % tp:
        _refuse(f"a shared expert of hidden {m.d_expert * m.n_shared} the "
                f"model axis ({tp}) does not divide")
    return dataclasses.replace(
        m, expert_shards=tp,
        hidden_shards=data_shards(mesh) if w1[2] == "data" else 1)


def spec_axes(spec: tuple) -> tuple:
    """The mesh axes that cut a leaf of spec ``spec``, in dim order."""
    out = []
    for entry in spec:
        if entry is not None:
            out.extend(entry if isinstance(entry, tuple) else (entry,))
    return tuple(out)


def data_dim(spec: tuple):
    """The dim of a leaf of spec ``spec`` that FSDP cuts over ``data``,
    or None."""
    return next((i for i, e in enumerate(spec) if e == "data"), None)


def shard_leaf(leaf, spec: tuple, mesh, coords: dict):
    """The rank's piece (at ``coords``, axis name -> index; a tuple entry
    is the axes' row-major index) of each cut dim of ``leaf``, a copy."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        idx = 0
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            idx = idx * mesh.shape[a] + coords[a]
        size = leaf.shape[dim] // _axis_size(mesh, entry)
        leaf = leaf.narrow(dim, idx * size, size)
    return leaf.clone()


def unshard_leaf(leaf, spec: tuple, mesh):
    """The whole leaf from the ranks' pieces (a collective: every rank of
    the mesh calls it, in the same order, and gets the whole leaf)."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for a in reversed(entry if isinstance(entry, tuple) else (entry,)):
            leaf = mesh.all_gather(leaf, a, dim)
    return leaf


def _with_specs(fn, tree: Any, specs: Any) -> Any:
    """``fn(leaf, spec)`` over a state tree (dicts, lists, ``optim.
    OptState``; adafactor's ``(row, col)`` moments) and its spec tree of
    the same structure, whose leaves are spec tuples."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _with_specs(fn, tree[k], specs[k]) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_with_specs(fn, v, sp)
                            for v, sp in zip(tree, specs)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_with_specs(fn, v, sp)
                          for v, sp in zip(tree, specs))
    return fn(tree, specs)


def spec_list(tree: Any, specs: Any) -> list:
    """The specs of ``tree``'s leaves in ``core.tree``'s leaf order."""
    out: list = []
    _with_specs(lambda t, sp: out.append(sp), tree, specs)
    return out


def shard_tree(tree: Any, specs: Any, mesh, coords: dict) -> Any:
    """One rank's pieces (:func:`shard_leaf`) of every leaf of the whole
    ``tree`` (params, or a train state ``{"params", "opt"}``), cut as the
    spec tree ``specs`` of the same structure says."""
    return _with_specs(lambda t, sp: shard_leaf(t, sp, mesh, coords), tree,
                       specs)


def unshard_params(tree: Any, specs: Any, mesh) -> Any:
    """A rank's tree (params, optimizer state, or both) gathered back to
    the whole tree, cut as ``specs`` said (:func:`unshard_leaf`; a
    collective, every rank gets the whole tree)."""
    return _with_specs(lambda t, sp: unshard_leaf(t, sp, mesh), tree, specs)


def rank_zeros(abstract: Any, specs: Any, mesh, device) -> Any:
    """Zeros of one rank's piece of every leaf of ``abstract`` (a whole
    tree of shapes: the meta device's), in its dtype, on ``device``: a
    fresh optimizer state cut as ``specs`` without the whole state."""
    return _with_specs(
        lambda t, sp: torch.zeros(
            [n // _axis_size(mesh, e) for n, e in zip(t.shape, sp)],
            dtype=t.dtype, device=device), abstract, specs)


def _opt_spec_like(opt_abs: Any, p_spec: Any) -> Any:
    """The optimizer state's specs (the reference's ``launch.steps.
    _opt_spec_like``): a moment inherits its param's spec (ZeRO-1: cut
    as the param is); adafactor's factored (row, col) moments take the
    matching prefix (the row means drop the last dim, the column means
    the one before it); the step counter is replicated.  ``opt_abs`` is
    an ``optim.OptState`` whose moments are laid out as the params,
    ``p_spec`` the params' spec tree."""
    def like(sub, spec):
        if isinstance(sub, tuple):          # adafactor (row, col)
            return (spec[:-1], spec[:-2] + spec[-1:])
        return spec

    def walk(field, spec):
        if isinstance(field, dict):
            return {k: walk(v, spec[k]) for k, v in field.items()}
        if isinstance(field, list):
            return [walk(v, sp) for v, sp in zip(field, spec)]
        return like(field, spec)

    return type(opt_abs)(
        step=(), m=None if opt_abs.m is None else walk(opt_abs.m, p_spec),
        v=None if opt_abs.v is None else walk(opt_abs.v, p_spec))


def shard_params(params: Any, mesh, coords: dict, *, cfg=None,
                 fsdp: bool = False, serve: bool = True) -> Any:
    """One rank's leaves of the full tree ``params`` (:func:`shard_tree`),
    each leaf cut as ``param_sharding_rules(params, mesh, fsdp=fsdp,
    serve=serve)`` says: by default serving's rules without FSDP;
    training (``launch.train.train_rank``) passes ``serve=False`` and its
    ``fsdp``.  Int8 weight codes
    cut as their float counterparts do."""
    return shard_tree(params, param_sharding_rules(
        params, mesh, fsdp=fsdp, serve=serve, cfg=cfg), mesh, coords)
