"""Training cases run on every rank of a spawned mesh and, for comparison,
in one process: the case runner of ``tests/test_torch_train_mesh.py`` and
of ``chip_smoke.py``'s phase 28.

Each spawned rank imports this module and ``repro_torch`` only.  A case
is a dict with a ``kind``:

* ``"train"``: ``steps`` steps of ``launch.steps.jit_train_step`` (on a
  mesh; ``build_train_step`` on one process) from the whole params
  ``params`` (default the seeded ones, built on the device or on
  ``init_device``: a device's generator draws its own numbers) and a fresh
  optimizer state, the global batches of :func:`stream` through the
  mesh's ``ShardedLoader``; returns each step's metrics, the launches,
  and (unless ``keep`` is False; ``"rank 0"``: on rank 0 alone) the whole
  moments and (unless ``params_back`` is False) params after step
  ``keep_after`` (default the last; gathered); with ``timed_step`` one more step on the mesh, each
  collective timed (``timed_step``: calls, bytes, seconds, the step's);
* ``"grads"``: ``launch.steps.loss_and_grads`` of one global batch on the
  mesh's scope (FSDP's leaves gathered), meaned over the data axis as
  the train step means them; returns the loss, the metrics and the whole
  gradients;
* ``"resume"``: ``launch.train.train`` (the smoke config) from the
  checkpoints in ``ckpt_dir`` (the latest committed, after the commit at
  step ``drop`` is removed), to ``steps``; returns its losses;
* ``"restored"``: the whole state of the checkpoint at ``step`` in
  ``ckpt_dir``, restored as the rank's pieces and gathered back.

A case names its config as ``arch`` plus ``cfg`` overrides (the dtype
among them; a dict for a sub-config's fields), its optimizer ``opt``
('adamw' or 'adafactor'), ``accum``, ``fsdp``, ``remat`` and ``mode``;
the weights' ``seed`` (default 0) and the stream's ``data_seed``
(default ``SEED``), ``batch`` and ``seq``; the rate's ``warmup`` steps
(default 1: the first step at rate 0) and peak ``lr`` (3e-3); in
:func:`run_cases`, the mesh's ``model_axis`` (default the spawned
mesh's).  A train case keeps
the rank's seconds a step (``step_s``).  The audio family's batches
carry their stub frames (:func:`stream`).
"""
import contextlib
import dataclasses
import os
import shutil
import time

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.qmodel import QuantContext, QuantMode
from repro_torch.core.tree import leaves, tree_map
from repro_torch.data import ShardedLoader, SyntheticLMStream
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops
from repro_torch.launch import steps as S
from repro_torch.launch import train as T
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import model as M
from repro_torch.optim import adafactor, adamw, warmup_cosine

BATCH, SEQ, SEED = 4, 32, 3
OPTS = {"adamw": adamw, "adafactor": adafactor}


def replaced(cfg, over: dict):
    """``cfg`` with the overrides ``over``; a dict given for a field that
    holds a config (``moe``, ``encdec``) overrides that config's fields
    (either package's configs)."""
    return dataclasses.replace(cfg, **{
        k: replaced(getattr(cfg, k), v) if isinstance(v, dict) else v
        for k, v in over.items()})


def config(case: dict):
    """The case's config: ``arch``'s smoke one (``smoke`` False: its
    published one) with ``cfg`` overrides (:func:`replaced`)."""
    base = (get_smoke_config if case.get("smoke", True) else get_config)(
        case.get("arch", "llama3_2_1b"))
    return replaced(base, case.get("cfg", {}))


def stream(cfg, case: dict) -> SyntheticLMStream:
    """The case's stream (the audio family's with its stub frames)."""
    audio = cfg.family == "audio"
    return SyntheticLMStream(
        cfg.vocab_size, case.get("seq", SEQ), case.get("batch", BATCH),
        seed=case.get("data_seed", SEED),
        encoder_seq=cfg.encdec.encoder_seq if audio else None,
        d_model=cfg.d_model if audio else None)


def lr_fn(warmup=1, peak=3e-3):
    return warmup_cosine(peak, warmup, 10)


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _host(tree) -> list:
    return [t.detach().to("cpu", copy=True) for t in leaves(tree)]


def _metrics(m: dict) -> dict:
    return {k: float(v) for k, v in m.items()}


def _to(tree, dev):
    """A copy of ``tree`` on ``dev`` (the caller's tensors stay as they
    are: the train step updates its params in place)."""
    return tree_map(lambda t: t.to(dev, copy=True), tree)


@contextlib.contextmanager
def _timed_collectives(mesh, dev):
    """Within the block, each of ``mesh``'s collectives counted with its
    bytes (the tensor it is given) and its host seconds, the device
    synchronized before and after (so the work queued before it is not
    counted; a rank waiting for the other's work is)."""
    stats = {"calls": 0, "bytes": 0, "seconds": 0.0}
    names = ("all_reduce", "all_gather")
    originals = {n: getattr(mesh, n) for n in names}

    def timed(fn):
        def call(t, *args, **kwargs):
            _sync(dev)
            t0 = time.perf_counter()
            out = fn(t, *args, **kwargs)
            _sync(dev)
            stats["seconds"] += time.perf_counter() - t0
            stats["calls"] += 1
            stats["bytes"] += t.numel() * t.element_size()
            return out
        return call

    for n in names:
        setattr(mesh, n, timed(originals[n]))
    try:
        yield stats
    finally:
        for n in names:
            delattr(mesh, n)


def train_case(mesh, case: dict, device="cpu") -> dict:
    cfg = config(case)
    ctx = QuantContext(mode=QuantMode(case.get("mode", "fp")))
    opt = OPTS[case.get("opt", "adamw")]()
    accum, warmup = case.get("accum", 1), case.get("warmup", 1)
    peak = case.get("lr", 3e-3)
    dev = device if mesh is None else mesh.device
    params = case.get("params")
    if params is None:      # the seeded weights, built on the device
        params = M.init_params(cfg, case.get("seed", 0),
                               device=case.get("init_device", dev))
    if mesh is None:
        step = S.build_train_step(cfg, ctx, opt, lr_fn(warmup, peak),
                                  remat=False, accum_steps=accum)
        params = _to(params, dev)
        state = opt.init(params)
        loader = ShardedLoader(stream(cfg, case), dev)
    else:
        step, (_, o_abs, p_spec, o_spec) = S.jit_train_step(
            cfg, ctx, mesh, opt, lr_fn(warmup, peak),
            remat=case.get("remat", False),
            fsdp=case.get("fsdp", False), accum_steps=accum)
        params = _to(shd.shard_params(params, mesh, mesh.coords, cfg=cfg,
                                      fsdp=case.get("fsdp", False),
                                      serve=False), dev)
        state = shd.rank_zeros(o_abs, o_spec, mesh, dev)
        loader = ShardedLoader(stream(cfg, case), mesh=mesh, accum=accum)
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    out = {"metrics": [], "step_s": []}
    steps, keep = case.get("steps", 3), case.get("keep", True)

    def kept(params, state):
        """The whole moments (and params) as they are now, into ``out``
        (on a mesh a collective: every rank calls it)."""
        if mesh is not None:
            params = shd.unshard_params(params, p_spec, mesh)
            state = shd.unshard_params(state, o_spec, mesh)
            if keep == "rank 0" and mesh.rank:
                return
        if case.get("params_back", True):
            out["params"] = _host(params)
        out["moments"] = {k: _host(getattr(state, k)) for k in ("m", "v")}

    try:
        for i in range(steps):
            _, b = next(loader)
            t0 = time.perf_counter()
            params, state, m = step(params, state, b)
            _sync(dev)
            out["step_s"].append(time.perf_counter() - t0)
            out["metrics"].append(_metrics(m))
            if keep and i + 1 == case.get("keep_after", steps):
                kept(params, state)
        out["launches"] = {**ops.LAUNCHES, **ops.FORM_LAUNCHES}
        if mesh is not None and case.get("timed_step"):
            # one more step, each collective timed apart
            _, b = next(loader)
            with _timed_collectives(mesh, dev) as stats:
                t0 = time.perf_counter()
                params, state, m = step(params, state, b)
                _sync(dev)
            out["timed_step"] = dict(stats, step_s=time.perf_counter() - t0,
                                     metrics=_metrics(m))
    finally:
        loader.close()
    if torch.device(dev).type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    if mesh is not None:
        out["fsdp_leaves"] = sum(1 for sp in shd.spec_list(params, p_spec)
                                 if "data" in shd.spec_axes(sp))
    return out


def grads_case(mesh, case: dict, device="cpu") -> dict:
    cfg = config(case)
    ctx = QuantContext(mode=QuantMode(case.get("mode", "fp")))
    batch = {k: torch.from_numpy(v) for k, v in
             stream(cfg, case).batch(0).items()}
    params = case["params"]
    if mesh is None:
        loss, m, g = S.loss_and_grads(params, batch, cfg, ctx)
        return {"loss": loss, "metrics": _metrics(m), "grads": g}
    p_spec = shd.param_sharding_rules(S.abstract_params(cfg), mesh,
                                      fsdp=case.get("fsdp", False), cfg=cfg)
    rank = shd.shard_params(params, mesh, mesh.coords, cfg=cfg,
                            fsdp=case.get("fsdp", False), serve=False)
    per = batch["tokens"].shape[0] // mesh.shape["data"]
    d = mesh.coords["data"]
    batch = {k: v[d * per:(d + 1) * per] for k, v in batch.items()}
    specs = shd.spec_list(rank, p_spec)
    with shd.activation_sharding(mesh, batch_split=True, train=True):
        loss, m, g = S.loss_and_grads(
            rank, batch, cfg, ctx, mesh=mesh,
            fsdp_dims=[shd.data_dim(sp) for sp in specs])
    S.mean_over_data(g, specs, mesh)
    whole = [shd.unshard_leaf(t, sp, mesh) for t, sp in zip(g, specs)]
    return {"loss": loss, "metrics": _metrics(m), "grads": whole}


def resume_case(mesh, case: dict, device="cpu") -> dict:
    if "drop" in case:      # the commit at step ``drop`` removed first
        if mesh is None or mesh.rank == 0:
            shutil.rmtree(os.path.join(case["ckpt_dir"],
                                       f"step_{case['drop']:09d}"))
        if mesh is not None:
            mesh.barrier()
    o = T.train(case.get("arch", "llama3_2_1b"), case["steps"],
                batch=case.get("batch", BATCH), seq=case.get("seq", SEQ),
                ckpt_dir=case["ckpt_dir"],
                ckpt_every=case.get("ckpt_every", 50), log_every=100,
                seed=case.get("seed", 0), mesh=mesh, device=device)
    return {"losses": o["losses"]}


def restored_case(mesh, case: dict, device="cpu") -> dict:
    cfg = config(case)
    opt = S.pick_optimizer(cfg)
    template = {"params": S.abstract_params(cfg),
                "opt": S.abstract_opt_state(cfg, opt)}
    ck = Checkpointer(case["ckpt_dir"])
    if mesh is None:
        state, extra = ck.restore(template, case.get("step"))
        return {"state": _host(state), "extra": extra}
    _, (_, _, p_spec, o_spec) = S.jit_train_step(
        cfg, QuantContext(), mesh, opt, lr_fn(), remat=False, fsdp=False)
    specs = {"params": p_spec, "opt": o_spec}
    state, extra = ck.restore(template, case.get("step"), mesh=mesh,
                              specs=specs)
    return {"state": _host(shd.unshard_params(state, specs, mesh)),
            "extra": extra}


def psum_case(mesh, per_rank: list, axis: str, bf16=()) -> dict:
    """``optim.compression.compressed_psum`` over ``axis`` of this rank's
    gradients, ``per_rank[rank]`` (numpy; the ``bf16`` leaves cast)."""
    from repro_torch.optim.compression import compressed_psum
    grads = {k: torch.from_numpy(v.copy()).to(
        torch.bfloat16 if k in bf16 else torch.float32)
        for k, v in per_rank[mesh.rank].items()}
    return compressed_psum(grads, axis, mesh=mesh)


KINDS = {"train": train_case, "grads": grads_case, "resume": resume_case,
         "restored": restored_case}


def run(case: dict, mesh=None, device="cpu") -> dict:
    """One case (the seeded weights built anew for each: a rank keeps no
    whole copy of them while it trains its pieces)."""
    t0 = time.perf_counter()
    out = KINDS[case["kind"]](mesh, case, device)
    out["wall_s"] = time.perf_counter() - t0
    return out


def run_cases(mesh, cases: list) -> list:
    """Every case on this rank, in order (the ranks' collectives meet in
    that order); a case with ``model_axis`` runs on the (world /
    model_axis, model_axis) mesh over the same ranks."""
    meshes = {mesh.shape["model"]: mesh}
    out = []
    for c in cases:
        m = c.get("model_axis", mesh.shape["model"])
        if m not in meshes:
            meshes[m] = make_local_mesh(m, device=mesh.device.type,
                                        backend=mesh.backend)
        out.append(run(c, meshes[m]))
    return out
