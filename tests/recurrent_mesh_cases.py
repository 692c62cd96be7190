"""The recurrent (rwkv6-3b, zamba2-2.7b) and audio (whisper-large-v3)
families' serving cases, run on every rank of a spawned mesh and, for
comparison, in one process: the one case runner of
``tests/test_torch_recurrent_mesh.py``, ``tests/test_torch_audio_mesh.py``
and ``chip_smoke.py``'s phase 31.

Each spawned rank imports this module, ``moe_mesh_cases``, ``tp_cases``
and ``repro_torch`` only.  A case is a dict:

* ``{"kind": "serve", "arch": ..., **serve keywords}``: classic
  ``launch.serve.serve`` (``graphs=False``), as ``moe_mesh_cases``' serve
  cases (every step's logits, the whole batch's; ``split_sums`` M in a
  one-process case takes every row-cut FP sum in a (1, M) mesh's order);
* ``{"kind": "engine", "arch": ..., **serve_engine keywords}``:
  ``launch.serve.serve_engine`` (``graphs=False``) on the fixed-slab
  substrate, watched from outside (``tp_cases.watched_engines``): every
  request's tokens, its first step's logits, each step's admissions, the
  recorded decisions (under ``record``) and the report;
* ``{"kind": "preempt", "arch": ..., "prompt": ..., "params": the whole
  params, "engine": ServingEngine keywords, "cfg_overrides": ...}``: one
  request of 10 tokens served alone on a ``ServingEngine`` of the rank's
  slices, preempted once after its 4th decoded token (the pure recurrent
  substrate's snapshot: the slab to the host and back at readmission):
  its tokens and the slab pool's evictions.

``model_axis`` in a case runs it on the (world / model_axis, model_axis)
mesh over the same ranks (:func:`run_cases`); ``mesh_order`` M in a
one-process case takes every FP module's product as a (1, M) mesh's rank
does (:func:`mesh_order`).  ``xla_attention`` True (the
CPU tests only; it imports JAX) runs the case with the reference's
attention in the port's plain K5 / K6 versions
(``tests/test_torch_whisper.py::reference_attention``), which the
audio family's INT tokens need to be the JAX package's.
"""
import contextlib
import time

import numpy as np
import torch

from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import make_local_mesh

try:                                    # as the tests import it
    from tests import moe_mesh_cases, tp_cases
except ImportError:                     # chip_smoke.py: tests/ on the path
    import moe_mesh_cases
    import tp_cases


@contextlib.contextmanager
def _xla_attention(on: bool):
    if not on:
        yield
        return
    from repro_torch.kernels import ref as tref
    from tests import test_torch_whisper as tw
    base = tref.flash_attention_ref, tref.flash_decode_ref
    tref.flash_attention_ref = tw._xla_flash_attention
    tref.flash_decode_ref = tw._xla_flash_decode
    try:
        yield
    finally:
        tref.flash_attention_ref, tref.flash_decode_ref = base


@contextlib.contextmanager
def mesh_order(m: int):
    """Inside this block every FP module takes its product as the ranks
    of a (1, m) mesh take theirs: a row-cut one's fp32 partials summed
    in rank order (``moe_mesh_cases.split_sums``), and a column-cut one
    (``qlinear`` / ``qlinears`` without ``reduce``: the attention's q, k,
    v, the MLPs' w1 / w3, the recurrent blocks' gathered outputs, the
    head) as m products of its blocks of columns, each over the whole
    input as a rank's is, concatenated.  A bf16 product's rounding may
    depend on its width (the library picks its algorithm by shape), so
    one process gives the mesh's bf16 values only so."""
    from repro_torch.core.qmodel import QuantMode
    from repro_torch.models import common as tcommon

    def blocks(w, b):
        n = w.shape[-1] // m
        return [(w[..., i * n:(i + 1) * n].contiguous(),
                 None if b is None else b[i * n:(i + 1) * n])
                for i in range(m)]

    with moe_mesh_cases.split_sums(m):
        row_cut, base_many = tcommon.qlinear, tcommon.qlinears

        def one(ctx, name, x, w, b=None, *, reduce=False, **cut):
            if reduce or ctx.mode is not QuantMode.FP:
                return row_cut(ctx, name, x, w, b, reduce=reduce, **cut)
            return torch.cat([row_cut(ctx, name, x, wi, bi)
                              for wi, bi in blocks(w, b)], dim=-1)

        def many(ctx, names, x, ws, bs=None):
            if ctx.mode is not QuantMode.FP:
                return base_many(ctx, names, x, ws, bs)
            bs = [None] * len(names) if bs is None else bs
            return [one(ctx, n, x, w, b) for n, w, b in zip(names, ws, bs)]

        tcommon.qlinear, tcommon.qlinears = one, many
        try:
            yield
        finally:
            tcommon.qlinear, tcommon.qlinears = row_cut, base_many


def _engine(case: dict, mesh, device) -> dict:
    kw = {k: v for k, v in case.items()
          if k not in ("kind", "arch", "model_axis", "xla_attention")}
    where = dict(mesh=mesh) if mesh is not None else dict(device=device)
    with tp_cases.watched_engines() as built:
        out = tserve.serve_engine(case["arch"], graphs=False, **kw, **where)
    eng = built[-1]
    return {"outputs": out["outputs"], "logits": [eng.first_logits.float()],
            "steps": eng.steps, "report": out["report"],
            "decisions": (out["record"].decisions
                          if out["record"] is not None else None),
            "launches": out["launches"],
            "table": {k: tuple(vars(v).values())
                      for k, v in out["ctx"].table.items()}}


def _preempt(case: dict, mesh, device) -> dict:
    from repro_torch.core.qmodel import QuantContext
    from repro_torch.distributed import sharding as shd
    from repro_torch.serving import engine as tengine
    from repro_torch.serving.scheduler import Request, RequestState
    cfg = moe_mesh_cases.config(case)
    params = case["params"]
    if mesh is not None:
        params = shd.shard_params(params, mesh, mesh.coords, cfg=cfg)
    eng = tengine.ServingEngine(
        cfg, params, QuantContext(), graphs=False, mesh=mesh,
        device=mesh.device if mesh is not None else device,
        **case["engine"])
    req = Request(rid=0, prompt=case["prompt"], max_new_tokens=10)
    eng.submit(req)
    preempted = False
    with torch.no_grad():
        while not eng.sched.idle:
            if (not preempted and req.state is RequestState.DECODE
                    and len(req.generated) >= 4):
                eng.sched.preempt(req, eng._now())
                preempted = req.snapshot is not None
            eng.step()
    return {"tokens": np.asarray(eng.outputs()[0]), "preempted": preempted,
            "evictions": eng.state_pool.stats.seq_evictions}


def run(case: dict, mesh=None, device=None) -> dict:
    """One case, on a rank (``mesh``) or in this process (``device``),
    with its wall time (synchronized) and, on the card, the process's
    peak memory over the case (GiB)."""
    order = (mesh_order(case["mesh_order"]) if "mesh_order" in case
             else contextlib.nullcontext())
    with _xla_attention(case.get("xla_attention", False)), order:
        if case["kind"] == "serve":
            return moe_mesh_cases.run(
                {k: v for k, v in case.items()
                 if k not in ("xla_attention", "mesh_order")},
                mesh, device)
        dev = mesh.device if mesh is not None else torch.device(device)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = (_engine if case["kind"] == "engine" else _preempt)(
            case, mesh, device)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
            torch.cuda.empty_cache()
        res["wall_s"] = time.perf_counter() - t0
        return res


def run_cases(mesh, cases: list) -> list:
    """The rank worker: every case on this rank, in order (the ranks'
    collectives meet in that order); a case with ``model_axis`` runs on
    the (world / model_axis, model_axis) mesh over the same ranks."""
    meshes = {mesh.shape["model"]: mesh}
    out = []
    for c in cases:
        m = c.get("model_axis", mesh.shape["model"])
        if m not in meshes:
            meshes[m] = make_local_mesh(m, device=mesh.device.type,
                                        backend=mesh.backend)
        out.append(run(c, meshes[m]))
    return out


def same_tokens(a: dict, b: dict) -> bool:
    """Two runs' tokens (classic) or every request's tokens (engine)."""
    if "tokens" in a:
        return np.array_equal(a["tokens"], b["tokens"])
    return a["outputs"].keys() == b["outputs"].keys() and all(
        np.array_equal(a["outputs"][r], b["outputs"][r])
        for r in a["outputs"])
