"""MoE cases run on every rank of a spawned mesh and, for comparison, in
one process: the one case runner of ``tests/test_torch_moe_mesh.py`` and
of ``chip_smoke.py``'s phase 29.

Each spawned rank imports this module and ``repro_torch`` only.  A case
is a dict:

* ``{"kind": "serve", "arch": ..., **serve keywords}``: classic
  ``launch.serve.serve`` (``graphs=False``), every step's logits kept on
  the host (the prefill's last position, then each decode step's, the
  whole batch's: a data-cut mesh's rows gathered in data order), the
  tokens, the launches, the calibrated table, the decode seconds a
  token, the wall time and, on the card, the peak memory of the process;
* ``{"kind": "layer", "arch": ..., "mode": ..., "p": the MoE layer's
  whole params, "x": the whole (B, S, d) input, "cfg_overrides": ...}``:
  ``models.mlp.moe`` alone, on a rank its slices of ``p`` (serving's
  rules) and its data block of ``x`` under the mesh's batch-splitting
  scope, the output gathered whole; in one process ``data_shards`` (the
  per-shard dispatch's one-process form).

``model_axis`` in a case runs it on the (world / model_axis,
model_axis) mesh over the same ranks (:func:`run_cases`); ``split_sums``
M in a one-process case takes every row-cut module's FP product as a (1,
M) mesh takes it (:func:`split_sums`); ``routes`` True in a serve case
keeps every router call's choices (:func:`route_choices`).
"""
import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.qmodel import QuantContext, QuantMode
from repro_torch.distributed import sharding as shd
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import common as tcommon
from repro_torch.models import mlp as tmlp
from repro_torch.models import model as TM


def config(case: dict):
    """The case's config: the arch's smoke config (``smoke``, default
    True) or its full one, with ``cfg_overrides``."""
    get = get_smoke_config if case.get("smoke", True) else get_config
    return dataclasses.replace(get(case["arch"]),
                               **case.get("cfg_overrides", {}))


@contextlib.contextmanager
def step_logits(into: list):
    """Every ``models.model.decode_step`` called inside this block appends
    its logits (on the host, a copy) to ``into``."""
    base = TM.decode_step

    def watched(*args, **kwargs):
        logits, cache = base(*args, **kwargs)
        into.append(logits.detach().to("cpu", copy=True))
        return logits, cache

    TM.decode_step = watched
    try:
        yield
    finally:
        TM.decode_step = base


@contextlib.contextmanager
def route_choices(into: list):
    """Every ``models.mlp.route`` called inside this block appends, on
    the host, its (T, k) experts and each token's margin between its k-th
    and (k+1)-th probabilities, relative to the k-th (how near the token's
    last choice is to a tie); the routing itself is unchanged."""
    base = tmlp.route

    def watched(xt, router, top_k):
        top_p, top_e = base(xt, router, top_k + 1)
        margin = (top_p[:, top_k - 1] - top_p[:, top_k]) / top_p[:, top_k - 1]
        into.append((top_e[:, :top_k].cpu(), margin.cpu()))
        return base(xt, router, top_k)

    tmlp.route = watched
    try:
        yield
    finally:
        tmlp.route = base


@contextlib.contextmanager
def split_sums(m: int):
    """Inside this block every FP row-cut module (``qlinear(...,
    reduce=True)``: attention's and MLA's ``wo``, a dense MLP's and a
    shared expert's ``w2``, RWKV6's time-mix projections and channel-mix
    ``wv``, mamba2's ``w_in``) takes its product as a (1, m) mesh does
    (``core.qmodel._fp_linear`` over the model axis): the m blocks of K's
    fp32 products summed in rank order, rounded once, then the bias.  One
    process then gives the mesh's summation order, which a bf16 model's
    tokens may follow where one rank's do not."""
    base = tcommon.qlinear

    def row_cut(ctx, name, x, w, b=None, *, reduce=False, **cut):
        if not reduce or ctx.mode is not QuantMode.FP:
            return base(ctx, name, x, w, b, reduce=reduce, **cut)
        k = w.shape[0] // m
        f32 = torch.float32
        acc = None
        for i in range(m):
            part = torch.matmul(x[..., i * k:(i + 1) * k].to(f32),
                                w[i * k:(i + 1) * k].to(f32))
            acc = part if acc is None else acc + part
        y = acc.to(x.dtype)
        return y if b is None else y + b.to(x.dtype)

    tcommon.qlinear = row_cut
    try:
        yield
    finally:
        tcommon.qlinear = base


def _gathered(mesh, rows: list) -> list:
    """Each entry's whole batch: on a data-cut mesh every data rank's rows
    (model rank 0 of each), in data order."""
    if mesh is None or mesh.shape["data"] == 1:
        return rows
    got = mesh.gather_objects(rows)
    m = mesh.shape["model"]
    return [torch.cat([got[r][i] for r in range(0, mesh.size, m)])
            for i in range(len(rows))]


def _serve(case: dict, mesh, device) -> dict:
    kw = {k: v for k, v in case.items()
          if k not in ("kind", "arch", "model_axis", "split_sums", "routes")}
    where = dict(mesh=mesh) if mesh is not None else dict(device=device)
    decode: list = []
    routes: list = []
    order = split_sums(case["split_sums"]) if "split_sums" in case \
        else contextlib.nullcontext()
    watch = route_choices(routes) if case.get("routes") \
        else contextlib.nullcontext()
    with step_logits(decode), order, watch:
        out = tserve.serve(case["arch"], graphs=False, **kw, **where)
    split = mesh is not None and mesh.shape["data"] > 1
    return {"tokens": np.asarray(out["tokens"]), "routes": routes,
            "logits": [out["logits"].float()]
            + [t.float() for t in _gathered(mesh if split else None,
                                            decode)],
            "launches": out["launches"],
            "decode_s_per_tok": out["decode_s_per_tok"],
            "prefill_s": out["prefill_s"], "calibrate_s": out["calibrate_s"],
            "table": {k: tuple(vars(v).values())
                      for k, v in out["ctx"].table.items()}}


def layer_ctx(case: dict) -> QuantContext:
    return QuantContext(mode=QuantMode(case["mode"]))


def _layer(case: dict, mesh, device) -> dict:
    cfg = config(case)
    ctx = layer_ctx(case)
    dev = torch.device(device) if mesh is None else mesh.device
    p, x = case["p"], case["x"]
    from repro_torch.kernels import ops as kops
    start = {**kops.LAUNCHES, **kops.FORM_LAUNCHES}
    with torch.no_grad():
        if mesh is None:
            out = tmlp.moe(ctx, {k: _to(v, dev) for k, v in p.items()},
                           x.to(dev), cfg,
                           data_shards=case.get("data_shards", 1)).cpu()
        else:
            rank_p = shd.shard_params({"blocks": [{"moe": p}]}, mesh,
                                      mesh.coords, cfg=cfg)
            rank_p = {k: _to(v, dev)
                      for k, v in rank_p["blocks"][0]["moe"].items()}
            d = mesh.shape["data"]
            rows = x.shape[0] // d
            x_l = x[mesh.coords["data"] * rows:(mesh.coords["data"] + 1)
                    * rows].to(dev)
            with shd.activation_sharding(mesh, batch_split=d > 1):
                out = tmlp.moe(ctx, rank_p, x_l,
                               shd.local_config(cfg, mesh)).cpu()
            out = _gathered(mesh, [out])[0]
    launches = {k: n - start[k]
                for k, n in {**kops.LAUNCHES, **kops.FORM_LAUNCHES}.items()}
    return {"out": out, "launches": launches}


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def run(case: dict, mesh=None, device=None) -> dict:
    """One case, on a rank (``mesh``) or in this process (``device``),
    with its wall time (synchronized) and, on the card, the process's
    peak memory over the case (GiB)."""
    dev = mesh.device if mesh is not None else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = (_serve if case["kind"] == "serve" else _layer)(case, mesh,
                                                          device)
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
