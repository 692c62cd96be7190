"""The dry run: every (architecture x shape) cell traced for one rank of
the production mesh, and its roofline inputs (PyTorch counterpart of
``repro.launch.dryrun``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch \\
        qwen3-1.7b --shape train_4k [--multi-pod] [--mode int] \\
        [--json out.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \\
        [--jobs 3]

Where the reference lowers and compiles each cell's SPMD program on 512
host devices, the port builds rank 0's step on a ``launch.mesh.
CountingMesh`` of the layout (its collectives recorded, not made), cuts
the whole abstract trees to that rank (``distributed.sharding.
shard_tree``, on the meta device: nothing is allocated) and runs the step
once on them under ``launch.analysis.CostMode``: each kernel charged by
its own reckoning (``kernels.cost``), every other aten op by its
operands.  A train cell runs ``default_accum_steps`` microsteps and the
update.  The port's layers are Python loops the trace walks in full, so
there is no rolled loop to unroll (the reference's ``scan_lib``) and no
depth fit.  Attention traces through the port's kernels
(``attn_kernel='flash'``, the path it serves on the card).

A cell the port refuses at build time (a model axis that does not divide
the KV heads, ROADMAP Queue 1 item 8) is reported FAILED with the
refusal's words, as the reference reports a cell that fails to compile;
``main`` exits 1 when any cell fails.  ``--jobs N`` traces the cells in
N worker processes, the train cells first (deepseek-v3's, 16 microsteps
of 61 layers, is the longest trace by far).  Nothing runs at import.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config, supported_shapes
from repro_torch.configs.base import SHAPES, ModelConfig
from repro_torch.core.qmodel import QuantContext, QuantMode
from repro_torch.core.tree import leaves
from repro_torch.distributed import sharding as shd
from repro_torch.launch import analysis as A
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import CountingMesh, make_production_mesh
from repro_torch.optim.schedule import warmup_cosine

__all__ = ["model_flops", "rank_step", "lower_cell", "analyze",
           "run_cell", "main", "tree_bytes"]


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference), D = tokens;
    N_active for MoE.  Decode: D = batch (one token each)."""
    n = S.param_count(cfg)
    if cfg.moe is not None:
        m = cfg.moe
        active_expert = (m.top_k + m.n_shared) * 3 * cfg.d_model * m.d_expert
        all_expert = (m.n_experts + m.n_shared) * 3 * cfg.d_model * m.d_expert
        n_moe_layers = cfg.n_layers - m.n_dense_layers
        n = n - (all_expert - active_expert) * n_moe_layers
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6 if shape.kind == "train" else 2
    return mult * n * tokens


def tree_bytes(tree) -> int:
    """The bytes of every tensor in ``tree``."""
    return sum(t.numel() * t.element_size() for t in leaves(tree)
               if isinstance(t, torch.Tensor))


def rank_step(arch: str, shape_name: str, mesh, mode: str = "fp",
              fsdp: bool | None = None, remat: bool = True,
              accum_steps: int | None = None,
              cfg: ModelConfig | None = None, *, device: str = "meta"):
    """Rank 0's step of one cell on ``mesh`` (a layout: ``launch.mesh.
    make_production_mesh``) and its arguments: ``(step, args, meta)``,
    ``step`` built on a ``CountingMesh`` of the layout, ``args`` the
    rank's trees (params, optimizer state and batch; or params, tokens,
    cache and the position ``seq_len - 1``): on the meta device the whole
    abstract trees cut by ``shard_tree``, elsewhere (``device="cuda"``)
    zeros of the rank's pieces made there (``rank_zeros``).  ``meta``: the
    resolved config and shape, ``accum_steps``, the rank's mesh.

    ``cfg`` overrides the registry config.  ``fsdp=None`` = auto: always
    on for train; for serve when the weights cannot replicate across the
    data axis (``steps.serve_needs_fsdp``), which the port refuses
    (Queue 1 item 8).  Every build-time refusal raises here."""
    cfg = dataclasses.replace(cfg if cfg is not None else get_config(arch),
                              attn_kernel="flash")
    shape = SHAPES[shape_name]
    ctx = QuantContext(mode=QuantMode(mode))
    if fsdp is None:
        fsdp = True if shape.kind == "train" else \
            S.serve_needs_fsdp(cfg, mesh,
                               bytes_per_param=1 if mode == "int" else 2)
    rank = CountingMesh(mesh.shape["data"], mesh.shape["model"],
                        torch.device(device))

    def cut(tree, specs):
        if device == "meta":
            return shd.shard_tree(tree, specs, rank, rank.coords)
        return shd.rank_zeros(tree, specs, rank, device)

    if shape.kind == "train":
        opt = S.pick_optimizer(cfg)
        if accum_steps is None:
            accum_steps = S.default_accum_steps(cfg, shape, mesh)
        step, (params_abs, opt_abs, p_spec, o_spec) = S.jit_train_step(
            cfg, ctx, rank, opt, warmup_cosine(3e-4, 100, 10_000),
            remat=remat, fsdp=fsdp, accum_steps=accum_steps)
        batch = S.input_specs(cfg, shape)["batch"]
        args = (cut(params_abs, p_spec), cut(opt_abs, o_spec),
                cut(batch, S.batch_specs_tree(batch, rank)))
    elif shape.kind == "prefill":
        step, (params_abs, batch, p_spec) = S.jit_prefill_step(
            cfg, ctx, rank, shape, fsdp=fsdp)
        args = (cut(params_abs, p_spec),
                cut(batch, S.batch_specs_tree(batch, rank)))
    else:
        step, (params_abs, cache_abs, p_spec, c_spec) = S.jit_serve_step(
            cfg, ctx, rank, shape, fsdp=fsdp)
        d = shd.data_shards(rank)
        b = shape.global_batch
        b = b // d if b % d == 0 else b
        args = (cut(params_abs, p_spec),
                torch.zeros((b, 1), dtype=torch.int32, device=device),
                cut(cache_abs, c_spec),
                torch.full((), shape.seq_len - 1, dtype=torch.int32,
                           device=device))
    return step, args, {"cfg": cfg, "shape": shape,
                        "accum_steps": accum_steps, "rank_mesh": rank}


def lower_cell(arch: str, shape_name: str, mesh, mode: str = "fp",
               fsdp: bool | None = None, remat: bool = True,
               accum_steps: int | None = None,
               cfg: ModelConfig | None = None):
    """Trace one cell: :func:`rank_step`'s step run once on its meta
    arguments under ``analysis.CostMode``.  Returns ``(args, traced, meta)``: the
    rank's arguments, the trace (``CostMode``, with ``arg_bytes``, the
    arguments' bytes) and the cell's facts (with ``lower_compile_s``, the
    seconds to build and trace)."""
    t0 = time.time()
    step, args, meta = rank_step(arch, shape_name, mesh, mode, fsdp, remat,
                                 accum_steps, cfg)
    grad = contextlib.nullcontext() if meta["shape"].kind == "train" \
        else torch.no_grad()
    with grad:
        with A.CostMode() as traced:
            step(*args)
    traced.arg_bytes = tree_bytes(args)
    meta["lower_compile_s"] = time.time() - t0
    return args, traced, meta


def analyze(traced, cfg, shape, mesh) -> dict:
    """The reference's record of one cell, from its trace: per-rank FLOPs,
    bytes and collective traffic, the three roofline terms, the model's
    FLOPs, the peak live bytes of the step's own tensors and the rank's
    argument bytes."""
    sample = traced.sample()
    terms = A.roofline_terms(sample)
    mf = model_flops(cfg, shape)
    n_dev = mesh.size
    return {
        "arch": cfg.name, "shape": shape.name, "devices": n_dev,
        "hlo_flops_per_device": sample.flops,
        "hlo_bytes_per_device": sample.bytes_hbm,
        "collective_bytes_per_device": sample.collectives,
        **terms,
        "model_flops_global": mf,
        "useful_flops_ratio": mf / (sample.flops * n_dev)
        if sample.flops else 0.0,
        "temp_bytes_per_device": traced.peak,
        "arg_bytes_per_device": traced.arg_bytes,
    }


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, mode: str,
             fsdp: bool | None = None, remat: bool = True,
             verbose: bool = True) -> dict:
    mesh = make_production_mesh(multi_pod=multi_pod)
    _, traced, meta = lower_cell(arch, shape_name, mesh, mode=mode,
                                 fsdp=fsdp, remat=remat)
    rec = analyze(traced, meta["cfg"], meta["shape"], mesh)
    rec.update(multi_pod=multi_pod, mode=mode,
               lower_compile_s=meta["lower_compile_s"],
               accum_steps=meta["accum_steps"],
               kernels={k: {"calls": v[0], "flops": v[1], "bytes": v[2]}
                        for k, v in traced.kernels.items()})
    if verbose:
        print(_report(arch, shape_name, rec))
    return rec


def _report(arch: str, shape_name: str, rec: dict) -> str:
    coll = {k: f"{v / 1e9:.2f}GB"
            for k, v in rec["collective_bytes_per_device"].items() if v}
    return (f"== {arch} x {shape_name} "
            f"({'2x16x16' if rec['multi_pod'] else '16x16'}, "
            f"mode={rec['mode']}, accum={rec['accum_steps']}) ==\n"
            f"  temp {rec['temp_bytes_per_device'] / 1e9:.2f} GB/dev | "
            f"args {rec['arg_bytes_per_device'] / 1e9:.2f} GB/dev | "
            f"collectives/dev {coll}\n"
            f"  roofline: compute {rec['t_compute_s'] * 1e3:.3f} ms"
            f" | memory {rec['t_memory_s'] * 1e3:.3f} ms"
            f" | collective {rec['t_collective_s'] * 1e3:.3f} ms"
            f" -> {rec['dominant']} | traced in "
            f"{rec['lower_compile_s']:.1f} s")


def _cell_task(cell: tuple, kw: dict) -> tuple:
    """One cell in a worker process: ("ok", record) or ("failed", the
    error's repr)."""
    try:
        return "ok", run_cell(*cell, verbose=False, **kw)
    except Exception as e:  # noqa: BLE001 — report every cell
        return "failed", repr(e)


def _run_cells(cells: list, kw: dict, jobs: int) -> list:
    """Each cell's ("ok", record) or ("failed", error), in ``cells``'
    order: in this process, or over ``jobs`` worker processes (``spawn``),
    the train cells, the longest traces, handed out first."""
    if jobs <= 1:
        return [_cell_task(c, kw) for c in cells]
    import concurrent.futures
    import multiprocessing
    order = sorted(range(len(cells)),
                   key=lambda i: SHAPES[cells[i][1]].kind != "train")
    with concurrent.futures.ProcessPoolExecutor(
            jobs, mp_context=multiprocessing.get_context("spawn")) as pool:
        futs = {i: pool.submit(_cell_task, cells[i], kw) for i in order}
        return [futs[i].result() for i in range(len(cells))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mode", default="fp", choices=["fp", "fake", "int"])
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--json", default=None)
    ap.add_argument("--jobs", type=int, default=1,
                    help="trace the cells in this many worker processes")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch in ARCH_IDS:
            if arch == "resnet_paper":
                continue
            cfg = get_config(arch)
            for shp in supported_shapes(cfg):
                cells.append((arch, shp))
    elif args.arch and args.shape:
        cells.append((args.arch, args.shape))
    else:
        ap.error("name a cell (--arch and --shape) or pass --all")

    kw = dict(multi_pod=args.multi_pod, mode=args.mode,
              fsdp=False if args.no_fsdp else None,
              remat=not args.no_remat)
    records, failures = [], []
    for (arch, shp), (status, got) in zip(cells,
                                          _run_cells(cells, kw, args.jobs)):
        if status == "ok":
            records.append(got)
            print(_report(arch, shp, got))
        else:
            failures.append({"arch": arch, "shape": shp, "error": got})
            print(f"FAILED {arch} x {shp}: {got}", file=sys.stderr)

    if args.json:
        with open(args.json, "w") as f:
            json.dump({"records": records, "failures": failures}, f,
                      indent=1, default=str)
    print(f"\n{len(records)} cells traced, {len(failures)} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
