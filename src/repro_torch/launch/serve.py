"""Serving entry points of the PyTorch port.

Classic path (``serve``): Algorithm-1 calibration on one batch (INT and
FAKE modes, by default), then a batched prefill into a dense KV cache and
greedy decode steps, on the card each decode step after the first
replayed from one CUDA graph (``--no-graphs``: every step eager);
``--mode fake_sf`` is the paper's scaling-factor baseline (per-tensor
float scales, no calibration):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_1_7b \
        [--mode int|fake|fake_sf|fp] [--attn-kernel flash] [--full] \
        [--no-graphs] [--device cpu]

The recurrent archs (``rwkv6_3b``, ``zamba2_2_7b``) take the same path:
prefill over zero states (and zamba2's dense KV cache for its shared
attention block), then the O(1) decode recurrences, the decode step
captured as one CUDA graph on the card.  So do the mixture-of-experts
archs (``granite_moe_3b_a800m``; ``deepseek_v3_671b``, its attention
MLA over the compressed latent cache) and the audio encoder-decoder
(``whisper_large_v3``: the prompt carries stub frame embeddings, the
encoder runs once in prefill, each decode step recomputes the
cross-attention's K/V from the cached memory), which the engines
refuse, as in the reference.

Engine (``--engine``, ``serve_engine``): the continuous-batching engine on
the paged int8-KV pool against a synthetic Poisson workload; ``--w8a8``
calibrates, pre-quantizes the weights to int8 codes and serves every
projection through the int8 shift-requant kernel; ``--spec-k K`` drafts up
to K tokens a slot (``--drafter ngram``) and verifies them in the same
step; ``--no-ragged`` serves through the legacy per-shape steps (paged
attention, K4) instead of the unified ragged step (K1).  The recurrent
archs (``rwkv6_3b``, ``zamba2_2_7b``) serve from fixed-size state slabs,
``--slabs N`` of them (default one a slot plus the trash slab), fp32 or
with ``--state-bits 8`` int8 codes requantized once a step; zamba2's
shared attention block also keeps a paged KV pool (K4); they calibrate
and take ``--w8a8`` as the dense archs do:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_1_7b \
        --engine [--w8a8 | --mode fp | --mode int --no-calibrate] \
        [--spec-k 3] [--no-ragged] [--trace OUT.json] [--metrics OUT.prom] \
        [--profile-dir DIR] [--profile-cost] [--record OUT.json] [--slo]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6_3b \
        --engine [--w8a8 | --mode fp | --mode int] [--state-bits 8] \
        [--slabs 3]

Observability: ``--trace`` exports the run's Chrome trace (Perfetto),
``--metrics`` the registry's Prometheus text, ``--profile-dir`` a
``torch.profiler`` trace with one annotation per dispatch, ``--record``
a workload record on the virtual clock, ``--slo`` the stock SLO
objectives' burn-rate alerts; ``--replay IN.json`` re-runs a record (from
either package) and exits non-zero unless its tokens and scheduler
decisions are identical.

Runs on the CUDA device unless ``--device cpu`` is given.  ``--attn-kernel
flash`` sends the classic path's attention through the flash prefill and
decode kernels (K5, K6); ``chunked`` (the default) through their plain
versions.  ``--prefix-cache`` / ``--no-prefix-cache`` force the engine's
prefix cache on or off (default: the engine decides).  ``--profile-cost``
(engine) counts each step shape's FLOPs, bytes and peak live bytes at its
first call into the report (``obs.profile.Profiler.cost_for``).

Tensor-parallel serving (the dense families and the recurrent ones,
RWKV6 and zamba2, on either path; the moe family, granite-moe-3b and
deepseek-v3 with MLA, and the audio family, whisper, through classic
``serve``): ``--mesh DxM`` serves on a (data, model) mesh of D x M ranks
(``launch.mesh``), the attention heads (whole GQA groups and their KV;
MLA's heads, its latent cache whole on each rank; zamba2's shared block;
whisper's self- and cross-attention, its encoder memory whole on each
rank), the MLP hidden, the experts and the vocab cut over ``model``, the
recurrent blocks' projections cut by the reference's rules with their
states whole on each rank, the classic batch (and whisper's encoder
frames) over ``data`` (serving's 2-D rule cuts each expert's hidden over
it too), every step eager.  The ranks are spawned here, or joined when
``torchrun`` started the process (``torchrun --nproc-per-node D*M -m repro_torch.launch.serve
... --mesh DxM``); rank 0 prints.  ``--dist-backend`` names their
backend: nccl (the default on the card, one card a rank) or gloo (the
CPU's default; also ranks that share one card):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_1_7b \
        [--engine] --mesh 1x2 [--device cpu | --dist-backend gloo]
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch granite_moe_3b_a800m --mesh 1x2 [--device cpu | --dist-backend gloo]
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch rwkv6_3b|zamba2_2_7b|whisper_large_v3 [--engine] --mesh 1x2 \
        [--device cpu | --dist-backend gloo]     (no --engine for whisper)
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time

import numpy as np

__all__ = ["poisson_workload", "serve", "serve_engine", "serve_rank",
           "serve_engine_rank", "main"]


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _calibrated(cfg, params, mode: str, prompt: dict):
    """The INT / FAKE context: Algorithm 1 on one batch, the ``prompt``
    (its tokens, and the audio family's encoder features; the model's
    forward, FP mode, with activation capture), the mode swapped in.
    Returns (ctx, report)."""
    from repro_torch.core.lm_calibrate import calibrate_lm
    from repro_torch.core.qmodel import QuantMode
    from repro_torch.models import model as M
    ctx, report = calibrate_lm(lambda p, b, c: M.forward(p, b, cfg, c),
                               params, prompt)
    return dataclasses.replace(ctx, mode=QuantMode(mode)), report


def _resolve_cfg_mesh(arch: str, *, smoke: bool,
                      attn_kernel: str | None = None,
                      cfg_overrides: dict | None = None,
                      mesh_shape: tuple[int, int] | None = None):
    """Config and mesh setup shared by the classic and engine drivers:
    ``attn_kernel`` and ``cfg_overrides`` patch the config; ``mesh_shape``
    (data, model) is checked against it here, before any rank starts, by
    the step builders' refusals (``launch.steps._resolve_attn_kernel``:
    the model axis must divide the KV heads and what the rules cut).
    Returns (cfg, the (data, model) shape or None)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch import steps as S
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if attn_kernel is not None:
        cfg = dataclasses.replace(cfg, attn_kernel=attn_kernel)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    if mesh_shape is None:
        return cfg, None
    from repro_torch.launch.mesh import RankMesh
    shape = RankMesh(*(int(n) for n in mesh_shape))
    S._resolve_attn_kernel(cfg, shape)
    return cfg, (shape.shape["data"], shape.shape["model"])


def _launch_counts() -> dict:
    from repro_torch.kernels import ops as kops
    return {**kops.LAUNCHES, **kops.FORM_LAUNCHES}


def _launches_since(start: dict) -> dict:
    return {k: n - start[k] for k, n in _launch_counts().items()}


def _calibrated_timed(cfg, params, mode: str, prompt: dict):
    """:func:`_calibrated` and its seconds (the card synchronized)."""
    import torch
    t0 = time.perf_counter()
    ctx, report = _calibrated(cfg, params, mode, prompt)
    if next(iter(prompt.values())).device.type == "cuda":
        torch.cuda.synchronize()
    return ctx, report, time.perf_counter() - t0


def _rank_calibrated(cfg, params, mode: str, prompt: dict, mesh):
    """:func:`_calibrated_timed` on the whole model: on rank 0 of a mesh,
    its context sent to every rank (every rank then quantizes on the same
    grids); the report and the seconds are rank 0's."""
    ctx = report = None
    t_cal = 0.0
    if mesh is None or mesh.rank == 0:
        ctx, report, t_cal = _calibrated_timed(cfg, params, mode, prompt)
    if mesh is not None:
        ctx = mesh.broadcast_object(ctx)
    return ctx, report, t_cal


def serve(arch: str, *, batch: int = 4, prompt_len: int = 32, gen: int = 16,
          mode: str = "int", calibrate: bool = True, smoke: bool = True,
          seed: int = 0, params=None, attn_kernel: str | None = None,
          cfg_overrides: dict | None = None, graphs: bool | None = None,
          mesh_shape: tuple[int, int] | None = None,
          dist_backend: str | None = None, mesh=None, device=None,
          _graph_factory=None) -> dict:
    """Classic serving: calibrate (``mode`` 'int' / 'fake' with
    ``calibrate``; 'fp' and the scaling-factor baseline 'fake_sf' take
    none), prefill a ``batch`` x ``prompt_len`` synthetic prompt into a
    dense cache of ``prompt_len + gen`` positions, and decode ``gen - 1``
    greedy steps, each through ``launch.steps.run_serve_step``: the
    tokens and the position staged, the position read only on the device.

    With ``graphs`` (the default on a CUDA device; the CPU runs eagerly)
    the first decode step runs eagerly, the second is captured as one CUDA
    graph (key ``("decode", B, S_max)``, over a recurrent cache its
    shapes: ``launch.steps.serve_step_key``) and replayed, and every later
    step is a replay; ``graphs=False`` runs every step eagerly.  Prefill
    runs once a call and stays eager.

    Returns {"tokens" (B, gen) numpy, "logits" (the prefill's last
    logits (B, V), on the host), "prefill_s", "decode_s_per_tok",
    "compile_prefill_s", "compile_decode_s", "calibrate_s", "report",
    "ctx", "graphs", "launches"} (``graphs`` the
    :class:`launch.steps.StepGraphs` counts; ``calibrate_s`` is 0.0
    without calibration; ``launches`` each kernel's launches in the call,
    its forms' beside).
    ``compile_prefill_s`` holds the time of the prefill call (kernel
    builds and lazy initialisation included), which is also
    ``prefill_s``.  With graphs ``compile_decode_s`` holds the eager first
    decode call plus the capture (and its replay), and ``decode_s_per_tok``
    the mean of the later steps, all replays (0.0 when there are none), as
    the JAX package leaves compiling out of its decode time; without,
    ``compile_decode_s`` holds the first decode call, which is also part
    of ``decode_s_per_tok``.  ``params`` overrides the seeded random
    weights; in INT mode float matmul weights are quantized to int8 codes
    once, here, on the calibrated grids (bit-identical to quantizing in
    every call; on the recurrent and MoE archs only the leaves their
    ``qlinear`` calls (and the experts' products) read, each on its
    module's grid, ``models.model.qlinear_weight``: the MoE router and
    MLA's ``wkv_b`` stay float).
    ``device`` defaults to ``cuda``.  ``_graph_factory`` is
    for the tests: a stand-in for the CUDA graph (``StepGraphs``'
    ``graph_factory``) that drives the capture bookkeeping on the CPU.

    ``mesh_shape`` (data, model) serves on a mesh of D x M ranks
    (``launch.mesh``; spawned here unless ``torchrun`` started this
    process) over ``dist_backend`` (default nccl on the card, gloo on the
    CPU; ranks sharing one card take gloo): every language-model family,
    the whole model built (or ``params`` moved to the card), calibrated
    (rank 0) and cut by one rank at a time, so the ranks sharing a card
    never hold two whole models, then quantized on the rank's slices
    (heads, d_ff, the experts and vocab over ``model``; an expert's
    hidden over ``data``; the recurrent projections by the rules, their
    states whole), the batch (and the audio family's encoder features)
    cut over ``data`` when it divides
    (else every data rank serves it all; the moe family refuses that),
    every step eager.  Returns rank
    0's result (its tokens the whole batch's) with ``mesh`` and
    ``ranks``, every rank's {"tokens", "logits", "launches", ...}.  A
    caller that is already a rank passes its ``mesh``
    (``launch.mesh.RankMesh``) instead, and gets its rank's result."""
    if mesh is not None:
        mesh_shape = (mesh.shape["data"], mesh.shape["model"])
    cfg, mesh_shape = _resolve_cfg_mesh(arch, smoke=smoke,
                                        attn_kernel=attn_kernel,
                                        cfg_overrides=cfg_overrides,
                                        mesh_shape=mesh_shape)
    kw = dict(cfg=cfg, batch=batch, prompt_len=prompt_len, gen=gen,
              mode=mode, calibrate=calibrate, seed=seed, params=params)
    if mesh is not None:
        return serve_rank(mesh, graphs=graphs, **kw)
    if mesh_shape is None:
        return serve_rank(None, graphs=graphs, device=device,
                          graph_factory=_graph_factory, **kw)
    if graphs:
        raise ValueError("a mesh runs its decode steps eagerly: its "
                         "collectives cannot be captured (graphs=False)")
    from repro_torch.launch import mesh as mesh_lib
    ranks = mesh_lib.on_ranks(serve_rank, mesh_shape, device,
                              dist_backend, kw)
    return dict(ranks[0], mesh=mesh_shape, ranks=ranks)


def serve_rank(mesh, *, cfg, batch, prompt_len, gen, mode, calibrate, seed,
               params, graphs=None, device=None,
               graph_factory=None) -> dict:
    """:func:`serve`'s body on one process: the whole model (``mesh``
    None), or one rank of a mesh (its device the rank's): the rank
    worker, whose keywords are those :func:`serve` resolves (``cfg`` the
    resolved config)."""
    import torch
    from repro_torch.core.device import resolve_device
    from repro_torch.core.qmodel import (QuantContext, QuantMode,
                                         quantize_weight_tree)
    from repro_torch.data import SyntheticLMStream
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M
    dev = resolve_device(device if mesh is None else mesh.device)
    if params is None and mesh is None:
        params = M.init_params(cfg, seed, device=dev)
    audio = cfg.family == "audio"
    stream = SyntheticLMStream(
        cfg.vocab_size, prompt_len, batch, seed=seed,
        encoder_seq=cfg.encdec.encoder_seq if audio else None,
        d_model=cfg.d_model if audio else None)
    prompt = {k: torch.from_numpy(v).to(dev)
              for k, v in stream.batch(0).items()}

    ctx = QuantContext(mode=QuantMode(mode))
    report, t_cal = None, 0.0
    calibrating = calibrate and mode in ("fake", "int")
    if mesh is None:
        if calibrating:
            ctx, report, t_cal = _calibrated_timed(cfg, params, mode, prompt)
    else:
        # one rank at a time holds the whole model (the ranks may share a
        # card): rank 0 builds it, calibrates it whole, cuts it and frees
        # it before rank 1 builds its own, and so on
        whole = params
        for turn in range(mesh.size):
            if mesh.rank == turn:
                full = (M.init_params(cfg, seed, device=dev) if whole is None
                        else _to_device(whole, dev))
                if turn == 0 and calibrating:
                    ctx, report, t_cal = _calibrated_timed(cfg, full, mode,
                                                           prompt)
                params = _cut_whole(full, shd.param_sharding_rules(
                    full, mesh, fsdp=False, serve=True, cfg=cfg), mesh)
                del full
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
            mesh.barrier()
        if calibrating:
            ctx = mesh.broadcast_object(ctx)
    if calibrating:
        ctx = dataclasses.replace(ctx, mode=QuantMode(mode))
        if mesh is None or mesh.rank == 0:
            print(f"calibrated {len(report.results)} modules in "
                  f"{t_cal:.1f}s")
    if ctx.mode is QuantMode.INT:
        # the recurrent blocks' other matrices (LoRA and token-shift mixes,
        # conv taps), the MoE router and MLA's wkv_b are float operands
        # outside any unified module.  On a mesh the rank's slices: each
        # leaf's grid is its module's table entry, never its values', so
        # the codes are the whole tree's codes of the same slice
        params = quantize_weight_tree(
            params, ctx, name_fn=functools.partial(M.qlinear_weight, cfg=cfg)
            if cfg.family in ("ssm", "hybrid", "moe", "audio") else None)
    split = False
    if mesh is not None:
        d = mesh.shape["data"]
        split = batch % d == 0 and d > 1
        if split:
            rows = slice(mesh.coords["data"] * (batch // d),
                         (mesh.coords["data"] + 1) * (batch // d))
            prompt = {k: v[rows] for k, v in prompt.items()}
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    if graphs is None:
        graphs = dev.type == "cuda" and mesh is None
    # off a mesh the builders are called as their stand-ins are, without
    # the mesh's keywords
    on_mesh = {} if mesh is None else dict(mesh=mesh)
    step_graphs = S.StepGraphs(dev, capture=graphs,
                               graph_factory=graph_factory, **on_mesh)
    if mesh is not None:
        on_mesh["batch_split"] = split
    prefill_fn = S.build_prefill_step(cfg, ctx, max_seq=prompt_len + gen,
                                      **on_mesh)
    serve_fn = S.build_serve_step(cfg, ctx, **on_mesh)
    start = _launch_counts()
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, cache = prefill_fn(params, prompt)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        first_logits = logits.to("cpu", copy=True)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        out_tokens = [tok.cpu().numpy()]
        step_s = []
        for i in range(gen - 1):
            t0 = time.perf_counter()
            nxt = S.run_serve_step(step_graphs, serve_fn, params,
                                   out_tokens[-1], cache, prompt_len + i)
            # a copy that waits for the step (a replay's output is the
            # graph's static buffer)
            out_tokens.append(np.array(nxt.cpu()))
            step_s.append(time.perf_counter() - t0)
    launches = _launches_since(start)
    tokens = np.concatenate(out_tokens, axis=1)
    if split:
        # every data rank's rows, in data order (model rank 0 of each)
        m = mesh.shape["model"]
        gathered = mesh.gather_objects((tokens, first_logits))
        tokens = np.concatenate([gathered[r][0] for r in
                                 range(0, mesh.size, m)])
        first_logits = torch.cat([gathered[r][1] for r in
                                  range(0, mesh.size, m)])
    n_first = 2 if graphs else 1        # eager first call (and capture)
    replayed = step_s[n_first:] if graphs else step_s
    return {"tokens": tokens, "logits": first_logits,
            "prefill_s": t_prefill,
            "decode_s_per_tok": sum(replayed) / max(len(replayed), 1),
            "compile_prefill_s": t_prefill,
            "compile_decode_s": sum(step_s[:n_first]),
            "calibrate_s": t_cal, "report": report, "ctx": ctx,
            "launches": launches,
            "graphs": dict(enabled=graphs,
                           first_calls=step_graphs.first_calls,
                           captures=step_graphs.captures,
                           replays=step_graphs.replays)}


def _cut_whole(tree, specs, mesh):
    """The rank's slices of the whole params ``tree`` (a tree of dicts and
    lists this rank made: ``init_params``' or ``_to_device``'), each leaf
    cut as ``specs`` says (``distributed.sharding.shard_leaf``) and
    dropped from ``tree`` as it is cut, so the rank never holds the whole
    model and all its slices at once."""
    from repro_torch.distributed.sharding import shard_leaf
    if isinstance(tree, (dict, list)):
        for k in (list(tree) if isinstance(tree, dict) else
                  range(len(tree))):
            tree[k] = _cut_whole(tree[k], specs[k], mesh)
        return tree
    return shard_leaf(tree, specs, mesh, mesh.coords)


def _to_device(tree, dev):
    """A params tree (nested dicts and lists of tensors) on ``dev``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, dev) for v in tree]
    return tree.to(dev)


def poisson_workload(vocab_size: int, *, n_requests: int, rate: float,
                     prompt_lens=(8, 16, 24, 32), gen_lens=(4, 8, 16, 24),
                     temperature: float = 0.0, seed: int = 0,
                     shared_prefix: int = 0) -> list:
    """Synthetic open-loop workload: Poisson arrivals (exponential
    inter-arrival at ``rate`` req/s on the engine clock) with mixed
    prompt/generation lengths; ``shared_prefix`` prepends the same random
    system prompt to every request.  Pure numpy, draw for draw the JAX
    package's, so both engines get identical requests."""
    from repro_torch.serving.scheduler import Request
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab_size, size=shared_prefix
                          ).astype(np.int32)
    t = 0.0
    reqs = []
    for i in range(n_requests):
        t += float(rng.exponential(1.0 / rate))
        tail = rng.integers(0, vocab_size,
                            size=int(rng.choice(prompt_lens))
                            ).astype(np.int32)
        reqs.append(Request(
            rid=i,
            prompt=np.concatenate([prefix, tail]) if shared_prefix else tail,
            max_new_tokens=int(rng.choice(gen_lens)),
            temperature=temperature,
            arrival=t))
    return reqs


def serve_engine(arch: str, *, n_requests: int = 16, rate: float = 50.0,
                 n_slots: int = 4, block_size: int = 16, chunk: int = 16,
                 max_model_len: int | None = None,
                 num_blocks: int | None = None, mode: str = "fp",
                 calibrate: bool = False, smoke: bool = True, seed: int = 0,
                 kv_bits: int | None = 8, temperature: float = 0.0,
                 top_k: int = 0, prompt_lens=(8, 16, 24, 32),
                 gen_lens=(4, 8, 16, 24), requests=None,
                 cfg_overrides: dict | None = None, shared_prefix: int = 0,
                 prefix_cache: bool | None = None,
                 num_slabs: int | None = None,
                 state_bits: int | None = None, spec_k: int = 0,
                 drafter="ngram", ragged: bool = True, w8a8: bool = False,
                 trace: str | bool = False, trace_capacity: int = 65536,
                 metrics_path: str | None = None,
                 profile_dir: str | None = None,
                 profile_cost: bool = False,
                 record: str | bool = False, virtual_dt: float = 1e-3,
                 slo=None, params=None, graphs: bool | None = None,
                 mesh_shape: tuple[int, int] | None = None,
                 dist_backend: str | None = None, mesh=None,
                 device=None) -> dict:
    """Continuous-batching serving on the paged int8-KV block pool.
    Returns {"report", "outputs", "requests", "engine", "quantized",
    "ctx", "record"}.

    ``calibrate`` (INT / FAKE modes) runs Algorithm 1 on one 4-row batch
    of the longest prompt length.  ``w8a8=True`` is the W8A8 deploy: it
    forces INT mode with calibration, sets ``cfg.matmul_kernel='int8'``
    and pre-quantizes the calibrated matmul weights to int8 codes
    (``quantize_params``, returned under "quantized").  Otherwise INT mode
    quantizes the float matmul weights once, here, on the context's grids
    (bit-identical to quantizing in every call).  ``params`` overrides the
    seeded random weights (the tests pass the JAX package's weights
    through ``models.model.from_jax_params``).  ``spec_k > 0`` drafts up
    to K tokens a slot with ``drafter`` ('ngram', or any object with a
    ``draft(history, k)`` method) and verifies them in the same step;
    ``ragged=False`` serves through the legacy per-shape steps.
    Recurrent / hybrid archs (``rwkv6_3b``, ``zamba2_2_7b``) serve from the
    fixed-slab substrate: ``num_slabs`` sizes the state pool (default one
    slab a slot plus the trash slab) and ``state_bits=8`` stores the slabs
    as int8 Eq.-1 codes requantized once a step (``None``: fp32 slabs).
    They refuse ``spec_k > 0`` and ``prefix_cache=True``; their INT mode
    converts only the leaves their ``qlinear`` calls read, each on its
    module's grid (``models.model.qlinear_weight``).
    ``device`` defaults to ``cuda``; there the engine runs each step
    key's first call eagerly, captures the key as a CUDA graph at its
    second and replays it from then on, unless ``graphs=False`` (every
    step eager, the comparison the graphs are held to).

    Observability: ``trace`` turns on the ring-buffered event tracer (a
    path string also exports the Chrome trace there); ``metrics_path``
    writes the registry's Prometheus text after the run; ``profile_dir``
    captures the run with ``torch.profiler`` into that directory, one
    ``record_function`` annotation per dispatch; ``profile_cost`` counts
    each step shape's first call (FLOPs, bytes, peak live bytes, each
    kernel's charge: ``obs.profile.Profiler.cost_for``) into the report's
    ``profile`` section, ``cost_analysis``; ``record`` runs on the
    deterministic virtual clock (``virtual_dt`` a step) and returns the
    run's :class:`repro_torch.obs.replay.WorkloadRecord` under "record"
    (a path string also saves it as JSON); ``slo`` attaches the SLO
    burn-rate monitor (``True`` for the stock objectives, or a list of
    ``SLObjective``).

    ``mesh_shape`` (data, model) serves on a mesh of D x M ranks, as
    :func:`serve`'s (the dense and recurrent families; ``dist_backend``):
    the weights calibrated and quantized whole, then cut; every rank runs
    the engine over the same requests with its slices and its pool of its
    KV heads (the recurrent families' state slabs whole on every rank),
    eagerly; the data ranks are replicas.  Rank 0 reports and exports
    (trace, metrics, record); the result is rank 0's ("engine" None,
    "quantized" its converted paths only) with ``mesh`` and ``ranks``,
    every rank's {"outputs", "launches", "record"}; a caller
    that is already a rank passes its ``mesh`` instead, as
    :func:`serve`'s."""
    if mesh is not None:
        mesh_shape = (mesh.shape["data"], mesh.shape["model"])
    overrides = dict(cfg_overrides or {})
    if kv_bits is not None:
        overrides.setdefault("kv_cache_bits", kv_bits)
    if state_bits is not None:
        overrides.setdefault("state_bits", state_bits)
    if w8a8:
        mode, calibrate = "int", True
        overrides["matmul_kernel"] = "int8"
    cfg, mesh_shape = _resolve_cfg_mesh(arch, smoke=smoke,
                                        cfg_overrides=overrides,
                                        mesh_shape=mesh_shape)
    if requests is None:
        requests = poisson_workload(
            cfg.vocab_size, n_requests=n_requests, rate=rate,
            prompt_lens=prompt_lens, gen_lens=gen_lens,
            temperature=temperature, seed=seed,
            shared_prefix=shared_prefix)
    kw = dict(cfg=cfg, requests=requests, n_slots=n_slots,
              block_size=block_size, chunk=chunk,
              max_model_len=max_model_len, num_blocks=num_blocks, mode=mode,
              calibrate=calibrate, seed=seed, top_k=top_k,
              prompt_len=max(prompt_lens), prefix_cache=prefix_cache,
              num_slabs=num_slabs, spec_k=spec_k, drafter=drafter,
              ragged=ragged, trace=trace, trace_capacity=trace_capacity,
              metrics_path=metrics_path, profile_dir=profile_dir,
              profile_cost=profile_cost, record=record,
              virtual_dt=virtual_dt, slo=slo, params=params, graphs=graphs)
    if mesh is not None:
        return serve_engine_rank(mesh, **kw)
    if mesh_shape is None:
        return serve_engine_rank(None, device=device, **kw)
    if graphs:
        raise ValueError("a mesh runs its engine steps eagerly: its "
                         "collectives cannot be captured (graphs=False)")
    from repro_torch.launch import mesh as mesh_lib
    ranks = mesh_lib.on_ranks(serve_engine_rank, mesh_shape, device,
                              dist_backend, kw)
    return dict(ranks[0], requests=requests, mesh=mesh_shape, ranks=ranks)


def serve_engine_rank(mesh, *, cfg, requests, n_slots, block_size, chunk,
                      max_model_len, num_blocks, mode, calibrate, seed,
                      top_k, prompt_len, prefix_cache, num_slabs, spec_k,
                      drafter, ragged, trace, trace_capacity, metrics_path,
                      profile_dir, record, virtual_dt, slo, params, graphs,
                      profile_cost=False, device=None) -> dict:
    """:func:`serve_engine`'s body on one process: the whole model
    (``mesh`` None), or one rank of a mesh: the rank worker, whose
    keywords are those :func:`serve_engine` resolves."""
    import torch
    from repro_torch.core.device import resolve_device
    from repro_torch.core.qmodel import (QuantContext, QuantMode,
                                         quantize_params,
                                         quantize_weight_tree)
    from repro_torch.data import SyntheticLMStream
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServingEngine
    dev = resolve_device(device if mesh is None else mesh.device)
    recurrent = cfg.family in ("ssm", "hybrid")
    if params is None:
        params = M.init_params(cfg, seed, device=dev)
    elif mesh is not None:
        params = _to_device(params, dev)
    ctx = QuantContext(mode=QuantMode(mode))
    if calibrate and mode in ("fake", "int"):
        stream = SyntheticLMStream(cfg.vocab_size, prompt_len, 4, seed=seed)
        tokens = torch.from_numpy(stream.batch(0)["tokens"]).to(dev)
        ctx, _, _ = _rank_calibrated(cfg, params, mode, {"tokens": tokens},
                                     mesh)
    quantized = None
    if cfg.matmul_kernel == "int8":
        if ctx.mode is not QuantMode.INT:
            raise ValueError("matmul_kernel='int8' requires mode='int' "
                             "(pass w8a8=True or mode='int')")
        quantized = quantize_params(params, ctx)
        params = quantized.tree
    elif ctx.mode is QuantMode.INT:
        # the recurrent blocks' other matrices (LoRA and token-shift mixes,
        # conv taps) are float operands outside any unified module
        params = quantize_weight_tree(
            params, ctx, name_fn=M.qlinear_weight if recurrent else None)
    if mesh is not None:
        # quantized whole, then cut: the codes cut as their floats do
        params = shd.shard_params(params, mesh, mesh.coords, cfg=cfg)
        if quantized is not None:
            quantized = dataclasses.replace(quantized, tree=None)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if max_model_len is None:
        need = max(len(r.prompt) + r.max_new_tokens for r in requests)
        max_model_len = -(-need // block_size) * block_size
    lead = mesh is None or mesh.rank == 0      # reports and exports
    engine = ServingEngine(cfg, params, ctx, n_slots=n_slots,
                           block_size=block_size, chunk=chunk,
                           max_model_len=max_model_len,
                           num_blocks=num_blocks, num_slabs=num_slabs,
                           top_k=top_k, seed=seed,
                           prefix_cache=prefix_cache, spec_k=spec_k,
                           drafter=drafter, ragged=ragged,
                           trace=bool(trace), trace_capacity=trace_capacity,
                           profile_dir=profile_dir if lead else None,
                           profile_cost=profile_cost and lead,
                           record=bool(record), virtual_dt=virtual_dt,
                           slo=slo, graphs=graphs, device=dev, mesh=mesh)
    start = _launch_counts()
    with torch.no_grad(), engine.profiler.capture():
        report = engine.run(requests)
    launches = _launches_since(start)
    if (profile_dir is not None or profile_cost) and lead:
        # names the exported trace file; the cost table
        report = engine.report()
    if isinstance(trace, str) and trace and lead:
        engine.tracer.export(trace)
    if metrics_path is not None and lead:
        with open(metrics_path, "w") as fh:
            fh.write(engine.metrics.to_prometheus())
    rec = None
    if record:
        rec = engine.workload_record(requests)
        if isinstance(record, str) and lead:
            rec.save(record)
    return {"report": report, "outputs": engine.outputs(),
            "requests": requests, "quantized": quantized, "ctx": ctx,
            "record": rec, "launches": launches,
            "engine": engine if mesh is None else None}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", "--model", dest="arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--mode", default="int",
                    choices=["fp", "fake", "fake_sf", "int"])
    ap.add_argument("--no-calibrate", action="store_true")
    ap.add_argument("--full", action="store_true",
                    help="full-size config instead of the smoke config")
    ap.add_argument("--attn-kernel", default=None,
                    choices=["chunked", "flash"],
                    help="attention of the classic path; default: cfg's")
    ap.add_argument("--engine", action="store_true",
                    help="continuous-batching engine on the paged int8-KV "
                         "pool against a synthetic Poisson workload")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=50.0)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--shared-prefix", type=int, default=0, metavar="N")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="[--engine] force the content-addressed prefix "
                         "cache on (default: the engine decides: on for "
                         "attention archs, unavailable on recurrent ones)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="[--engine] disable the prefix cache (the "
                         "baseline for an A/B at equal pool size)")
    ap.add_argument("--slabs", type=int, default=None, metavar="N",
                    help="[--engine] recurrent-state pool size in slabs "
                         "(default 1 trash + one per slot); ignored on "
                         "pure-attention archs")
    ap.add_argument("--state-bits", type=int, default=None, choices=[8],
                    help="[--engine] store recurrent state slabs as int8 "
                         "Eq.-1 codes, requantized once per engine step "
                         "(default: fp32 slabs); ignored on pure-attention "
                         "archs")
    ap.add_argument("--w8a8", action="store_true",
                    help="[--engine] W8A8 deploy: calibrate, pre-quantize "
                         "the weights to int8 codes and run every "
                         "projection through the int8 shift-requant kernel "
                         "(implies --mode int)")
    ap.add_argument("--spec-k", type=int, default=0, metavar="K",
                    help="[--engine] speculative decoding: draft up to K "
                         "tokens per slot and verify them in the same step; "
                         "accepted tokens commit, the rejected tail's blocks "
                         "retract (0 = off)")
    ap.add_argument("--drafter", default="ngram", choices=["ngram"],
                    help="[--engine --spec-k] draft proposer: the model-free "
                         "prompt-lookup self-drafter")
    ap.add_argument("--no-ragged", action="store_true",
                    help="[--engine] serve through the legacy per-shape "
                         "steps (prefill chunk / decode / verify, paged "
                         "attention) instead of the unified ragged step")
    ap.add_argument("--no-graphs", action="store_true",
                    help="run every step (engine) or decode step (classic "
                         "path) eagerly instead of replaying its CUDA graph")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="[--engine] structured event tracing; export the "
                         "run as Chrome trace-event JSON (Perfetto)")
    ap.add_argument("--trace-capacity", type=int, default=65536,
                    help="[--engine --trace] trace ring size (oldest "
                         "events drop first; the export counts them)")
    ap.add_argument("--metrics", default=None, metavar="OUT.prom",
                    help="[--engine] write the metrics registry as "
                         "Prometheus text after the run")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="[--engine] capture a torch.profiler trace of the "
                         "run into DIR (one annotation per dispatch)")
    ap.add_argument("--profile-cost", action="store_true",
                    help="[--engine] count each step shape's FLOPs, bytes "
                         "and peak live bytes at its first call into the "
                         "report's profile section (cost_analysis)")
    ap.add_argument("--record", default=None, metavar="OUT.json",
                    help="[--engine] flight recorder: run on the virtual "
                         "clock and save a workload record for --replay")
    ap.add_argument("--replay", default=None, metavar="IN.json",
                    help="(implies --engine) replay a workload record, "
                         "taken on either package, with the record's "
                         "engine settings; exits non-zero unless tokens "
                         "and scheduler decisions are identical")
    ap.add_argument("--slo", action="store_true",
                    help="[--engine] attach the stock SLO objectives with "
                         "burn-rate alerting")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="serve on a (data, model) mesh of ranks, e.g. "
                         "'1x2': heads, MLP hidden, vocab and the "
                         "recurrent projections cut over model, the "
                         "classic batch over data")
    ap.add_argument("--dist-backend", default=None, choices=["gloo", "nccl"],
                    help="[--mesh] the ranks' torch.distributed backend "
                         "(default nccl on the card, gloo on the CPU; ranks "
                         "sharing one card take gloo)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    if args.prefix_cache and args.no_prefix_cache:
        ap.error("--prefix-cache and --no-prefix-cache are mutually "
                 "exclusive")
    # tri-state: None lets the engine decide
    prefix_cache = (True if args.prefix_cache
                    else False if args.no_prefix_cache else None)
    if args.mesh is not None and (args.replay or args.slo):
        ap.error("--replay and --slo read the engine in this process; run "
                 "them without --mesh")
    if args.replay:
        raise SystemExit(_replay(args))
    from repro_torch.launch.mesh import parse_mesh
    try:
        mesh_shape = None if args.mesh is None else parse_mesh(args.mesh)
    except ValueError as e:
        ap.error(str(e))
    mesh_kw = dict(mesh_shape=mesh_shape, dist_backend=args.dist_backend)
    if mesh_shape is not None and not args.no_graphs:
        args.no_graphs = True           # a mesh's steps run eagerly
    # under torchrun every rank runs main; rank 0 prints
    quiet = int(os.environ.get("RANK", "0")) != 0
    if args.engine:
        try:
            out = serve_engine(
                args.arch, n_requests=args.requests, rate=args.rate,
                n_slots=args.slots, block_size=args.block_size,
                chunk=args.chunk, mode=args.mode,
                calibrate=not args.no_calibrate, smoke=not args.full,
                seed=args.seed, temperature=args.temperature,
                top_k=args.top_k, shared_prefix=args.shared_prefix,
                prefix_cache=prefix_cache,
                num_slabs=args.slabs, state_bits=args.state_bits,
                spec_k=args.spec_k, drafter=args.drafter,
                ragged=not args.no_ragged, w8a8=args.w8a8,
                trace=args.trace or False,
                trace_capacity=args.trace_capacity,
                metrics_path=args.metrics, profile_dir=args.profile_dir,
                profile_cost=args.profile_cost,
                record=args.record or False,
                slo=True if args.slo else None,
                graphs=False if args.no_graphs else None,
                device=args.device, **mesh_kw)
        except ValueError as e:
            ap.exit(2, f"error: {e}\n")
        if quiet:
            return
        print(json.dumps(out["report"], indent=2))
        _print_obs(args, out)
        if out["quantized"] is not None:
            print(f"w8a8: {len(out['quantized'].converted)} weight tensors "
                  f"pre-quantized to int8 codes")
        sp = out["report"]["speculative"]
        if sp is not None:
            print(f"speculative (K={sp['spec_k']}, {sp['drafter']}): "
                  f"acceptance {sp['acceptance_rate']}, "
                  f"{sp['tokens_per_step']} tokens/step over "
                  f"{sp['verify_steps']} verify steps "
                  f"({sp['fallback_decode_steps']} plain decode steps), "
                  f"{sp['retracted_blocks']} blocks retracted")
        return
    if args.spec_k or args.no_ragged or args.trace or args.metrics \
            or args.profile_dir or args.profile_cost or args.record \
            or args.slo:
        ap.error("--spec-k, --no-ragged and the observability options are "
                 "engine options: pass --engine")
    if args.w8a8:
        ap.error("--w8a8 is an engine option: pass --engine")
    out = serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                gen=args.gen, mode=args.mode,
                calibrate=not args.no_calibrate, smoke=not args.full,
                seed=args.seed, attn_kernel=args.attn_kernel,
                graphs=False if args.no_graphs else None,
                device=args.device, **mesh_kw)
    if quiet:
        return
    if mesh_shape is not None:
        same = all(np.array_equal(r["tokens"], out["tokens"])
                   for r in out["ranks"])
        print(f"mesh {args.mesh}: {len(out['ranks'])} rank(s) in this "
              f"process's view, tokens identical across them: {same}")
    print(f"generated {out['tokens'].shape} tokens | first calls "
          f"{out['compile_prefill_s']:.2f}s+{out['compile_decode_s']:.2f}s | "
          f"prefill {out['prefill_s']:.2f}s | "
          f"decode {1e3 * out['decode_s_per_tok']:.1f} ms/tok")
    print("sample:", out["tokens"][0][:16])


def _print_obs(args, out) -> None:
    """The observability lines after an engine run."""
    rep = out["report"]
    if args.record:
        rec = out["record"]
        print(f"record: {len(rec.requests)} requests, "
              f"{len(rec.decisions)} scheduler decisions, fingerprint "
              f"{rec.fingerprint} -> {args.record} (replay with --replay "
              f"{args.record})")
    if args.slo:
        mon = out["engine"].slo
        state = "ALERT" if mon.alerts_active else "ok"
        print(f"slo: {state} — {mon.alerts_fired} alert(s) fired over "
              f"{mon.evaluations} evaluations; worst burn rate "
              f"{mon.worst_burn_rate()}")
        for a in mon.alerts:
            print(f"  alert {a['objective']}: burn {a['burn_rate']} "
                  f"({a['window_bad']}/{a['window_total']} over window) "
                  f"at t={a['t']:.3f}s")
    if args.trace:
        obs = rep["obs"]
        print(f"trace: {obs['trace_events']} events ({obs['trace_dropped']}"
              f" dropped, ring {obs['trace_capacity']}) -> {args.trace}")
    if args.metrics:
        print(f"metrics: prometheus exposition -> {args.metrics}")
    if args.profile_dir:
        prof = rep["profile"]
        print(f"profile: {prof['annotated_dispatches']} annotated "
              f"dispatches -> {', '.join(prof['trace_files'])}")
    if args.profile_cost:
        for key, c in rep["profile"]["cost_analysis"].items():
            print(f"cost {key}: {c['flops'] / 1e9:.3f} GFLOP, "
                  f"{c['bytes_accessed'] / 1e6:.3f} MB, peak "
                  f"{c['peak_bytes'] / 1e6:.3f} MB")
    en, hw = rep["energy"], rep["hwcost"]
    print(f"energy proxy ({en['unit']}): {en['proxy_uj_per_token']} uJ/token"
          f" [prefill {en['prefill']['uj_per_token']}, decode "
          f"{en['decode']['uj_per_token']}, spec-wasted "
          f"{en['spec_wasted']['uj_per_token']}]; requant ops performed "
          f"{hw['requant_ops_performed']}, avoided "
          f"{hw['requant_ops_avoided']}, forward {hw['requant_ops_forward']}")


def _replay(args) -> int:
    """``--replay``: rebuild the record's engine and workload, replay it,
    and return 0 iff the tokens and the decision stream are identical."""
    from repro_torch.obs.replay import (WorkloadRecord, build_requests,
                                        replay_workload)
    rec = WorkloadRecord.load(args.replay)
    es = rec.engine
    out = serve_engine(args.arch, requests=build_requests(rec),
                       n_slots=es["n_slots"], block_size=es["block_size"],
                       chunk=es["chunk"], max_model_len=es["max_model_len"],
                       num_blocks=es["num_blocks"], mode=args.mode,
                       calibrate=not args.no_calibrate, smoke=not args.full,
                       top_k=es["default_top_k"], seed=es["seed"],
                       prefix_cache=es["prefix_cache"],
                       num_slabs=es.get("num_slabs"),
                       state_bits=es["model"].get("state_bits"),
                       spec_k=es["spec_k"],
                       drafter=args.drafter, ragged=es["ragged"],
                       w8a8=args.w8a8, record=True,
                       virtual_dt=es["virtual_dt"], device=args.device)
    import torch
    with torch.no_grad():
        res = replay_workload(rec, out["engine"])
    print(f"replay {args.replay}: fingerprint "
          f"{'match' if res.fingerprint_match else 'MISMATCH'} (record "
          f"{res.record_fingerprint}, engine {res.engine_fingerprint})")
    print("tokens: " + ("identical" if res.token_identical else
                        f"MISMATCH rids={res.mismatched_rids}"))
    print(f"scheduler-decision diff: {len(res.decision_diff)} lines"
          + ("" if res.decision_diff else " (empty — identical)"))
    for line in res.decision_diff[:40]:
        print("  " + line)
    return 0 if res.ok else 1


if __name__ == "__main__":
    main()
