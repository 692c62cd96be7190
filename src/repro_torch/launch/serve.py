"""Serving entry point of the PyTorch port: the continuous-batching engine on
the paged int8-KV pool against a synthetic Poisson workload.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_1_7b \
        --engine --mode int --no-calibrate [--full] [--device cpu]

Runs on the CUDA device unless ``--device cpu`` is given.  ``--mode fp``
serves float projections; ``--mode int`` serves every projection and the
LM head through the int8 shift-requant kernel on the default (uncalibrated)
fractional-bit grids, with the weights quantized once at model build.
Algorithm-1 calibration (the JAX CLI's default) and ``--w8a8`` are the
next slice and raise here; so does the classic non-engine serving path.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

__all__ = ["poisson_workload", "serve_engine", "main"]


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
                 prefix_cache: bool | None = None, spec_k: int = 0,
                 ragged: bool = True, w8a8: bool = False,
                 params=None, device=None) -> dict:
    """Continuous-batching serving on the paged int8-KV block pool.
    Returns {"report", "outputs", "requests", "engine", "ctx"}.

    ``params`` overrides the seeded random weights (the tests pass the
    JAX package's weights through ``models.model.from_jax_params``).  In
    ``mode='int'`` float matmul weights are quantized to int8 codes once,
    here, on the default grids.  ``device`` defaults to ``cuda``."""
    if calibrate or w8a8:
        raise NotImplementedError(
            "Algorithm-1 calibration and W8A8 deploy are not ported yet "
            "(ROADMAP Queue 1 item 5); pass calibrate=False")
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.device import resolve_device
    from repro_torch.core.qmodel import (QuantContext, QuantMode,
                                         quantize_weight_tree)
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServingEngine
    dev = resolve_device(device)
    overrides = dict(cfg_overrides or {})
    if kv_bits is not None:
        overrides.setdefault("kv_cache_bits", kv_bits)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if params is None:
        params = M.init_params(cfg, seed, device=dev)
    ctx = QuantContext(mode=QuantMode(mode))
    if ctx.mode is QuantMode.INT:
        params = quantize_weight_tree(params, ctx)
    if requests is None:
        requests = poisson_workload(
            cfg.vocab_size, n_requests=n_requests, rate=rate,
            prompt_lens=prompt_lens, gen_lens=gen_lens,
            temperature=temperature, seed=seed,
            shared_prefix=shared_prefix)
    if max_model_len is None:
        need = max(len(r.prompt) + r.max_new_tokens for r in requests)
        max_model_len = -(-need // block_size) * block_size
    engine = ServingEngine(cfg, params, ctx, n_slots=n_slots,
                           block_size=block_size, chunk=chunk,
                           max_model_len=max_model_len,
                           num_blocks=num_blocks, top_k=top_k, seed=seed,
                           prefix_cache=prefix_cache, spec_k=spec_k,
                           ragged=ragged, device=dev)
    report = engine.run(requests)
    return {"report": report, "outputs": engine.outputs(),
            "requests": requests, "engine": engine, "ctx": ctx}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", "--model", dest="arch", required=True)
    ap.add_argument("--mode", default="int", choices=["fp", "int"])
    ap.add_argument("--no-calibrate", action="store_true",
                    help="required for now: calibration is the next slice")
    ap.add_argument("--full", action="store_true",
                    help="full-size config instead of the smoke config")
    ap.add_argument("--engine", action="store_true",
                    help="continuous-batching engine on the paged int8-KV "
                         "pool (the only serving path ported so far)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=50.0)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--shared-prefix", type=int, default=0, metavar="N")
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    if not args.engine:
        ap.error("only --engine is ported to repro_torch so far")
    if not args.no_calibrate:
        ap.error("calibration is not ported yet: pass --no-calibrate")
    out = serve_engine(
        args.arch, n_requests=args.requests, rate=args.rate,
        n_slots=args.slots, block_size=args.block_size, chunk=args.chunk,
        mode=args.mode, calibrate=False, smoke=not args.full,
        seed=args.seed, temperature=args.temperature, top_k=args.top_k,
        shared_prefix=args.shared_prefix,
        prefix_cache=False if args.no_prefix_cache else None,
        device=args.device)
    print(json.dumps(out["report"], indent=2))


if __name__ == "__main__":
    main()
