"""Serving entry points of the PyTorch port.

Classic path (``serve``): Algorithm-1 calibration on one batch (INT and
FAKE modes, by default), then a batched prefill into a dense KV cache and
greedy decode steps:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_1_7b \
        [--mode int] [--attn-kernel flash] [--full] [--device cpu]

Engine (``--engine``, ``serve_engine``): the continuous-batching engine on
the paged int8-KV pool against a synthetic Poisson workload; ``--w8a8``
calibrates, pre-quantizes the weights to int8 codes and serves every
projection through the int8 shift-requant kernel; ``--spec-k K`` drafts up
to K tokens a slot (``--drafter ngram``) and verifies them in the same
step; ``--no-ragged`` serves through the legacy per-shape steps (paged
attention, K4) instead of the unified ragged step (K1):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_1_7b \
        --engine [--w8a8 | --mode fp | --mode int --no-calibrate] \
        [--spec-k 3] [--no-ragged]

Runs on the CUDA device unless ``--device cpu`` is given.  ``--attn-kernel
flash`` sends the classic path's attention through the flash prefill and
decode kernels (K5, K6); ``chunked`` (the default) through their plain
versions.  The JAX CLI's ``--mesh``, tracing, recording and replay options
are not ported yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np

__all__ = ["poisson_workload", "serve", "serve_engine", "main"]


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _calibrated(cfg, params, mode: str, tokens):
    """The INT / FAKE context: Algorithm 1 on one batch of ``tokens``
    (the model's forward, FP mode, with activation capture), the mode
    swapped in.  Returns (ctx, report)."""
    from repro_torch.core.lm_calibrate import calibrate_lm
    from repro_torch.core.qmodel import QuantMode
    from repro_torch.models import model as M
    ctx, report = calibrate_lm(lambda p, b, c: M.forward(p, b, cfg, c),
                               params, {"tokens": tokens})
    return dataclasses.replace(ctx, mode=QuantMode(mode)), report


def serve(arch: str, *, batch: int = 4, prompt_len: int = 32, gen: int = 16,
          mode: str = "int", calibrate: bool = True, smoke: bool = True,
          seed: int = 0, params=None, attn_kernel: str | None = None,
          cfg_overrides: dict | None = None, device=None) -> dict:
    """Classic serving: calibrate (``mode`` 'int' / 'fake' with
    ``calibrate``), prefill a ``batch`` x ``prompt_len`` synthetic prompt
    into a dense cache of ``prompt_len + gen`` positions, and decode
    ``gen - 1`` greedy steps.

    Returns {"tokens" (B, gen) numpy, "prefill_s", "decode_s_per_tok",
    "compile_prefill_s", "compile_decode_s", "report", "ctx"}.  There is
    nothing to compile: ``compile_prefill_s`` / ``compile_decode_s`` hold
    the time of the first prefill / decode call (kernel builds and lazy
    initialisation included), and that call is also part of ``prefill_s``
    / ``decode_s_per_tok``.  ``params`` overrides the seeded random
    weights; in INT mode float matmul weights are quantized to int8 codes
    once, here, on the calibrated grids (bit-identical to quantizing in
    every call).  ``device`` defaults to ``cuda``."""
    import torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.device import resolve_device
    from repro_torch.core.qmodel import (QuantContext, QuantMode,
                                         quantize_weight_tree)
    from repro_torch.data import SyntheticLMStream
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if attn_kernel is not None:
        cfg = dataclasses.replace(cfg, attn_kernel=attn_kernel)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    if params is None:
        params = M.init_params(cfg, seed, device=dev)
    stream = SyntheticLMStream(cfg.vocab_size, prompt_len, batch, seed=seed)
    prompt = {"tokens": torch.from_numpy(stream.batch(0)["tokens"]).to(dev)}

    ctx = QuantContext(mode=QuantMode(mode))
    report = None
    if calibrate and mode in ("fake", "int"):
        t0 = time.perf_counter()
        ctx, report = _calibrated(cfg, params, mode, prompt["tokens"])
        print(f"calibrated {len(report.results)} modules "
              f"in {time.perf_counter() - t0:.1f}s")
    if ctx.mode is QuantMode.INT:
        params = quantize_weight_tree(params, ctx)

    prefill_fn = S.build_prefill_step(cfg, ctx, max_seq=prompt_len + gen)
    serve_fn = S.build_serve_step(cfg, ctx)
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, cache = prefill_fn(params, prompt)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        out_tokens = [tok]
        t_first = 0.0
        t0 = time.perf_counter()
        for i in range(gen - 1):
            tok, cache = serve_fn(params, tok, cache, prompt_len + i)
            out_tokens.append(tok)
            if i == 0:
                _sync(dev)
                t_first = time.perf_counter() - t0
        _sync(dev)
        t_decode = time.perf_counter() - t0
    gen_tokens = torch.cat(out_tokens, dim=1).cpu().numpy()
    return {"tokens": gen_tokens, "prefill_s": t_prefill,
            "decode_s_per_tok": t_decode / max(gen - 1, 1),
            "compile_prefill_s": t_prefill, "compile_decode_s": t_first,
            "report": report, "ctx": ctx}


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
                 drafter="ngram", ragged: bool = True, w8a8: bool = False,
                 params=None, device=None) -> dict:
    """Continuous-batching serving on the paged int8-KV block pool.
    Returns {"report", "outputs", "requests", "engine", "quantized",
    "ctx"}.

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
    ``device`` defaults to ``cuda``."""
    import torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.device import resolve_device
    from repro_torch.core.qmodel import (QuantContext, QuantMode,
                                         quantize_params,
                                         quantize_weight_tree)
    from repro_torch.data import SyntheticLMStream
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServingEngine
    dev = resolve_device(device)
    overrides = dict(cfg_overrides or {})
    if kv_bits is not None:
        overrides.setdefault("kv_cache_bits", kv_bits)
    if w8a8:
        mode, calibrate = "int", True
        overrides["matmul_kernel"] = "int8"
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if params is None:
        params = M.init_params(cfg, seed, device=dev)
    ctx = QuantContext(mode=QuantMode(mode))
    if calibrate and mode in ("fake", "int"):
        stream = SyntheticLMStream(cfg.vocab_size, max(prompt_lens), 4,
                                   seed=seed)
        tokens = torch.from_numpy(stream.batch(0)["tokens"]).to(dev)
        ctx, _ = _calibrated(cfg, params, mode, tokens)
    quantized = None
    if cfg.matmul_kernel == "int8":
        if ctx.mode is not QuantMode.INT:
            raise ValueError("matmul_kernel='int8' requires mode='int' "
                             "(pass w8a8=True or mode='int')")
        quantized = quantize_params(params, ctx)
        params = quantized.tree
    elif ctx.mode is QuantMode.INT:
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
                           drafter=drafter, ragged=ragged, device=dev)
    with torch.no_grad():
        report = engine.run(requests)
    return {"report": report, "outputs": engine.outputs(),
            "requests": requests, "engine": engine, "quantized": quantized,
            "ctx": ctx}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", "--model", dest="arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--mode", default="int", choices=["fp", "fake", "int"])
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
    ap.add_argument("--no-prefix-cache", action="store_true")
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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    if args.engine:
        try:
            out = serve_engine(
                args.arch, n_requests=args.requests, rate=args.rate,
                n_slots=args.slots, block_size=args.block_size,
                chunk=args.chunk, mode=args.mode,
                calibrate=not args.no_calibrate, smoke=not args.full,
                seed=args.seed, temperature=args.temperature,
                top_k=args.top_k, shared_prefix=args.shared_prefix,
                prefix_cache=False if args.no_prefix_cache else None,
                spec_k=args.spec_k, drafter=args.drafter,
                ragged=not args.no_ragged, w8a8=args.w8a8,
                device=args.device)
        except ValueError as e:
            ap.exit(2, f"error: {e}\n")
        print(json.dumps(out["report"], indent=2))
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
    if args.spec_k or args.no_ragged:
        ap.error("--spec-k and --no-ragged are engine options: pass --engine")
    if args.w8a8:
        ap.error("--w8a8 is an engine option: pass --engine")
    out = serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                gen=args.gen, mode=args.mode,
                calibrate=not args.no_calibrate, smoke=not args.full,
                seed=args.seed, attn_kernel=args.attn_kernel,
                device=args.device)
    print(f"generated {out['tokens'].shape} tokens | first calls "
          f"{out['compile_prefill_s']:.2f}s+{out['compile_decode_s']:.2f}s | "
          f"prefill {out['prefill_s']:.2f}s | "
          f"decode {1e3 * out['decode_s_per_tok']:.1f} ms/tok")
    print("sample:", out["tokens"][0][:16])


if __name__ == "__main__":
    main()
