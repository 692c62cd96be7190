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
        [--spec-k 3] [--no-ragged] [--trace OUT.json] [--metrics OUT.prom] \
        [--profile-dir DIR] [--record OUT.json] [--slo]

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
versions.  The JAX CLI's ``--mesh`` and ``--profile-cost`` options are not
ported yet.
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
                 trace: str | bool = False, trace_capacity: int = 65536,
                 metrics_path: str | None = None,
                 profile_dir: str | None = None,
                 record: str | bool = False, virtual_dt: float = 1e-3,
                 slo=None, params=None, device=None) -> dict:
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
    ``device`` defaults to ``cuda``.

    Observability: ``trace`` turns on the ring-buffered event tracer (a
    path string also exports the Chrome trace there); ``metrics_path``
    writes the registry's Prometheus text after the run; ``profile_dir``
    captures the run with ``torch.profiler`` into that directory, one
    ``record_function`` annotation per dispatch; ``record`` runs on the
    deterministic virtual clock (``virtual_dt`` a step) and returns the
    run's :class:`repro_torch.obs.replay.WorkloadRecord` under "record"
    (a path string also saves it as JSON); ``slo`` attaches the SLO
    burn-rate monitor (``True`` for the stock objectives, or a list of
    ``SLObjective``)."""
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
                           drafter=drafter, ragged=ragged,
                           trace=bool(trace), trace_capacity=trace_capacity,
                           profile_dir=profile_dir, record=bool(record),
                           virtual_dt=virtual_dt, slo=slo, device=dev)
    with torch.no_grad(), engine.profiler.capture():
        report = engine.run(requests)
    if profile_dir is not None:
        report = engine.report()        # names the exported trace file
    if isinstance(trace, str) and trace:
        engine.tracer.export(trace)
    if metrics_path is not None:
        with open(metrics_path, "w") as fh:
            fh.write(engine.metrics.to_prometheus())
    rec = None
    if record:
        rec = engine.workload_record(requests)
        if isinstance(record, str):
            rec.save(record)
    return {"report": report, "outputs": engine.outputs(),
            "requests": requests, "engine": engine, "quantized": quantized,
            "ctx": ctx, "record": rec}


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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    if args.replay:
        raise SystemExit(_replay(args))
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
                trace=args.trace or False,
                trace_capacity=args.trace_capacity,
                metrics_path=args.metrics, profile_dir=args.profile_dir,
                record=args.record or False,
                slo=True if args.slo else None, device=args.device)
        except ValueError as e:
            ap.exit(2, f"error: {e}\n")
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
            or args.profile_dir or args.record or args.slo:
        ap.error("--spec-k, --no-ragged and the observability options are "
                 "engine options: pass --engine")
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
                       prefix_cache=es["prefix_cache"], spec_k=es["spec_k"],
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
