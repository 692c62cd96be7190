#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Run from a checkout of the repository on a machine with a CUDA device and
the CUDA toolkit.  Phases, one line each (or a few):

1. device: the card's name and power limit, and the build of every CUDA
   kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per source, in
   parallel);
2. K2 (int8 shift-requant matmul) against its plain PyTorch version on the
   card, bit-exact, at the serving path's shapes, with the kernel's, the
   plain version's and ``torch._int_mm``'s times beside the bound;
3. K1 (ragged paged attention) against its plain version on a mixed
   work-list, int8 and bf16 pools, with padding rows exactly 0;
4. model: a two-step mixed ``ragged_step`` of qwen3-1.7B at full width and
   2 layers in fp32, kernels on the card against the plain path on the
   CPU, in FP and INT mode;
5. engine: ``serve_engine`` at full depth in bf16, FP and INT mode, with
   the kernel launch counts of each run, and a repeat run that must give
   the same greedy tokens.

It then prints the card line, a JSON line describing every kernel, and as
its last line ``{"ok": true, "device": {...}}``.  Any failed check exits
non-zero before that line; without a CUDA device, or outside a checkout,
it exits non-zero at once.  It imports nothing of JAX or of the JAX
package.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of its bytes over the memory rate and its operations over
# the peak rate for their type
PEAK = {"bytes": 3.35e12, "int8": 1979e12, "bfloat16": 989e12,
        "float32": 67e12}
# device clock cycles per second, at least the card's boost clock, for
# sizing the sleep kernel that holds the timed launches back
SLEEP_CYCLES_PER_S = 2.0e9

# the serving path's K2 shapes: (K, N) -> launches per engine step for
# qwen3-1.7B (28 layers: wq, wo; wk, wv; w1, w3; w2; plus the LM head)
K2_SHAPES = {(2048, 2048): 56, (2048, 1024): 56, (2048, 6144): 56,
             (6144, 2048): 28, (2048, 151936): 1}
K2_ROWS = (8, 16, 24, 64, 128)
K2_STEP_ROWS = 24          # the engine's full mixed-step stream bucket

# K1 work-list at qwen3-1.7B's attention shape: (q_len, kv_len) per
# sequence — a prefill chunk continuing 128 resident rows, two decode
# rows, a 5-token tail, a fresh prefill — then padding rows and a slot
K1_ITEMS = ((16, 144), (1, 131), (1, 47), (5, 37), (16, 16))
K1_HEADS, K1_KV_HEADS, K1_DIM, K1_BS, K1_PAD_ROWS = 16, 8, 128, 16, 9
KV_FRAC_BITS = 4


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls (CUDA events).

    The timed calls queue behind a sleep kernel that outlasts the host's
    issuing of them, so the events time the device's work rather than the
    host's launch rate (a small launch takes the device less time than its
    Python wrapper takes the host)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    issue_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * issue_s * SLEEP_CYCLES_PER_S) + 1000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_ops: float, op_type: str):
    t_bytes = n_bytes / PEAK["bytes"] * 1e3
    t_ops = n_ops / PEAK[op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 1: device and build
# ---------------------------------------------------------------------------

def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0].strip()
    from repro_torch.kernels import _build
    secs = _build.build()
    log(f"[1] device: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | kernels built in {secs:.1f} s")
    for name in _build.KERNEL_SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {name}: {line.strip()}")
    return smi, secs


# ---------------------------------------------------------------------------
# phase 2: K2
# ---------------------------------------------------------------------------

def _k2_operands(torch, gen, m, k, n, copies=1):
    x = torch.randint(-128, 128, (m, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    ws = [torch.randint(-128, 128, (k, n), generator=gen, device="cuda",
                        dtype=torch.int8) for _ in range(copies)]
    return x, ws


def phase_k2(torch, out):
    from repro_torch.core.integer_ops import LinearQuantSpec
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)

    def pair(x, w, b, spec, relu=False):
        """The wrapper ``qlinear`` calls (kernel on these CUDA tensors)
        and the plain version, with the clip range and output type the
        spec implies."""
        unsigned = relu and spec.out_unsigned
        lo, hi = (0, 255) if unsigned else (-128, 127)
        dt = torch.uint8 if unsigned else torch.int8
        return (ops.int8_matmul(x, w, b, spec, relu=relu),
                ref.int8_matmul_ref(x, w, b, shift=spec.requant_shift,
                                    bias_shift=spec.bias_shift, relu=relu,
                                    lo=lo, hi=hi, out_dtype=dt))

    # epilogue variants, and the byte-load path on odd shapes
    variants = [
        ("bias<<", (24, 2048, 2048), dict(n_x=4, n_w=8, n_b=7, n_o=4), False),
        ("bias>>", (24, 2048, 2048), dict(n_x=2, n_w=3, n_b=9, n_o=4), False),
        ("relu-u8", (24, 2048, 2048),
         dict(n_x=2, n_w=3, n_b=9, n_o=4, out_unsigned=True), True),
        ("shift<0", (24, 2048, 1024), dict(n_x=0, n_w=1, n_b=1, n_o=6), False),
        ("odd", (5, 100, 130), dict(n_x=4, n_w=8, n_b=7, n_o=4), False),
        ("odd-relu", (37, 301, 67),
         dict(n_x=3, n_w=5, n_b=10, n_o=2, out_unsigned=True), True),
    ]
    max_err = 0

    def max_diff(got, want):
        nonlocal max_err
        err = int((got.int() - want.int()).abs().max())
        max_err = max(max_err, err)
        return err

    for name, (m, k, n), spec_kw, relu in variants:
        x, (w,) = _k2_operands(torch, gen, m, k, n)
        b = torch.randint(-128, 128, (n,), generator=gen, device="cuda",
                          dtype=torch.int8)
        got, want = pair(x, w, b, LinearQuantSpec(**spec_kw), relu)
        err = max_diff(got, want)
        check(got.dtype == want.dtype and err == 0,
              f"K2 {name} M={m} K={k} N={n}: kernel != plain ({err} max "
              f"diff)")
    log(f"[2] K2 epilogue variants bit-exact: "
        f"{', '.join(v[0] for v in variants)}")

    spec = LinearQuantSpec(n_x=4, n_w=8, n_b=8, n_o=4)   # the serving grid
    rows, step = [], {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                      "library_ms": 0.0, "bytes": 0, "ops": 0}
    for (k, n), per_step in K2_SHAPES.items():
        w_bytes = k * n
        copies = max(1, math.ceil(128e6 / w_bytes))       # beat the L2
        for m in K2_ROWS:
            x, ws = _k2_operands(torch, gen, m, k, n, copies)
            got, want = pair(x, ws[0], None, spec)
            check(max_diff(got, want) == 0,
                  f"K2 M={m} K={k} N={n}: kernel != plain")
            it = [0]

            def kernel():
                it[0] += 1
                ops.int8_matmul(x, ws[it[0] % copies], None, spec)

            def plain():
                it[0] += 1
                ref.int8_matmul_ref(x, ws[it[0] % copies], None,
                                    shift=spec.requant_shift)

            def library():
                it[0] += 1
                torch._int_mm(x, ws[it[0] % copies])

            ms = time_ms(torch, kernel, 20)
            plain_ms = time_ms(torch, plain, 3, warmup=1)
            lib_ok = m > 16 and k % 8 == 0 and n % 8 == 0   # _int_mm's rule
            lib_ms = time_ms(torch, library, 20) if lib_ok else None
            n_bytes = m * k + k * n + m * n
            n_ops = 2 * m * k * n
            b_ms, b_by = bound_ms(n_bytes, n_ops, "int8")
            rows.append(dict(m=m, k=k, n=n, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
            log(f"    K2 M={m:<3} K={k:<4} N={n:<6} exact | kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, _int_mm "
                f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, "
                f"bound {b_ms:.4f} ms ({b_by})")
            if m == K2_STEP_ROWS:
                step["ms"] += per_step * ms
                step["plain_ms"] += per_step * plain_ms
                step["library_ms"] += per_step * lib_ms
                step["bytes"] += per_step * n_bytes
                step["ops"] += per_step * n_ops
            del x, ws
    step["bound_ms"], step["bound_by"] = bound_ms(step["bytes"], step["ops"],
                                                  "int8")
    log(f"[2] K2 one engine step at M={K2_STEP_ROWS} (197 launches): kernel "
        f"{step['ms']:.3f} ms, plain {step['plain_ms']:.3f} ms, _int_mm "
        f"{step['library_ms']:.3f} ms, bound {step['bound_ms']:.3f} ms "
        f"({step['bound_by']}, {step['bytes'] / 1e9:.3f} GB)")
    step["max_abs_err"] = max_err
    out["k2"] = {"shapes": rows, "step": step}
    return step


# ---------------------------------------------------------------------------
# phase 3: K1
# ---------------------------------------------------------------------------

def _k1_case(torch, gen, q_dtype, kv_dtype, kvh=K1_KV_HEADS, bs=K1_BS):
    """The K1 work-list over a shuffled pool, as CUDA tensors."""
    from repro_torch.core.qscheme import quant
    h, d = K1_HEADS, K1_DIM
    ns = len(K1_ITEMS)
    nbmax = -(-max(kl for _, kl in K1_ITEMS) // bs)
    t_real = sum(q for q, _ in K1_ITEMS)
    t = t_real + K1_PAD_ROWS
    q = torch.randn((t, h, d), generator=gen, device="cuda").to(q_dtype)
    kf = torch.randn((ns, nbmax * bs, kvh, d), generator=gen, device="cuda")
    vf = torch.randn((ns, nbmax * bs, kvh, d), generator=gen, device="cuda")
    if kv_dtype == torch.int8:
        kc, vc = quant(kf, KV_FRAC_BITS), quant(vf, KV_FRAC_BITS)
    else:
        kc, vc = kf.to(kv_dtype), vf.to(kv_dtype)
    nb = 1 + ns * nbmax
    perm = torch.randperm(nb - 1, generator=gen, device="cuda") + 1
    bt = torch.zeros((ns + 1, nbmax), dtype=torch.int32, device="cuda")
    bt[:ns] = perm.reshape(ns, nbmax).to(torch.int32)
    kp = torch.zeros((nb, bs, kvh, d), dtype=kc.dtype, device="cuda")
    vp = torch.zeros_like(kp)
    kp[bt[:ns].long()] = kc.reshape(ns, nbmax, bs, kvh, d)
    vp[bt[:ns].long()] = vc.reshape(ns, nbmax, bs, kvh, d)
    q_len = torch.tensor([ql for ql, _ in K1_ITEMS] + [0], dtype=torch.int32,
                         device="cuda")
    kv_len = torch.tensor([kl for _, kl in K1_ITEMS] + [0],
                          dtype=torch.int32, device="cuda")
    q_start = torch.zeros_like(q_len)
    q_start[1:ns] = torch.cumsum(q_len[:ns - 1], 0).to(torch.int32)
    q_start[ns] = t
    nkv = KV_FRAC_BITS if kv_dtype == torch.int8 else None
    return (q, kp, vp, bt, q_start, q_len, kv_len), nkv, t_real


def phase_k1(torch, out):
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    # (name, q dtype, pool dtype, tolerance, KV heads, block size): the
    # serving shape first, then GQA 4 and 128-row blocks
    cases = [("int8 pool, fp32 q", torch.float32, torch.int8, 1e-4, 8, 16),
             ("int8 pool, bf16 q", torch.bfloat16, torch.int8, 2e-2, 8, 16),
             ("bf16 pool, bf16 q", torch.bfloat16, torch.bfloat16, 2e-2, 8, 16),
             ("int8 pool, fp32 q, GQA 4, bs 128", torch.float32, torch.int8,
              1e-4, 4, 128),
             ("bf16 pool, bf16 q, GQA 4, bs 128", torch.bfloat16,
              torch.bfloat16, 2e-2, 4, 128)]
    main = None
    for name, q_dt, kv_dt, tol, kvh, bs in cases:
        args, nkv, t_real = _k1_case(torch, gen, q_dt, kv_dt, kvh, bs)
        got = ops.ragged_attention(*args, kv_frac_bits=nkv)
        want = ref.ragged_attention_ref(*args, kv_frac_bits=nkv)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        check(got.dtype == q_dt and got.shape == want.shape,
              f"K1 {name}: output {got.dtype} {tuple(got.shape)}")
        check(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol),
              f"K1 {name}: kernel vs plain max |diff| {err:.3e} > tol {tol}")
        check(int(torch.count_nonzero(got[t_real:])) == 0,
              f"K1 {name}: padding rows are not exactly 0")
        log(f"[3] K1 {name}: within atol=rtol={tol} (max |diff| {err:.2e}), "
            f"{K1_PAD_ROWS} padding rows exactly 0")
        if main is None and kv_dt == torch.int8 and q_dt == torch.bfloat16:
            main = (args, nkv, err)
    args, nkv, err = main
    ms = time_ms(torch, lambda: ops.ragged_attention(*args, kv_frac_bits=nkv),
                 50)
    plain_ms = time_ms(torch, lambda: ref.ragged_attention_ref(
        *args, kv_frac_bits=nkv), 10)
    q = args[0]
    h, kvh, d = K1_HEADS, K1_KV_HEADS, K1_DIM
    t_real = sum(ql for ql, _ in K1_ITEMS)
    kv_rows = sum(kl for _, kl in K1_ITEMS)
    n_bytes = (t_real * h * d * q.element_size() * 2     # q in, out
               + kv_rows * kvh * 2 * d                    # int8 K and V
               + 4 * (args[3].numel() + 3 * args[4].numel()))
    pairs = sum(sum(kl - ql + i + 1 for i in range(ql)) for ql, kl in K1_ITEMS)
    n_ops = pairs * h * 4 * d                             # QK^T and PV
    b_ms, b_by = bound_ms(n_bytes, n_ops, "bfloat16")
    log(f"[3] K1 main-path case (bf16 q, int8 pool, H={h} KVH={kvh} D={d} "
        f"bs={K1_BS}, {t_real}+{K1_PAD_ROWS} rows): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}, {n_bytes} B)")
    res = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               max_abs_err=err, bytes=n_bytes, ops=n_ops)
    out["k1"] = res
    return res


# ---------------------------------------------------------------------------
# phase 4: full-width model, kernels on the card vs plain path on the CPU
# ---------------------------------------------------------------------------

def _model_steps(vocab, bs):
    """Two ragged steps: seq A prefills 16 tokens (blocks 1, 2); then seq B's
    12-token chunk (block 3), A's decode row at position 16, 3 padding rows
    and a padding slot."""
    import numpy as np
    rng = np.random.default_rng(11)
    a = rng.integers(0, vocab, size=17).astype(np.int32)
    b = rng.integers(0, vocab, size=12).astype(np.int32)
    s1 = dict(tokens=a[:16], positions=np.arange(16, dtype=np.int32),
              dest=(bs + np.arange(16)).astype(np.int32),
              bt=np.asarray([[1, 2], [0, 0], [0, 0]], np.int32),
              q_start=np.asarray([0, 16, 16], np.int32),
              q_len=np.asarray([16, 0, 0], np.int32),
              kv_len=np.asarray([16, 0, 0], np.int32))
    tok = np.zeros(16, np.int32)
    tok[:12], tok[12] = b, a[16]
    pos = np.zeros(16, np.int32)
    pos[:12], pos[12] = np.arange(12), 16
    dest = np.zeros(16, np.int32)
    dest[:12], dest[12] = 3 * bs + np.arange(12), 2 * bs
    s2 = dict(tokens=tok, positions=pos, dest=dest,
              bt=np.asarray([[3, 0], [1, 2], [0, 0]], np.int32),
              q_start=np.asarray([0, 12, 16], np.int32),
              q_len=np.asarray([12, 1, 0], np.int32),
              kv_len=np.asarray([12, 17, 0], np.int32))
    return s1, s2


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def phase_model(torch, out):
    """fp32 on both sides.  Tolerances, set before the first run: the CPU
    and the card sum fp32 products in different orders, so a float that
    lands within an ulp of a quantization boundary may round to the
    neighbouring code.  INT mode: the layer-0 pool is written before any
    such sum (rmsnorm and rope are float64-then-round on both devices,
    the products are exact integers), so it must be identical; elsewhere
    every code is within one step of the CPU's and at most 0.1% differ;
    logits (on the 2^-4 output grid) differ in at most 0.1% of entries,
    by at most 4 grid steps.  FP mode: pools as above; logits within
    atol=rtol=1e-3 in at least 99.9% of entries, all within 5e-2."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.qmodel import (QuantContext, QuantMode,
                                         quantize_weight_tree)
    from repro_torch.models import model as M
    from repro_torch.models.attention import RaggedBatch
    cfg = dataclasses.replace(get_config("qwen3_1_7b"), n_layers=2,
                              dtype="float32", kv_cache_bits=8)
    t0 = time.perf_counter()
    p_cpu = M.init_params(cfg, 0, device="cpu")
    p_gpu = _tree_to(p_cpu, "cuda")
    bs, nb = 16, 8
    res = {}
    for mode in ("fp", "int"):
        ctx = QuantContext(mode=QuantMode(mode))
        pc, pg = p_cpu, p_gpu
        if ctx.mode is QuantMode.INT:
            pc, pg = quantize_weight_tree(p_cpu, ctx), \
                quantize_weight_tree(p_gpu, ctx)
            check(torch.equal(pc["lm_head"], pg["lm_head"].cpu()),
                  "INT weight codes differ between the card and the CPU")
        caches = {d: M.init_paged_cache(cfg, nb, bs, device=d)
                  for d in ("cpu", "cuda")}
        worst = {"frac": 0.0, "max": 0.0}
        for step in _model_steps(cfg.vocab_size, bs):
            logits = {}
            for dev, params in (("cpu", pc), ("cuda", pg)):
                t = {k: torch.from_numpy(v).to(dev) for k, v in step.items()}
                rb = RaggedBatch(dest=t["dest"], block_tables=t["bt"],
                                 q_start=t["q_start"], q_len=t["q_len"],
                                 kv_len=t["kv_len"])
                lg, caches[dev] = M.ragged_step(params, t["tokens"],
                                                caches[dev], t["positions"],
                                                rb, cfg, ctx)
                logits[dev] = lg.float().cpu()
            a, b = logits["cuda"], logits["cpu"]
            check(bool(torch.isfinite(a).all()) and a.shape == b.shape,
                  f"model {mode}: non-finite or misshapen logits")
            diff = (a - b).abs()
            if ctx.mode is QuantMode.INT:
                frac = float((diff > 0).float().mean())
            else:
                frac = float((diff > 1e-3 + 1e-3 * b.abs()).float().mean())
            worst["frac"] = max(worst["frac"], frac)
            worst["max"] = max(worst["max"], float(diff.max()))
        pools = []
        for name, arr_c, arr_g in zip(("k", "v"), caches["cpu"]["paged_kv"],
                                      caches["cuda"]["paged_kv"]):
            d = (arr_g.cpu().int() - arr_c.int()).abs()
            for layer in range(cfg.n_layers):
                pools.append((name, layer, int((d[layer] > 0).sum()),
                              int(d[layer].max()), d[layer].numel()))
        max_code = max(p[3] for p in pools)
        frac_code = sum(p[2] for p in pools) / sum(p[4] for p in pools)
        log(f"[4] model {mode}: logits max |diff| {worst['max']:.3e}, "
            f"{worst['frac']:.2e} of entries "
            f"{'differ' if mode == 'int' else 'beyond 1e-3'}; pool codes "
            f"differing per (k/v, layer): "
            f"{[(p[0], p[1], p[2]) for p in pools]} of {pools[0][4]}, "
            f"max {max_code}")
        check(max_code <= 1 and frac_code <= 1e-3,
              f"model {mode}: pool codes differ by {max_code} steps in "
              f"{frac_code:.2e} of entries")
        if ctx.mode is QuantMode.INT:
            check(all(p[2] == 0 for p in pools if p[1] == 0),
                  "model int: the layer-0 pool differs from the CPU's")
            check(worst["frac"] <= 1e-3 and worst["max"] <= 0.25,
                  f"model int: logits differ in {worst['frac']:.2e} of "
                  f"entries, max {worst['max']}")
        else:
            check(worst["frac"] <= 1e-3 and worst["max"] <= 5e-2,
                  f"model fp: logits beyond tolerance in {worst['frac']:.2e}"
                  f" of entries, max {worst['max']}")
        res[mode] = dict(logits_max_abs=worst["max"],
                         logits_frac=worst["frac"], pool_codes=pools)
    log(f"[4] model phase {time.perf_counter() - t0:.1f} s")
    out["model"] = res
    del p_cpu, p_gpu
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5: the engine at full depth
# ---------------------------------------------------------------------------

def phase_engine(torch, out):
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_engine
    cfg = get_config("qwen3_1_7b")
    per_layer_k2 = 7
    res = {}
    for mode in ("fp", "int"):
        runs = []
        for rep in range(2):
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            # rate=1e9: every request arrives at t=0, so the schedule, and
            # with it every step's shapes, repeats exactly between runs
            o = serve_engine("qwen3_1_7b", smoke=False, mode=mode,
                             calibrate=False, kv_bits=8, n_requests=8,
                             n_slots=4, rate=1e9, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(ops.LAUNCHES)
            rep_ = o["report"]
            steps = rep_["ragged_steps"]
            peak = torch.cuda.max_memory_allocated() / 2**30
            k2_want = (cfg.n_layers * per_layer_k2 + 1) * steps \
                if mode == "int" else 0
            log(f"[5] engine {mode} run {rep}: {rep_['completed']} requests, "
                f"{rep_['gen_tokens']} tokens, {rep_['tokens_per_s']} tok/s, "
                f"{steps} ragged steps, launches K1 "
                f"{launches['ragged_attention']} K2 {launches['int8_matmul']}"
                f", TTFT p50 {rep_['ttft_s']['p50']:.4f} s, TPOT p50 "
                f"{rep_['tpot_s']['p50']:.4f} s, peak "
                f"{peak:.2f} GiB, {wall:.1f} s")
            check(rep_["completed"] == 8, f"engine {mode}: not all done")
            check(launches["ragged_attention"] == cfg.n_layers * steps,
                  f"engine {mode}: K1 launched {launches['ragged_attention']}"
                  f" times, want {cfg.n_layers} x {steps}")
            check(launches["int8_matmul"] == k2_want,
                  f"engine {mode}: K2 launched {launches['int8_matmul']} "
                  f"times, want {k2_want}")
            check(launches == rep_["kernel_launches"],
                  f"engine {mode}: report launches {rep_['kernel_launches']}")
            for req in o["requests"]:
                toks = o["outputs"][req.rid]
                check(1 <= len(toks) <= req.max_new_tokens
                      and int(toks.min()) >= 0
                      and int(toks.max()) < cfg.vocab_size,
                      f"engine {mode}: request {req.rid} tokens {toks}")
            runs.append((o["outputs"], launches, rep_, peak, wall))
            del o
            torch.cuda.empty_cache()
        (a, *_), (b, *_) = runs
        check(sorted(a) == sorted(b)
              and all(len(a[r]) == len(b[r]) and (a[r] == b[r]).all()
                      for r in a),
              f"engine {mode}: a repeated greedy run gave other tokens")
        log(f"[5] engine {mode}: repeat run token-identical")
        res[mode] = dict(launches=runs[0][1], report=runs[0][2],
                         peak_gib=runs[0][3], wall_s=runs[0][4])
    out["engine"] = res
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args(argv)
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch is missing: run from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    out: dict = {}
    try:
        smi, build_s = phase_device(torch)
        k2 = phase_k2(torch, out)
        k1 = phase_k1(torch, out)
        phase_model(torch, out)
        eng = phase_engine(torch, out)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    launches = eng["int"]["launches"]
    # "per" says what one timing covers: K1's times are one launch on the
    # mixed work-list; K2's sum one engine step's 197 launches (each shape
    # timed at the step's row bucket, times its launches per step)
    kernels = [
        {"name": "ragged_paged_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/ragged_attention.cu",
         "replaces": "src/repro/kernels/ragged_flash.py:63",
         "launches": launches["ragged_attention"],
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": None, "per": "launch"},
        {"name": "int8_matmul_requant", "route": "cuda",
         "source": "src/repro_torch/csrc/int8_matmul.cu",
         "replaces": "src/repro/kernels/int8_matmul.py:59",
         "launches": launches["int8_matmul"],
         "max_abs_err": k2["max_abs_err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": k2["library_ms"],
         "per": f"engine step: 197 launches at M={K2_STEP_ROWS}"},
    ]
    out.update(card=smi, build_s=build_s, kernels=kernels,
               seconds=time.perf_counter() - t_start)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1, default=str))
    log(f"total {out['seconds']:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
