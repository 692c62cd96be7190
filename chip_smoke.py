#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py [--out results.json] [--only 6,7]

(``--only`` runs the build and the named phases alone, for iterating on
a kernel or a path; the check is the run without it.)

Run from a checkout of the repository on a machine with a CUDA device and
the CUDA toolkit.  Phases, one line each (or a few):

1. device: the card's name and power limit, the build of every CUDA
   kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per source, in
   parallel), and the launch floor: the device time of a one-element K3
   launch and of a one-element PyTorch ``add_``, timed as every kernel;
2. K2 (int8 shift-requant matmul) against its plain PyTorch version on the
   card, bit-exact: its epilogue variants, then a grid of M in {1, 4, 8,
   16, 23, 24, 25, 64, 127, 128} x every serving (K, N) and the split-K
   boundary shapes, and large-M shapes on every tile, x int8 / uint8
   activations x four epilogue variants;
   at the serving path's shapes each with its tile and K splits, and the
   kernel's, the plain version's and ``torch._int_mm``'s times beside the
   bound;
3. K1 (ragged paged attention) against its plain version on a mixed
   work-list, int8 and bf16 pools, with padding rows exactly 0; a grid of
   work-lists (decode-only with kv_len on and beside the split
   boundaries, prefill-only, speculative tails, mixed) x GQA 1/2/4/16 x
   D 64/128 (and 100, 256 on the mixed list) x blocks of 16/128 rows x
   both q types and pool types, with padding rows and slots; the mixed work-list timed (its work list
   planned once, as the engine plans it); and a long case at qwen3-1.7B's
   heads (a decode row over 32768 positions, a 16-row chunk over 4096
   resident rows, two short decodes), held row by row at a tolerance a
   repeated pool block fails, timed beside its bound;
4. model: a two-step mixed ``ragged_step`` of qwen3-1.7B at full width and
   2 layers in fp32, kernels on the card against the plain path on the
   CPU, in FP and INT mode;
5. engine: ``serve_engine`` at full depth in bf16, FP and INT mode, with
   the kernel launch counts of each run, and a repeat run that must give
   the same greedy tokens;
6. K5 (flash prefill over a dense cache) against its plain version at the
   classic path's shapes, over a grid of GQA groups, head dims (one
   zero-padded), query counts and cache tails on both of its paths (bf16
   q on the tensor cores, fp32 q on the CUDA cores), and at one long
   prefill (held row by row, at a tolerance a repeated kv tile fails),
   with the kernel's, the plain version's and
   ``scaled_dot_product_attention``'s times;
7. K6 (split-KV flash decode) the same way: a grid of GQA groups, head
   dims and cache types at positions 0, on and beside split boundaries
   and 32767, the path's positions, and one long int8 cache, with the
   split count it used;
8. Algorithm-1 calibration of qwen3-1.7B at full width and 2 layers on
   the card and on the CPU: the tables must agree, apart from declared
   near-ties;
9. the 2-layer dense model (prefill + 3 decode steps, flash attention)
   on the card against the CPU: INT with an int8 cache (identical), FP
   with an fp32 cache (phase 4's FP rule) and FP with an int8 cache, with
   K5 / K6 launch counts;
10. classic ``serve`` at full depth in bf16 with flash attention: INT with
    calibration and an int8 cache, FP with a bf16 cache, each twice
    (token-identical repeats) with the launch counts of every kernel;
11. the W8A8 engine (``serve_engine(w8a8=True)``) at full depth, twice;
12. K3 (Eq.-1 quantize) and K7 (residual requant) against their plain
    versions, bit-exact, at the ResNet path's shapes and one 64M-element
    shape, and K2's uint8-activation variant at each im2col shape of the
    path, with its tile, times and bounds;
13. Algorithm-1 calibration of the paper's ResNet (``resnet_paper``
    CONFIG width, batch 64) on the card and on the CPU: the tables must
    agree, apart from declared near-ties;
14. the ResNet's integer forward at batch 256 on the card against the
    CPU's plain path: identical logits, exactly 16 K2, 6 K7 and 2 K3
    launches, twice with identical logits, with images per second;
15. K4 (paged attention over the KV block pool, on the work list its
    positions plan) against its plain version and its split-and-combine
    twin over a grid of query counts, GQA groups, pool types, head dims
    and block sizes (shuffled tables with trash tails, a padded slot, the
    speculative step's extra trash column); split cases (positions before,
    at and after the 512-row split edge and 4095, head dims 12, 100 and
    128, bf16 and fp32 q) and a 16-query chunk with a planned chunk edge
    among its rows; the legacy engine's decode, prefill-chunk and verify
    shapes and one long int8 cache (held row by row, at a tolerance a
    repeated pool block fails), each with its items and chunks and the
    kernel's, the plain version's and gather + dequantize + SDPA's times
    beside its bound;
16. ``paged_step`` of qwen3-1.7B at full width and 2 layers in fp32, the
    decode, prefill-chunk and (4, 4) verify shapes, kernels on the card
    against the plain path on the CPU, in phase 9's three cases: INT with
    an int8 pool and FP with an fp32 pool under phase 4's rules, FP with
    an int8 pool under phase 9's (every pool block but the trash block
    compared);
17. the legacy per-shape engine (``serve_engine(ragged=False)``) at full
    depth in bf16, FP and INT, twice each (token-identical repeats), with
    K4 = 28 x its dispatches, K1 = 0 and K2 = 197 a dispatch in INT; then
    the ragged engine once, and speculative decoding (``spec_k=3``) on the
    legacy and the ragged engine (K1 = 28 x ragged steps, K4 = 0 there),
    with tokens/s, TTFT, TPOT and the acceptance rate, every speculative
    run token-identical to the same engine's non-speculative run; for each
    request on which the two engines' plain runs differ, the top-2 logit
    margin (in bf16 ulps) at the first divergent token, from the classic
    dense prefill of the agreed prefix (printed, not gated);
18. the engine's observability at full depth on phase 5's workload: the
    ragged INT engine with obs off and with ``trace=True, slo=True`` and a
    metrics export, interleaved (off, on, on, off) for tokens/s, TPOT and
    TTFT, every run token-identical with the same launches; an obs-on
    INT and W8A8 run each held to K1 = 28 x steps and K2 = 197 x steps,
    a clean schema diff and Chrome trace (one dispatch span a step), the
    energy proxy reconciled exactly with the hwcost counters, and the
    requant ops performed (and, W8A8, forward) equal to the rows each
    step's descriptors scatter into the pool, counted independently;
    the trace's split of the run's wall time into dispatch spans by shape
    and the host time between them; a ``record=True`` run of the legacy
    engine with ``spec_k=3`` (INT) and of the ragged engine (FP), each
    through the JSON round trip and replayed on a fresh engine with
    identical tokens, an empty decision diff and a matching fingerprint;
    and a ``profile_dir`` run whose ``torch.profiler`` trace holds one
    ``ragged_step#N`` annotation per dispatch, each with K1's launches
    inside.

It then prints the card line, a JSON line describing every kernel (K4's
``library_ms`` is null: no single PyTorch call reads a block table), and
as its last line ``{"ok": true, "device": {...}}``.  Any failed check exits
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
# the peak rate for their type; elementwise integer and float work (K3,
# K7) is counted against the CUDA cores' fp32 rate, the table's one rate
# outside the tensor cores
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
# K2's bit-exactness grid: rows on and beside the one-block-row sizes (16,
# 32, 64, 128) and the engine's 24 bucket; (K, N) where the K splits end
# short, K ends inside a 64-row pipeline step, K is one split, N is one
# 8-column group; the epilogue variants (name, spec, ReLU)
K2_GRID_ROWS = (1, 4, 8, 16, 23, 24, 25, 64, 127, 128)
K2_SPLIT_EDGES = ((2112, 1024), (2064, 1024), (128, 1024), (16, 8),
                  (6144, 8), (4096, 264))
# large-M products, one per tall / narrow tile (the ResNet's tiles, and
# those a long prefill or a calibration batch would take), an N that ends
# inside a column tile, the first row count past one block row
K2_LARGE_M = ((4096, 256, 2048), (300, 256, 2048), (40000, 64, 64),
              (1000, 144, 32), (70000, 32, 32), (129, 2048, 1024),
              (3000, 96, 72))
K2_GRID_SPECS = (("bias<<", dict(n_x=4, n_w=8, n_b=7, n_o=4), False),
                 ("bias>>", dict(n_x=2, n_w=3, n_b=9, n_o=4), False),
                 ("relu-u8", dict(n_x=2, n_w=3, n_b=9, n_o=4,
                                  out_unsigned=True), True),
                 ("shift<0", dict(n_x=0, n_w=1, n_b=1, n_o=6), False))

# K1 work-list at qwen3-1.7B's attention shape: (q_len, kv_len) per
# sequence — a prefill chunk continuing 128 resident rows, two decode
# rows, a 5-token tail, a fresh prefill — then padding rows and a slot
K1_ITEMS = ((16, 144), (1, 131), (1, 47), (5, 37), (16, 16))
K1_HEADS, K1_KV_HEADS, K1_DIM, K1_BS, K1_PAD_ROWS = 16, 8, 128, 16, 9
# K1's grid of work-lists ((q_len, kv_len) per sequence): kv_len on and
# beside the 512-row split threshold and twice it
K1_GRID_LISTS = {
    "decode-only": ((1, 1), (1, 64), (1, 511), (1, 512), (1, 513),
                    (1, 1024), (1, 1025)),
    "prefill-only": ((16, 16), (16, 80), (7, 7), (16, 600)),
    "spec tails": ((4, 40), (4, 516), (2, 130), (4, 4)),
    "mixed": K1_ITEMS + ((1, 1030),),
}
# the long case at qwen3-1.7B's heads: a decode row over 32768 positions,
# a 16-row chunk over 4096 resident rows, two short decodes
K1_LONG_ITEMS = ((1, 32768), (16, 4112), (1, 100), (1, 37))
# the ResNet path (configs/resnet_paper.py CONFIG): the integer forward's
# batch, the calibration batch and the elementwise kernels' long shape
RESNET_BATCH, RESNET_CALIB_BATCH, ELEMWISE_LONG = 256, 64, 64 * 2**20
# K5 / K6 at their long shapes: each output held within this share of its
# row's largest |value| (``_close_rows``)
LONG_ROW_TOL = 2e-2
KV_FRAC_BITS = 4
# K4 at the legacy engine's decode shape (4 slots, qwen3-1.7B's heads, 16-row
# blocks, tables of 5 blocks as the phase-17 workload's 80-position model
# length) and over one long cache (2048 shuffled blocks a slot)
K4_DECODE_POS = (40, 55, 23, 70)
K4_NBMAX, K4_LONG_BLOCKS = 5, 2048
# K4's split cases: each slot's last position before, at and after the
# 512-row split edge, and a 4096-row range; and a 16-query chunk ending at
# K4_EDGE_LAST, whose second item's 33733-row range ends in a 5-row chunk
K4_SPLIT_LAST = (511, 512, 513, 4095)
K4_EDGE_LAST = 33732


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

def phase_device(torch, out):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0].strip()
    from repro_torch.kernels import _build
    from repro_torch.kernels.quantize import quantize_cuda
    secs = _build.build()
    log(f"[1] device: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | kernels built in {secs:.1f} s")
    for name in _build.KERNEL_SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {name}: {line.strip()}")
    # what one launch of a kernel with nothing to do costs the device,
    # timed as every kernel below is: a one-element K3 launch through the
    # port's ctypes binding (uncounted), and PyTorch's own add_
    one = torch.ones(1, device="cuda")
    floor_ms = time_ms(torch, lambda: quantize_cuda(
        one, n=0, lo=-128, hi=127, out_dtype=torch.int8), 500)
    torch_ms = time_ms(torch, lambda: one.add_(1.0), 500)
    log(f"[1] launch floor: {floor_ms:.5f} ms a one-element K3 launch, "
        f"{torch_ms:.5f} ms a one-element PyTorch add_ (device time, "
        f"launches queued behind the sleep kernel)")
    out["device"] = dict(card=smi, build_s=secs, launch_floor_ms=floor_ms,
                         torch_launch_floor_ms=torch_ms)
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


def _plan_str(plan) -> str:
    if plan.cfg < 0:
        return f"dp4a tile {plan.bm}x{plan.bn}"
    return (f"mma tile {plan.bm}x{plan.bn}, {plan.splits} split"
            f"{'s' if plan.splits > 1 else ''} of K")


def _k2_grid(torch, gen, pair, max_diff) -> int:
    """K2 bit-exact against its plain version over the grid's rows x every
    serving (K, N) and the split-K boundary shapes (a short last split, a
    K tail inside a pipeline step, the smallest split, narrow N, one
    weight row step), and over the large-M shapes (every tile), int8 and
    uint8 activations, every epilogue variant."""
    from repro_torch.core.integer_ops import LinearQuantSpec
    from repro_torch.kernels.int8_matmul import plan_int8_matmul
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [(m, k, nn) for k, nn in list(K2_SHAPES) + list(K2_SPLIT_EDGES)
             for m in K2_GRID_ROWS] + list(K2_LARGE_M)
    n, plans, wkn, w, b = 0, {}, None, None, None
    for m, k, nn in cases:
        plans[(m, k, nn)] = _plan_str(plan_int8_matmul(m, k, nn, sms))
        if wkn != (k, nn):         # one weight matrix at a time (LM head 311 MB)
            del w
            wkn, (_, (w,)) = (k, nn), _k2_operands(torch, gen, 1, k, nn)
            b = torch.randint(-128, 128, (nn,), generator=gen,
                              device="cuda", dtype=torch.int8)
        for x_dt in (torch.int8, torch.uint8):
            lo, hi = (0, 256) if x_dt == torch.uint8 else (-128, 128)
            x = torch.randint(lo, hi, (m, k), generator=gen, device="cuda",
                              dtype=torch.int32).to(x_dt)
            for name, spec_kw, relu in K2_GRID_SPECS:
                got, want = pair(x, w, b, LinearQuantSpec(**spec_kw), relu)
                err = max_diff(got, want)
                check(got.dtype == want.dtype and err == 0,
                      f"K2 grid {name} M={m} K={k} N={nn} {x_dt}: kernel "
                      f"!= plain ({err} max diff)")
                n += 1
    log("    K2 large M: " + "; ".join(
        f"M={m} K={k} N={nn} {plans[(m, k, nn)]}" for m, k, nn in K2_LARGE_M))
    for (k, nn) in K2_SPLIT_EDGES:
        log(f"    K2 split-K edge K={k} N={nn}: "
            + "; ".join(f"M={m} {plans[(m, k, nn)]}" for m in (1, 24, 128)))
    return n


def phase_k2(torch, out):
    from repro_torch.core.integer_ops import LinearQuantSpec
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.int8_matmul import plan_int8_matmul
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

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
    n_grid = _k2_grid(torch, gen, pair, max_diff)
    log(f"[2] K2 grid bit-exact ({n_grid} cases: M {list(K2_GRID_ROWS)} x "
        f"every serving (K, N) and the split-K boundary shapes, and "
        f"{len(K2_LARGE_M)} large-M shapes, x int8 / uint8 activations x "
        f"the {len(K2_GRID_SPECS)} epilogue variants)")

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
            plan = plan_int8_matmul(m, k, n, sms)
            rows.append(dict(m=m, k=k, n=n, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                             tile=[plan.bm, plan.bn], splits=plan.splits))
            log(f"    K2 M={m:<3} K={k:<4} N={n:<6} exact, {_plan_str(plan)} "
                f"| kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, _int_mm "
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

def _k1_build(torch, gen, items, h, kvh, d, bs, q_dtype, kv_dtype,
              pad_rows=K1_PAD_ROWS):
    """A K1 work-list ((q_len, kv_len) per sequence, packed into one
    stream) over a shuffled pool, as CUDA tensors: padding rows at the end
    of the stream and a trailing padding slot whose table names the trash
    block."""
    from repro_torch.core.qscheme import quant
    ns = len(items)
    nbmax = -(-max(kl for _, kl in items) // bs)
    t_real = sum(q for q, _ in items)
    t = t_real + pad_rows
    q = torch.randn((t, h, d), generator=gen, device="cuda").to(q_dtype)
    nb = 1 + ns * nbmax
    kf = torch.randn((nb, bs, kvh, d), generator=gen, device="cuda")
    vf = torch.randn((nb, bs, kvh, d), generator=gen, device="cuda")
    if kv_dtype == torch.int8:
        kp, vp = quant(kf, KV_FRAC_BITS), quant(vf, KV_FRAC_BITS)
    else:
        kp, vp = kf.to(kv_dtype), vf.to(kv_dtype)
    del kf, vf
    perm = torch.randperm(nb - 1, generator=gen, device="cuda") + 1
    bt = torch.zeros((ns + 1, nbmax), dtype=torch.int32, device="cuda")
    bt[:ns] = perm.reshape(ns, nbmax).to(torch.int32)
    q_len = torch.tensor([ql for ql, _ in items] + [0], dtype=torch.int32,
                         device="cuda")
    kv_len = torch.tensor([kl for _, kl in items] + [0],
                          dtype=torch.int32, device="cuda")
    q_start = torch.zeros_like(q_len)
    q_start[1:ns] = torch.cumsum(q_len[:ns - 1], 0).to(torch.int32)
    q_start[ns] = t
    nkv = KV_FRAC_BITS if kv_dtype == torch.int8 else None
    return (q, kp, vp, bt, q_start, q_len, kv_len), nkv, t_real


def _k1_work(args, h, d, q_bytes):
    """Bytes K1 must move (q in, out, the kv rows each sequence's last
    token sees, descriptors) and its operations (QK and PV, causal)."""
    q, kp, _, bt, q_start, q_len, kv_len = args
    kvh = kp.shape[2]
    items = list(zip(q_len.tolist(), kv_len.tolist()))
    t_real = sum(ql for ql, _ in items)
    kv_rows = sum(kl for _, kl in items)
    n_bytes = (t_real * h * d * q_bytes * 2 + kv_rows * kvh * 2 * d
               * kp.element_size() + 4 * (bt.numel() + 3 * q_start.numel()))
    pairs = sum(sum(kl - ql + i + 1 for i in range(ql)) for ql, kl in items)
    return n_bytes, pairs * h * 4 * d


def _k1_grid(torch, gen):
    """K1 against its plain version over work-lists (decode-only with
    kv_len on and beside the split boundaries, prefill-only, speculative
    tails, mixed), GQA 1/2/4/16, pool blocks of 16 and 128 rows, head dims
    64 and 128 (and on the mixed list 100, staged value by value, and
    256, the widest), int8 and float pools, bf16 q (tensor cores) and fp32
    q (CUDA cores); every list has padding rows and a padding slot, which
    must be exactly 0."""
    from repro_torch.kernels import ops, ref
    shapes = [(lname, groups, d, bs) for lname in K1_GRID_LISTS
              for groups in (1, 2, 4, 16) for d in (64, 128)
              for bs in (16, 128)]
    shapes += [("mixed", 2, d, 16) for d in (100, 256)]
    n, worst = 0, 0.0
    for lname, groups, d, bs in shapes:
        for q_dt, kv_dt, tol in ((torch.bfloat16, torch.int8, 2e-2),
                                 (torch.bfloat16, torch.bfloat16, 2e-2),
                                 (torch.float32, torch.int8, 1e-4),
                                 (torch.float32, torch.float32, 1e-4)):
            args, nkv, t_real = _k1_build(torch, gen, K1_GRID_LISTS[lname],
                                          2 * groups, 2, d, bs, q_dt, kv_dt,
                                          pad_rows=3)
            got = ops.ragged_attention(*args, kv_frac_bits=nkv)
            want = ref.ragged_attention_ref(*args, kv_frac_bits=nkv)
            torch.cuda.synchronize()
            what = (f"K1 grid {lname} G {groups} D {d} bs {bs} {q_dt} q "
                    f"{kv_dt} pool")
            worst = max(worst, _close(torch, got, want, tol, what))
            check(int(torch.count_nonzero(got[t_real:])) == 0,
                  f"{what}: padding rows are not exactly 0")
            n += 1
    return n, worst


def _k1_table_fault_caught(torch, args, want, nkv, seq, col):
    """The plain version over a table whose column ``col`` of sequence
    ``seq`` names the block of column ``col - 1`` (a kernel that reads one
    pool block twice and skips the next) must fall outside the row
    tolerance."""
    from repro_torch.kernels import ref
    bad_bt = args[3].clone()
    bad_bt[seq, col] = args[3][seq, col - 1]
    bad = ref.ragged_attention_ref(*args[:3], bad_bt, *args[4:],
                                   kv_frac_bits=nkv)
    return not _rows_within(torch, bad, want, LONG_ROW_TOL)


def phase_k1(torch, out):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.ragged_flash import plan_from_descriptors
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
        args, nkv, t_real = _k1_build(torch, gen, K1_ITEMS, K1_HEADS, kvh,
                                      K1_DIM, bs, q_dt, kv_dt)
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
    grid_n, grid_err = _k1_grid(torch, gen)
    log(f"[3] K1 grid ({grid_n} cases: work-lists "
        f"{', '.join(K1_GRID_LISTS)} x GQA 1/2/4/16 x D 64/128 x bs 16/128, "
        f"the mixed list at D 100 and 256, x bf16 q over int8 / bf16 pools "
        f"within atol=rtol=2e-2, fp32 q over int8 / fp32 pools within 1e-4; "
        f"padding rows and slots exactly 0): max |diff| {grid_err:.2e}")
    h, kvh, d = K1_HEADS, K1_KV_HEADS, K1_DIM
    groups = h // kvh

    def timed(args, nkv, iters):
        """Kernel and plain times, the work list planned once as the
        engine plans it (not inside the timed calls)."""
        work = plan_from_descriptors(*args[4:7], groups, "cuda")
        ms = time_ms(torch, lambda: ops.ragged_attention(
            *args, kv_frac_bits=nkv, work=work), iters)
        plain_ms = time_ms(torch, lambda: ref.ragged_attention_ref(
            *args, kv_frac_bits=nkv), 3 if iters < 50 else 10, warmup=1)
        return work, ms, plain_ms

    args, nkv, err = main
    work, ms, plain_ms = timed(args, nkv, 50)
    n_bytes, n_ops = _k1_work(args, h, d, args[0].element_size())
    b_ms, b_by = bound_ms(n_bytes, n_ops, "bfloat16")
    t_real = sum(ql for ql, _ in K1_ITEMS)
    log(f"[3] K1 main-path case (bf16 q, int8 pool, H={h} KVH={kvh} D={d} "
        f"bs={K1_BS}, {t_real}+{K1_PAD_ROWS} rows, {work.n_items} items, "
        f"{work.n_combine} split): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}, {n_bytes} B)")
    res = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               max_abs_err=err, bytes=n_bytes, ops=n_ops,
               grid_cases=grid_n, grid_max_abs_err=grid_err)

    # the long case, held row by row
    args, nkv, _ = _k1_build(torch, gen, K1_LONG_ITEMS, h, kvh, d, K1_BS,
                             torch.bfloat16, torch.int8)
    got = ops.ragged_attention(*args, kv_frac_bits=nkv)
    want = ref.ragged_attention_ref(*args, kv_frac_bits=nkv)
    torch.cuda.synchronize()
    err = _close_rows(torch, got, want, LONG_ROW_TOL, "K1 long case")
    col = K1_LONG_ITEMS[0][1] // K1_BS // 2
    check(_k1_table_fault_caught(torch, args, want, nkv, 0, col),
          "K1 long case: the row tolerance passes a repeated pool block")
    del want
    work, ms, plain_ms = timed(args, nkv, 20)
    n_bytes, n_ops = _k1_work(args, h, d, args[0].element_size())
    b_ms, b_by = bound_ms(n_bytes, n_ops, "bfloat16")
    log(f"[3] K1 long case ((q_len, kv_len) {list(K1_LONG_ITEMS)}, bf16 q, "
        f"int8 pool, H={h} KVH={kvh} D={d} bs={K1_BS}; {work.n_items} items, "
        f"{work.n_combine} split into {work.n_parts} chunks): within "
        f"{LONG_ROW_TOL} of each row's largest |value|, which a repeated "
        f"pool block fails (max |diff| {err:.2e}) | kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}, {n_bytes} "
        f"B), {ms / b_ms:.2f}x the bound")
    res["long"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       max_abs_err=err, bytes=n_bytes, ops=n_ops,
                       items=work.n_items, splits=work.n_parts)
    del args, got
    torch.cuda.empty_cache()
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
            check({k: launches[k] for k in rep_["kernel_launches"]}
                  == rep_["kernel_launches"],
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


# ---------------------------------------------------------------------------
# phases 6 and 7: K5 and K6 against their plain versions
# ---------------------------------------------------------------------------

def _dense_qkv(torch, gen, b, sq, skv, h, kvh, d, q_dt, kv_dt):
    from repro_torch.core.qscheme import quant
    q = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(q_dt)
    k = torch.randn((b, skv, kvh, d), generator=gen, device="cuda")
    v = torch.randn((b, skv, kvh, d), generator=gen, device="cuda")
    if kv_dt == torch.int8:
        return q, quant(k, KV_FRAC_BITS), quant(v, KV_FRAC_BITS), KV_FRAC_BITS
    return q, k.to(kv_dt), v.to(kv_dt), None


def _sdpa(torch):
    """``scaled_dot_product_attention`` over (B, S, H, D) tensors with
    grouped KV heads: ``enable_gqa`` where the installed PyTorch has it,
    else K/V repeated per group.  Timed as the yardstick only."""
    F = torch.nn.functional
    probe = torch.zeros((1, 2, 1, 8), device="cuda")
    try:
        F.scaled_dot_product_attention(probe, probe[:, :1], probe[:, :1],
                                       enable_gqa=True)
        gqa = True
    except TypeError:
        gqa = False

    def call(q, k, v, causal):
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        if gqa:
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal,
                                                  enable_gqa=True)
        g = qt.shape[1] // kt.shape[1]
        return F.scaled_dot_product_attention(
            qt, kt.repeat_interleave(g, 1), vt.repeat_interleave(g, 1),
            is_causal=causal)
    return call, ("enable_gqa" if gqa else "repeated K/V")


def _deq(torch, k, nkv, dt):
    from repro_torch.core.qscheme import dequant
    return dequant(k, nkv, out_dtype=dt) if nkv is not None else k.to(dt)


def _close(torch, got, want, tol, what):
    err = float((got.float() - want.float()).abs().max())
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{what}: output {got.dtype} {tuple(got.shape)}")
    check(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol),
          f"{what}: kernel vs plain max |diff| {err:.3e} > tol {tol}")
    return err


def _close_rows(torch, got, want, rel, what):
    """Hold a long-shape output row by row at ``rel`` times the row's
    largest |value| (a row is one (batch, query, head) of D values).  Its
    outputs average thousands of V rows and are far below the path's
    shapes' atol, so an absolute 2e-2 would pass a kernel that drops or
    repeats a whole kv tile; this bound passes a bf16 rounding flip (at
    most 2^-7 of a value) and fails such a tile."""
    err = float((got.float() - want.float()).abs().max())
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{what}: output {got.dtype} {tuple(got.shape)}")
    check(_rows_within(torch, got, want, rel),
          f"{what}: kernel vs plain max |diff| {err:.3e} beyond {rel} of "
          "its row's largest value")
    return err


def _rows_within(torch, got, want, rel):
    w = want.float()
    bound = rel * w.abs().amax(dim=-1, keepdim=True)
    return bool(((got.float() - w).abs() <= bound).all())


def _tile_fault_caught(torch, plain, q, k, v, want, rel, tile, **kw):
    """The plain version over K/V whose kv tile ``tile`` (128 rows) holds
    a copy of the tile before it (a kernel that repeats one tile and
    skips the next) must fall outside the row tolerance."""
    lo = tile * 128
    kb, vb = k.clone(), v.clone()
    kb[:, lo:lo + 128], vb[:, lo:lo + 128] = k[:, lo - 128:lo], \
        v[:, lo - 128:lo]
    bad = plain(q, kb, vb, **kw)
    return not _rows_within(torch, bad, want, rel)


def _k5_grid(torch, gen):
    """K5 against its plain version over GQA groups (up to the largest it
    takes), head dims (one not a multiple of 16), query counts and cache
    tails, on both of its paths: bf16 q (tensor cores) and fp32 q (CUDA
    cores)."""
    from repro_torch.kernels import ops, ref
    n, worst = 0, 0.0
    for groups in (1, 2, 4, 64):
        for d in (64, 100, 128):
            for sq in (1, 17, 32, 100):
                for skv in (sq, sq + 27):
                    for q_dt, kv_dt, tol in (
                            (torch.bfloat16, torch.int8, 2e-2),
                            (torch.bfloat16, torch.bfloat16, 2e-2),
                            (torch.float32, torch.int8, 1e-4),
                            (torch.float32, torch.float32, 1e-4)):
                        q, k, v, nkv = _dense_qkv(torch, gen, 2, sq, skv,
                                                  2 * groups, 2, d, q_dt,
                                                  kv_dt)
                        got = ops.flash_attention(q, k, v, kv_frac_bits=nkv)
                        want = ref.flash_attention_ref(q, k, v,
                                                       kv_frac_bits=nkv)
                        torch.cuda.synchronize()
                        worst = max(worst, _close(
                            torch, got, want, tol,
                            f"K5 grid G {groups} D {d} Sq {sq} Skv {skv} "
                            f"{q_dt} q {kv_dt} K/V"))
                        n += 1
    return n, worst


def phase_k5(torch, out):
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    h, kvh, d = K1_HEADS, K1_KV_HEADS, K1_DIM
    sdpa, sdpa_how = _sdpa(torch)
    # (name, B, Sq, Skv, q dtype, K/V dtype, tolerance): the classic path's
    # shapes first — the prefill over the int8 max_seq cache (bf16 model,
    # fp32 model phase) and the calibration forward over its own bf16 K/V
    cases = [("prefill, int8 cache", 4, 32, 48, torch.bfloat16, torch.int8,
              2e-2),
             ("prefill, int8 cache, fp32 q", 4, 32, 48, torch.float32,
              torch.int8, 1e-4),
             ("prefill, bf16 cache", 4, 32, 48, torch.bfloat16,
              torch.bfloat16, 2e-2),
             ("forward, bf16 K/V", 4, 32, 32, torch.bfloat16, torch.bfloat16,
              2e-2),
             ("forward, fp32", 4, 32, 32, torch.float32, torch.float32,
              1e-4),
             ("long prefill", 1, 4096, 4096, torch.bfloat16, torch.bfloat16,
              LONG_ROW_TOL)]
    rows, max_err = [], 0.0
    for name, b, sq, skv, q_dt, kv_dt, tol in cases:
        q, k, v, nkv = _dense_qkv(torch, gen, b, sq, skv, h, kvh, d, q_dt,
                                  kv_dt)
        got = ops.flash_attention(q, k, v, kv_frac_bits=nkv)
        want = ref.flash_attention_ref(q, k, v, kv_frac_bits=nkv)
        torch.cuda.synchronize()
        if sq < 1024:
            err = _close(torch, got, want, tol, f"K5 {name}")
            held = f"atol=rtol={tol}"
        else:
            err = _close_rows(torch, got, want, tol, f"K5 {name}")
            check(_tile_fault_caught(torch, ref.flash_attention_ref, q, k, v,
                                     want, tol, sq // 256, kv_frac_bits=nkv),
                  f"K5 {name}: the row tolerance passes a repeated kv tile")
            held = (f"{tol} of each row's largest |value|, which a repeated "
                    "kv tile fails")
        if q_dt == torch.bfloat16 and kv_dt == torch.int8:
            max_err = max(max_err, err)
        line = (f"[6] K5 {name} (B {b}, Sq {sq}, Skv {skv}, {q_dt} q, "
                f"{kv_dt} K/V): within {held} (max |diff| {err:.2e})")
        if name in ("prefill, int8 cache", "long prefill"):
            iters = 50 if sq < 1024 else 5
            ms = time_ms(torch, lambda: ops.flash_attention(
                q, k, v, kv_frac_bits=nkv), iters)
            plain_ms = time_ms(torch, lambda: ref.flash_attention_ref(
                q, k, v, kv_frac_bits=nkv), 3, warmup=1)
            kf, vf = _deq(torch, k, nkv, q_dt), _deq(torch, v, nkv, q_dt)
            if skv > sq:     # SDPA's is_causal aligns the top-left corner
                kf, vf = kf[:, :sq].contiguous(), vf[:, :sq].contiguous()
            lib = sdpa(q, kf, vf, True).transpose(1, 2)
            check(torch.allclose(lib.float(), want.float(), atol=5e-2,
                                 rtol=5e-2), f"K5 {name}: SDPA disagrees")
            lib_ms = time_ms(torch, lambda: sdpa(q, kf, vf, True), iters)
            kv_rows = b * min(sq, skv)
            n_bytes = (2 * q.numel() * q.element_size()
                       + 2 * kv_rows * kvh * d * k.element_size())
            n_ops = b * h * 4 * d * sum(min(i + 1, skv) for i in range(sq))
            b_ms, b_by = bound_ms(n_bytes, n_ops, "bfloat16")
            rows.append(dict(name=name, b=b, sq=sq, skv=skv, ms=ms,
                             plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                             bytes=n_bytes, ops=n_ops))
            line += (f" | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
                     f"({sdpa_how}) {lib_ms:.4f} ms, bound {b_ms:.5f} ms "
                     f"({b_by})")
        log(line)
    grid_n, grid_err = _k5_grid(torch, gen)
    log(f"[6] K5 grid ({grid_n} cases: GQA 1/2/4/64, D 64/100/128 (100 "
        f"zero-padded), Sq 1/17/32/100 over Skv = Sq and Sq + 27, bf16 q "
        f"(tensor cores) over int8 / bf16 K/V within atol=rtol=2e-2, fp32 q "
        f"over int8 / fp32 K/V within 1e-4): max |diff| {grid_err:.2e}")
    # no kv row at all: l == 0 on every row, written as exactly 0
    q, k, v, nkv = _dense_qkv(torch, gen, 2, 16, 16, h, kvh, d,
                              torch.bfloat16, torch.int8)
    empty = ops.flash_attention(q, k[:, :0], v[:, :0], kv_frac_bits=nkv)
    torch.cuda.synchronize()
    check(int(torch.count_nonzero(empty)) == 0,
          "K5: rows with l == 0 are not exactly 0")
    log("[6] K5 rows with l == 0 (no kv rows) exactly 0")
    res = dict(rows[0], max_abs_err=max_err, long=rows[1], sdpa=sdpa_how,
               grid_cases=grid_n, grid_max_abs_err=grid_err)
    out["k5"] = res
    return res


def _k6_grid(torch, gen):
    """K6 against its plain version over GQA groups (16: two row tiles a
    split), head dims, cache and q types, at positions 0, inside one split, at split boundaries (a full
    last split and a last split of one or two rows) and 32767, each held
    at its type's tolerance and, past 1024 rows, row by row."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import plan_decode_splits
    b, kvh, s_max = 2, 2, 32768
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    positions = (0, 63, 255, 256, 257, 1023, 1024, 1025, s_max - 1)
    splits = [plan_decode_splits(p, b, kvh, sms)[0] for p in positions]
    n, worst = 0, 0.0
    for groups in (1, 2, 4, 16):
        for d in (64, 128):
            for q_dt, kv_dt, tol in ((torch.bfloat16, torch.int8, 2e-2),
                                     (torch.bfloat16, torch.bfloat16, 2e-2),
                                     (torch.float32, torch.int8, 1e-4),
                                     (torch.float32, torch.float32, 1e-4)):
                q, k, v, nkv = _dense_qkv(torch, gen, b, 1, s_max,
                                          kvh * groups, kvh, d, q_dt, kv_dt)
                for pos in positions:
                    got = ops.flash_decode(q, k, v, pos=pos, kv_frac_bits=nkv)
                    want = ref.flash_decode_ref(q, k, v, pos=pos,
                                                kv_frac_bits=nkv)
                    torch.cuda.synchronize()
                    what = (f"K6 grid G {groups} D {d} {q_dt} q {kv_dt} "
                            f"cache pos {pos}")
                    worst = max(worst, _close(torch, got, want, tol, what))
                    if pos >= 1024:
                        _close_rows(torch, got, want, LONG_ROW_TOL, what)
                    n += 1
                del q, k, v
    return n, worst, dict(zip(positions, splits))


def phase_k6(torch, out):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import plan_decode_splits
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    h, kvh, d = K1_HEADS, K1_KV_HEADS, K1_DIM
    sdpa, sdpa_how = _sdpa(torch)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid_n, grid_err, grid_splits = _k6_grid(torch, gen)
    log(f"[7] K6 grid ({grid_n} cases: GQA 1/2/4/16, D 64/128, bf16 q over "
        f"int8 / bf16 caches within atol=rtol=2e-2, fp32 q over int8 / fp32 "
        f"within 1e-4, from 1024 rows also within {LONG_ROW_TOL} of each "
        f"row's largest |value|; B 2, KVH 2, splits by position "
        f"{grid_splits}): max |diff| {grid_err:.2e}")
    cases = [("int8 cache", 4, 48, torch.bfloat16, torch.int8, 2e-2,
              (0, 15, 32, 47)),
             ("int8 cache, fp32 q", 4, 48, torch.float32, torch.int8, 1e-4,
              (0, 15, 32, 47)),
             ("bf16 cache", 4, 48, torch.bfloat16, torch.bfloat16, 2e-2,
              (0, 15, 32, 47)),
             ("long int8 cache", 4, 32768, torch.bfloat16, torch.int8,
              LONG_ROW_TOL, (32767,))]
    rows, max_err = [], 0.0
    for name, b, s_max, q_dt, kv_dt, tol, positions in cases:
        q, k, v, nkv = _dense_qkv(torch, gen, b, 1, s_max, h, kvh, d, q_dt,
                                  kv_dt)
        errs = []
        for pos in positions:
            got = ops.flash_decode(q, k, v, pos=pos, kv_frac_bits=nkv)
            want = ref.flash_decode_ref(q, k, v, pos=pos, kv_frac_bits=nkv)
            torch.cuda.synchronize()
            if s_max < 1024:
                errs.append(_close(torch, got, want, tol,
                                   f"K6 {name} pos {pos}"))
                held = f"atol=rtol={tol}"
            else:
                errs.append(_close_rows(torch, got, want, tol,
                                        f"K6 {name} pos {pos}"))
                check(_tile_fault_caught(torch, ref.flash_decode_ref, q, k, v,
                                         want, tol, pos // 256, pos=pos,
                                         kv_frac_bits=nkv),
                      f"K6 {name}: the row tolerance passes a repeated kv "
                      "tile")
                held = (f"{tol} of each row's largest |value|, which a "
                        "repeated kv tile fails")
        # the kernels line reports the error at the path's shape
        if q_dt == torch.bfloat16 and kv_dt == torch.int8 and s_max < 1024:
            max_err = max(max_err, *errs)
        line = (f"[7] K6 {name} (B {b}, S_max {s_max}, {q_dt} q, {kv_dt} "
                f"cache), pos {list(positions)}: within {held} "
                f"(max |diff| {max(errs):.2e})")
        if kv_dt == torch.int8 and q_dt == torch.bfloat16:
            pos = positions[-1]
            ms = time_ms(torch, lambda: ops.flash_decode(
                q, k, v, pos=pos, kv_frac_bits=nkv), 50)
            plain_ms = time_ms(torch, lambda: ref.flash_decode_ref(
                q, k, v, pos=pos, kv_frac_bits=nkv), 5, warmup=1)
            kf = _deq(torch, k[:, :pos + 1], nkv, q_dt).contiguous()
            vf = _deq(torch, v[:, :pos + 1], nkv, q_dt).contiguous()
            lib_ms = time_ms(torch, lambda: sdpa(q, kf, vf, False), 50)
            n_bytes = (2 * q.numel() * q.element_size()
                       + 2 * b * (pos + 1) * kvh * d * k.element_size())
            n_ops = b * h * 4 * d * (pos + 1)
            b_ms, b_by = bound_ms(n_bytes, n_ops, "bfloat16")
            n_splits, chunk = plan_decode_splits(pos, b, kvh, sms)
            rows.append(dict(name=name, b=b, s_max=s_max, pos=pos, ms=ms,
                             splits=n_splits, chunk=chunk,
                             plain_ms=plain_ms, library_ms=lib_ms,
                             max_abs_err=max(errs),
                             bound_ms=b_ms, bound_by=b_by, bytes=n_bytes,
                             ops=n_ops))
            line += (f" | at pos {pos}: {n_splits} split(s) of {chunk} "
                     f"rows, kernel {ms:.4f} ms, plain "
                     f"{plain_ms:.4f} ms, SDPA ({sdpa_how}) {lib_ms:.4f} ms, "
                     f"bound {b_ms:.5f} ms ({b_by})")
        log(line)
        del q, k, v
    res = dict(rows[0], max_abs_err=max_err, long=rows[1], sdpa=sdpa_how,
               grid_cases=grid_n, grid_max_abs_err=grid_err,
               grid_splits=grid_splits)
    out["k6"] = res
    return res


# ---------------------------------------------------------------------------
# phases 8 and 9: calibration and the dense model, card against CPU
# ---------------------------------------------------------------------------

SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 32, 16


def _serve_tokens(vocab):
    """The classic path's prompt batch (``launch.serve.serve``'s draw)."""
    from repro_torch.data import SyntheticLMStream
    return SyntheticLMStream(vocab, SERVE_PROMPT, SERVE_BATCH,
                             seed=0).batch(0)["tokens"]


def phase_calibrate(torch, out):
    """Algorithm 1 on the card and on the CPU from the same weights and
    batch.  Tolerance: the fp32 products and attention sums run in other
    orders on the two devices, so a module whose best two candidates'
    errors nearly tie may pick differently; that is accepted only where
    the two chosen errors agree within 1e-4 relative."""
    from repro_torch.configs import get_config
    from repro_torch.core.lm_calibrate import calibrate_lm
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config("qwen3_1_7b"), n_layers=2,
                              dtype="float32", kv_cache_bits=8,
                              attn_kernel="flash")
    p_cpu = M.init_params(cfg, 0, device="cpu")
    p_gpu = _tree_to(p_cpu, "cuda")
    tokens = torch.from_numpy(_serve_tokens(cfg.vocab_size))
    res = {}
    for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
        t0 = time.perf_counter()
        ctx, rep = calibrate_lm(lambda p, b, c: M.forward(p, b, cfg, c),
                                params, {"tokens": tokens.to(dev)})
        if dev == "cuda":
            torch.cuda.synchronize()
        res[dev] = (ctx, rep, time.perf_counter() - t0)
    (cg, rg, tg), (cc, rc, tc) = res["cuda"], res["cpu"]
    check(list(cg.table) == list(cc.table), "calibration: module lists")
    ties = []
    for name in cc.table:
        a, b = cg.table[name], cc.table[name]
        if a == b:
            continue
        eg, ec = rg.results[name].error, rc.results[name].error
        rel = abs(eg - ec) / max(ec, 1e-30)
        log(f"[8] calibration {name}: card {a} error {eg!r}, CPU {b} error "
            f"{ec!r} (relative {rel:.2e})")
        check(rel <= 1e-4, f"calibration {name}: card and CPU choose "
              f"differently and their errors differ by {rel:.2e}")
        ties.append(name)
    log(f"[8] calibration ({len(cc.table)} modules, qwen3-1.7B full width, "
        f"2 layers, fp32, {SERVE_BATCH}x{SERVE_PROMPT} tokens): tables "
        f"{'identical' if not ties else f'identical apart from near-ties {ties}'}"
        f"; card {tg:.2f} s, CPU {tc:.2f} s")
    out["calibration"] = dict(card_s=tg, cpu_s=tc, near_ties=ties,
                              table={k: dataclasses.astuple(v)
                                     for k, v in cc.table.items()})
    return cfg, p_cpu, p_gpu, cc


def phase_dense_model(torch, out, cfg, p_cpu, p_gpu, cal_ctx):
    """prefill + 3 decode steps, both devices fed the same tokens (the
    CPU's greedy choices), in three cases.  Tolerances:

    * INT mode, int8 cache: logits and every cache code identical, as
      phase 4 found for the ragged path (every run so far agreed).
    * FP mode, fp32 cache: phase 4's FP rule, logits within
      atol=rtol=1e-3 in at least 99.9% of entries, all within 5e-2.  No
      code can flip here, so only the fp32 summation orders differ.
    * FP mode, int8 cache: the card and the CPU sum fp32 products and
      softmaxes in different orders, so a K/V value within an ulp of a
      rounding boundary may take the neighbouring code (on an H100, 112
      of the 2x35-position cache's codes come out one step apart), and
      each flipped code moves every later logit of its sequence by about
      1e-3.  So here: every code within one step of the CPU's, at most
      0.1% differing, and logits all within 5e-2; the 1e-3 share is
      printed.  The fp32-cache case shows the rest of the path holds the
      tighter rule."""
    from repro_torch.core.qmodel import QuantMode, quantize_weight_tree
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M
    tokens = torch.from_numpy(_serve_tokens(cfg.vocab_size))
    max_seq = SERVE_PROMPT + SERVE_GEN
    res = {}
    for mode, kv_bits in (("int", 8), ("fp", None), ("fp", 8)):
        ctx = dataclasses.replace(cal_ctx, mode=QuantMode(mode))
        ccfg = dataclasses.replace(cfg, kv_cache_bits=kv_bits)
        case = f"{mode}, {'int8' if kv_bits else 'fp32'} cache"
        pc, pg = p_cpu, p_gpu
        if ctx.mode is QuantMode.INT:
            pc, pg = quantize_weight_tree(p_cpu, ctx), \
                quantize_weight_tree(p_gpu, ctx)
        prefill = S.build_prefill_step(ccfg, ctx, max_seq=max_seq)
        logits, caches, fed = {}, {}, []
        for dev, params in (("cpu", pc), ("cuda", pg)):
            ops.reset_launch_counts()
            with torch.no_grad():
                lg, cache = prefill(params, {"tokens": tokens.to(dev)})
                seq = [lg.float().cpu()]
                for i in range(3):
                    if dev == "cpu":      # the CPU's greedy token, fed to both
                        fed.append(torch.argmax(seq[-1], -1).to(
                            torch.int32)[:, None])
                    lg, cache = M.decode_step(params, fed[i].to(dev), cache,
                                              SERVE_PROMPT + i, ccfg, ctx)
                    seq.append(lg.float().cpu())
            logits[dev], caches[dev] = seq, cache
            launches = dict(ops.LAUNCHES)
        check(launches["flash_prefill"] == cfg.n_layers
              and launches["flash_decode"] == cfg.n_layers * 3,
              f"dense model {case}: K5/K6 launched "
              f"{launches['flash_prefill']}/{launches['flash_decode']} times, "
              f"want {cfg.n_layers}/{cfg.n_layers * 3}")
        worst_frac = worst_max = 0.0
        for a, b in zip(logits["cuda"], logits["cpu"]):
            check(bool(torch.isfinite(a).all()) and a.shape == b.shape,
                  f"dense model {case}: non-finite or misshapen logits")
            diff = (a - b).abs()
            frac = float(((diff > 0) if mode == "int" else
                          (diff > 1e-3 + 1e-3 * b.abs())).float().mean())
            worst_frac, worst_max = max(worst_frac, frac), \
                max(worst_max, float(diff.max()))
        codes = []                  # (k/v, layer, entries differing, max diff)
        for name, a, b in zip("kv", caches["cuda"]["kv"], caches["cpu"]["kv"]):
            dd = (a.cpu().double() - b.double()).abs()
            codes += [(name, layer, int((dd[layer] > 0).sum()),
                       float(dd[layer].max())) for layer in range(cfg.n_layers)]
        n_codes = 2 * caches["cpu"]["kv"].k.numel()
        identical = worst_max == 0 and not any(c[2] for c in codes)
        log(f"[9] dense model {case} (prefill {SERVE_BATCH}x{SERVE_PROMPT} + "
            f"3 decode steps, 2 layers, full width, fp32, flash): logits max "
            f"|diff| {worst_max:.3e}, {worst_frac:.2e} of entries "
            f"{'differ' if mode == 'int' else 'beyond 1e-3'}; cache entries "
            f"differing (k/v, layer, count, max |diff|) {codes} of "
            f"{n_codes // 4} a layer; launches K5 {launches['flash_prefill']} "
            f"K6 {launches['flash_decode']}"
            + ("; identical" if identical else ""))
        if mode == "int":
            check(identical, f"dense model {case}: card and CPU differ "
                  f"(logits max {worst_max}, cache {codes})")
        elif kv_bits is None:
            check(worst_frac <= 1e-3 and worst_max <= 5e-2,
                  f"dense model {case}: logits beyond 1e-3 in "
                  f"{worst_frac:.2e} of entries, max {worst_max}")
        else:
            check(max(c[3] for c in codes) <= 1
                  and sum(c[2] for c in codes) <= 1e-3 * n_codes,
                  f"dense model {case}: cache codes differ {codes}")
            check(worst_max <= 5e-2, f"dense model {case}: logits differ by "
                  f"up to {worst_max}")
        res[case] = dict(logits_max_abs=worst_max, logits_frac=worst_frac,
                         cache_diff=codes, launches=launches)
    out["dense_model"] = res
    return res


# ---------------------------------------------------------------------------
# phases 10 and 11: classic serve and the W8A8 engine at full depth
# ---------------------------------------------------------------------------

def phase_serve(torch, out):
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    cfg = get_config("qwen3_1_7b")
    L, steps = cfg.n_layers, SERVE_GEN - 1
    want = {"int": {"flash_prefill": 2 * L, "flash_decode": L * steps,
                    "int8_matmul": (7 * L + 1) * SERVE_GEN,
                    "ragged_attention": 0, "paged_attention": 0,
                    "quantize": 0, "residual_requant": 0},
            "fp": {"flash_prefill": L, "flash_decode": L * steps,
                   "int8_matmul": 0, "ragged_attention": 0,
                   "paged_attention": 0, "quantize": 0,
                   "residual_requant": 0}}
    res = {}
    for mode, overrides in (("int", {"kv_cache_bits": 8}), ("fp", None)):
        runs = []
        for rep in range(2):
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            o = serve("qwen3_1_7b", batch=SERVE_BATCH,
                      prompt_len=SERVE_PROMPT, gen=SERVE_GEN, mode=mode,
                      calibrate=True, smoke=False, attn_kernel="flash",
                      cfg_overrides=overrides, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(ops.LAUNCHES)
            peak = torch.cuda.max_memory_allocated() / 2**30
            toks = o["tokens"]
            log(f"[10] serve {mode} run {rep}: tokens {toks.shape}, prefill "
                f"{o['prefill_s']:.4f} s, decode "
                f"{1e3 * o['decode_s_per_tok']:.2f} ms/token (first step "
                f"{1e3 * o['compile_decode_s']:.2f} ms), launches K5 "
                f"{launches['flash_prefill']} K6 {launches['flash_decode']} "
                f"K2 {launches['int8_matmul']}, peak {peak:.2f} GiB, "
                f"{wall:.1f} s")
            check(toks.shape == (SERVE_BATCH, SERVE_GEN)
                  and int(toks.min()) >= 0
                  and int(toks.max()) < cfg.vocab_size,
                  f"serve {mode}: tokens {toks}")
            check(launches == want[mode], f"serve {mode}: launches "
                  f"{launches}, want {want[mode]}")
            runs.append(dict(tokens=toks, launches=launches,
                             prefill_s=o["prefill_s"],
                             decode_s_per_tok=o["decode_s_per_tok"],
                             first_decode_s=o["compile_decode_s"],
                             peak_gib=peak, wall_s=wall))
            del o
            torch.cuda.empty_cache()
        check((runs[0]["tokens"] == runs[1]["tokens"]).all(),
              f"serve {mode}: a repeated greedy run gave other tokens")
        log(f"[10] serve {mode}: repeat run token-identical")
        res[mode] = runs
    out["serve"] = res
    return res


def phase_w8a8(torch, out):
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_engine
    cfg = get_config("qwen3_1_7b")
    runs = []
    for rep in range(2):
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        o = serve_engine("qwen3_1_7b", smoke=False, w8a8=True,
                         n_requests=8, n_slots=4, rate=1e9, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        r = o["report"]
        steps = r["ragged_steps"]
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[11] w8a8 engine run {rep}: {r['completed']} requests, "
            f"{r['gen_tokens']} tokens, {r['tokens_per_s']} tok/s, {steps} "
            f"ragged steps, launches K1 {launches['ragged_attention']} K2 "
            f"{launches['int8_matmul']}, TTFT p50 {r['ttft_s']['p50']:.4f} "
            f"s, TPOT p50 {r['tpot_s']['p50']:.4f} s, "
            f"{len(o['quantized'].converted)} weight tensors as int8 codes, "
            f"peak {peak:.2f} GiB, {wall:.1f} s")
        check(r["completed"] == 8, "w8a8 engine: not all done")
        check(launches["ragged_attention"] == cfg.n_layers * steps
              and launches["int8_matmul"] == (7 * cfg.n_layers + 1) * steps
              and r["kernel_launches"] == {
                  k: launches[k] for k in r["kernel_launches"]},
              f"w8a8 engine: launches {launches} over {steps} steps")
        check(len(o["quantized"].converted) == 7 * cfg.n_layers + 1,
              "w8a8 engine: not every matmul weight is int8 codes")
        runs.append((o["outputs"], launches, r, peak, wall))
        del o
        torch.cuda.empty_cache()
    (a, *_), (b, *_) = runs
    check(sorted(a) == sorted(b)
          and all(len(a[k]) == len(b[k]) and (a[k] == b[k]).all() for k in a),
          "w8a8 engine: a repeated greedy run gave other tokens")
    log("[11] w8a8 engine: repeat run token-identical")
    res = dict(launches=runs[0][1], report=runs[0][2], peak_gib=runs[0][3],
               wall_s=runs[0][4], report_repeat=runs[1][2])
    out["w8a8_engine"] = res
    return res


# ---------------------------------------------------------------------------
# phases 12-14: the paper's ResNet path (K3, K7, K2 on uint8 activations)
# ---------------------------------------------------------------------------

def _resnet_shapes(cfg, batch):
    """The integer forward's shapes at ``batch``: the image, the head's
    input, each residual add's (shape, branch dtype, shortcut dtype) and
    each convolution's im2col product (M, K, N, activation dtype)."""
    import torch
    side, adds, convs = cfg.img_size, [], []
    convs.append((batch * side * side, 27, cfg.stages[0], torch.int8))
    cin = cfg.stages[0]
    for si, ch in enumerate(cfg.stages):
        for bi in range(cfg.blocks_per_stage):
            stride = 2 if (bi == 0 and si > 0) else 1
            side_o = -(-side // stride)
            m = batch * side_o * side_o
            convs += [(m, 9 * cin, ch, torch.uint8), (m, 9 * ch, ch,
                                                      torch.uint8)]
            if cin != ch:
                convs.append((m, cin, ch, torch.uint8))
            adds.append(((batch, side_o, side_o, ch), torch.int8,
                         torch.int8 if cin != ch else torch.uint8))
            side, cin = side_o, ch
    convs.append((batch, cfg.stages[-1], cfg.n_classes, torch.int8))
    return ((batch, cfg.img_size, cfg.img_size, 3), (batch, cfg.stages[-1]),
            adds, convs)


def _exact(got, want, what) -> int:
    """The largest code difference of a kernel against its plain version,
    which must be 0 with the same output type."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{what}: output {got.dtype} {tuple(got.shape)}, plain "
          f"{want.dtype} {tuple(want.shape)}")
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    check(err == 0, f"{what}: kernel != plain (max |diff| {err})")
    return err


def _codes(torch, gen, shape, dtype):
    lo, hi = (0, 256) if dtype == torch.uint8 else (-128, 128)
    return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                         dtype=torch.int32).to(dtype)


def phase_cnn_kernels(torch, out):
    """K3 and K7 bit-exact against their plain versions at the ResNet
    path's shapes (and misaligned views, which take the scalar loop) and
    at one 64M-element shape; K2 on uint8 activations bit-exact at every
    im2col shape of the path.  Times per forward at batch 256 sum the
    path's launches, each shape timed alone."""
    from repro_torch.configs.resnet_paper import CONFIG
    from repro_torch.core.integer_ops import LinearQuantSpec
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.int8_matmul import plan_int8_matmul
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    img, head_in, adds, convs = _resnet_shapes(CONFIG, RESNET_BATCH)
    res = {}

    # K3: the image (fp32 in [0, 1) on the 2^-7 grid, as the path's n_in)
    # and the pooled head input, plus .5 ties on the grid and bf16 input
    def k3_case(shape, n, dtype=torch.float32):
        x = torch.rand(shape, generator=gen, device="cuda") * 1.7
        flat = x.view(-1)
        k = min(flat.numel(), 4096)
        flat[:k] = (torch.randint(-300, 300, (k,), generator=gen,
                                  device="cuda") + 0.5) * 2.0 ** -n
        return x.to(dtype)

    k3 = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0, "shapes": [],
          "max_abs_err": 0}
    for name, shape, n in (("image", img, 7), ("head input", head_in, 5)):
        x = k3_case(shape, n)
        for bits, uns, dt in ((8, False, torch.float32),
                              (8, True, torch.float32),
                              (12, False, torch.float32),
                              (8, False, torch.bfloat16)):
            xx = x.to(dt)
            for v in (xx, xx.view(-1)[1:]):
                k3["max_abs_err"] = max(k3["max_abs_err"], _exact(
                    ops.quantize_act(v, n, bits, uns),
                    ref.quantize_ref(v, n=n, bits=bits, unsigned=uns),
                    f"K3 {name} {tuple(v.shape)} bits {bits} unsigned "
                    f"{uns} {dt}"))
        ms = time_ms(torch, lambda: ops.quantize_act(x, n, 8), 50)
        plain_ms = time_ms(torch, lambda: ref.quantize_ref(x, n=n), 20)
        n_bytes, n_ops = 5 * x.numel(), 4 * x.numel()
        b_ms, b_by = bound_ms(n_bytes, n_ops, "float32")
        k3["ms"] += ms
        k3["plain_ms"] += plain_ms
        k3["bytes"] += n_bytes
        k3["ops"] += n_ops
        k3["shapes"].append(dict(name=name, shape=list(shape), ms=ms,
                                 plain_ms=plain_ms, bound_ms=b_ms))
        log(f"[12] K3 {name} {tuple(shape)} fp32 -> int8: bit-exact (also "
            f"uint8, 12 bits, bf16, a misaligned view) | kernel {ms:.4f} ms,"
            f" plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    k3["bound_ms"], k3["bound_by"] = bound_ms(k3["bytes"], k3["ops"],
                                              "float32")
    x = k3_case((ELEMWISE_LONG,), 5)
    _exact(ops.quantize_act(x, 5, 8), ref.quantize_ref(x, n=5), "K3 long")
    ms = time_ms(torch, lambda: ops.quantize_act(x, 5, 8), 10)
    plain_ms = time_ms(torch, lambda: ref.quantize_ref(x, n=5), 3, warmup=1)
    b_ms, b_by = bound_ms(5 * x.numel(), 4 * x.numel(), "float32")
    k3["long"] = dict(elements=x.numel(), ms=ms, plain_ms=plain_ms,
                      bound_ms=b_ms, bound_by=b_by)
    log(f"[12] K3 {x.numel()} fp32 -> int8: bit-exact | kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    log(f"[12] K3 one forward (2 launches): kernel {k3['ms']:.4f} ms, plain "
        f"{k3['plain_ms']:.4f} ms, bound {k3['bound_ms']:.5f} ms")
    del x
    res["k3"] = k3

    # K7: each add's shapes and operand dtypes, both semantics, the
    # path's grids and an overflowing negative shift; then one long shape
    k7 = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0, "shapes": [],
          "max_abs_err": 0}
    grids = ((7, 6, 7), (6, 7, 6), (0, 20, 30))
    for i, (shape, da, db) in enumerate(adds):
        a, b = _codes(torch, gen, shape, da), _codes(torch, gen, shape, db)
        for grid in grids:
            for relu in (True, False):
                for sat in (True, False):
                    kw = dict(n_a=grid[0], n_b=grid[1], n_o=grid[2],
                              relu=relu, saturate=sat)
                    for aa, bb in ((a, b), (a.view(-1)[1:], b.view(-1)[1:])):
                        k7["max_abs_err"] = max(k7["max_abs_err"], _exact(
                            ops.residual_requant(aa, bb, **kw),
                            ref.residual_requant_ref(aa, bb, **kw),
                            f"K7 add {i} {tuple(aa.shape)} {grid} relu "
                            f"{relu} saturate {sat}"))
        kw = dict(n_a=7, n_b=6, n_o=7, relu=True, saturate=True)
        ms = time_ms(torch, lambda: ops.residual_requant(a, b, **kw), 50)
        plain_ms = time_ms(torch, lambda: ref.residual_requant_ref(a, b, **kw),
                           20)
        n_bytes, n_ops = 3 * a.numel(), 10 * a.numel()
        k7["ms"] += ms
        k7["plain_ms"] += plain_ms
        k7["bytes"] += n_bytes
        k7["ops"] += n_ops
        k7["shapes"].append(dict(shape=list(shape), a=str(da), b=str(db),
                                 ms=ms, plain_ms=plain_ms))
        log(f"[12] K7 add {i} {tuple(shape)} {str(da)[6:]} + {str(db)[6:]}: "
            f"bit-exact (grids {list(grids)}, ReLU on/off, both left-shift "
            f"semantics, misaligned) | kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms")
    k7["bound_ms"], k7["bound_by"] = bound_ms(k7["bytes"], k7["ops"],
                                              "float32")
    a = _codes(torch, gen, (ELEMWISE_LONG,), torch.int8)
    b = _codes(torch, gen, (ELEMWISE_LONG,), torch.uint8)
    kw = dict(n_a=7, n_b=6, n_o=7, relu=True, saturate=True)
    _exact(ops.residual_requant(a, b, **kw),
           ref.residual_requant_ref(a, b, **kw), "K7 long")
    ms = time_ms(torch, lambda: ops.residual_requant(a, b, **kw), 10)
    plain_ms = time_ms(torch, lambda: ref.residual_requant_ref(a, b, **kw), 3,
                       warmup=1)
    b_ms, b_by = bound_ms(3 * a.numel(), 10 * a.numel(), "float32")
    k7["long"] = dict(elements=a.numel(), ms=ms, plain_ms=plain_ms,
                      bound_ms=b_ms, bound_by=b_by)
    log(f"[12] K7 {a.numel()} int8 + uint8: bit-exact | kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    log(f"[12] K7 one forward (6 launches): kernel {k7['ms']:.4f} ms, plain "
        f"{k7['plain_ms']:.4f} ms, bound {k7['bound_ms']:.5f} ms "
        f"({k7['bound_by']}, {k7['bytes'] / 1e6:.1f} MB)")
    del a, b
    res["k7"] = k7

    # K2 at every im2col product of the path (uint8 activations after the
    # stem), both epilogue signs
    k2 = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0, "shapes": []}
    for m, k, n, xdt in convs:
        x = _codes(torch, gen, (m, k), xdt)
        w = _codes(torch, gen, (k, n), torch.int8)
        bias = _codes(torch, gen, (n,), torch.int8)
        for relu, spec in ((True, LinearQuantSpec(n_x=7, n_w=8, n_b=9, n_o=6,
                                                  out_unsigned=True)),
                           (False, LinearQuantSpec(n_x=6, n_w=9, n_b=8,
                                                   n_o=7))):
            _exact(ops.int8_matmul(x, w, bias, spec, relu=relu),
                   ref.int8_matmul_ref(
                       x, w, bias, shift=spec.requant_shift,
                       bias_shift=spec.bias_shift, relu=relu,
                       lo=0 if relu else -128, hi=255 if relu else 127,
                       out_dtype=torch.uint8 if relu else torch.int8),
                   f"K2 M={m} K={k} N={n} {xdt} relu {relu}")
        ms = time_ms(torch, lambda: ops.int8_matmul(x, w, bias, spec), 20)
        plain_ms = time_ms(torch, lambda: ref.int8_matmul_ref(
            x, w, bias, shift=spec.requant_shift,
            bias_shift=spec.bias_shift), 5, warmup=1)
        n_bytes, n_ops = m * k + k * n + n + m * n, 2 * m * k * n
        b_ms, b_by = bound_ms(n_bytes, n_ops, "int8")
        k2["ms"] += ms
        k2["plain_ms"] += plain_ms
        k2["bytes"] += n_bytes
        k2["ops"] += n_ops
        k2["shapes"].append(dict(m=m, k=k, n=n, x=str(xdt), ms=ms,
                                 plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by))
        plan = plan_int8_matmul(m, k, n, sms)
        k2["shapes"][-1].update(tile=[plan.bm, plan.bn], splits=plan.splits)
        log(f"[12] K2 conv M={m:<6} K={k:<3} N={n:<2} {str(xdt)[6:]:5}: "
            f"bit-exact, {_plan_str(plan)} | kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
        del x
    k2["bound_ms"], k2["bound_by"] = bound_ms(k2["bytes"], k2["ops"], "int8")
    log(f"[12] K2 one forward ({len(convs)} launches): kernel "
        f"{k2['ms']:.4f} ms, plain {k2['plain_ms']:.4f} ms, bound "
        f"{k2['bound_ms']:.5f} ms ({k2['bound_by']}, "
        f"{k2['bytes'] / 1e6:.1f} MB)")
    res["k2_conv"] = k2
    out["cnn_kernels"] = res
    return res


def _resnet_images(cfg, batch):
    import numpy as np
    return np.random.default_rng(13).uniform(
        0, 1, size=(batch, cfg.img_size, cfg.img_size, 3)).astype(np.float32)


def phase_resnet_calibrate(torch, out):
    """Algorithm 1 on the card and on the CPU from the same weights and
    images, with phase 8's near-tie rule: the card's cuDNN and the CPU's
    convolutions sum in other orders, so a module whose best candidates
    nearly tie may pick differently; that is accepted only where the two
    chosen errors agree within 1e-4 relative."""
    from repro_torch.configs.resnet_paper import CONFIG
    from repro_torch.models import resnet as R
    gen = torch.Generator()
    gen.manual_seed(0)
    p_cpu = R.init_resnet(CONFIG, generator=gen, device="cpu")
    p_gpu = _tree_to(p_cpu, "cuda")
    x = torch.from_numpy(_resnet_images(CONFIG, RESNET_CALIB_BATCH))
    res = {}
    for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
        t0 = time.perf_counter()
        q = R.quantize_resnet(params, x.to(dev), CONFIG)
        if dev == "cuda":
            torch.cuda.synchronize()
        res[dev] = (q, time.perf_counter() - t0)
    (qg, tg), (qc, tc) = res["cuda"], res["cpu"]
    check(list(qg.specs) == list(qc.specs), "resnet calibration: modules")
    ties = []
    for name in qc.specs:
        if qg.specs[name] == qc.specs[name]:
            continue
        eg = qg.report.results[name].error
        ec = qc.report.results[name].error
        rel = abs(eg - ec) / max(ec, 1e-30)
        log(f"[13] calibration {name}: card {qg.specs[name]} error {eg!r}, "
            f"CPU {qc.specs[name]} error {ec!r} (relative {rel:.2e})")
        check(rel <= 1e-4, f"resnet calibration {name}: card and CPU choose "
              f"differently and their errors differ by {rel:.2e}")
        ties.append(name)
    log(f"[13] ResNet calibration ({len(qc.specs)} modules, CONFIG width, "
        f"batch {RESNET_CALIB_BATCH}): tables "
        f"{'identical' if not ties else f'identical apart from near-ties {ties}'}"
        f"; card {tg:.2f} s, CPU {tc:.2f} s")
    out["resnet_calibration"] = dict(
        card_s=tg, cpu_s=tc, near_ties=ties,
        table={k: v if isinstance(v, tuple) else dataclasses.astuple(v)
               for k, v in qc.specs.items()})
    return qg


def phase_resnet_forward(torch, out, q_gpu):
    """The card's calibration artifact, run by the integer forward on the
    card (the kernels) and by the CPU's plain path: every integer op is
    exact, so the logits must be identical.  Two card runs, each with the
    launch counts reset just before and read just after."""
    from repro_torch.configs.resnet_paper import CONFIG
    from repro_torch.kernels import ops
    from repro_torch.models import resnet as R
    x = torch.from_numpy(_resnet_images(CONFIG, RESNET_BATCH))
    q_cpu = R.QuantizedResNet(
        weights={k: v.cpu() for k, v in q_gpu.weights.items()},
        biases={k: v.cpu() for k, v in q_gpu.biases.items()},
        specs=q_gpu.specs, report=q_gpu.report, n_in=q_gpu.n_in)
    t0 = time.perf_counter()
    want = R.resnet_int_forward(q_cpu, x, CONFIG)
    cpu_s = time.perf_counter() - t0
    xg = x.cuda()
    want_launches = {"int8_matmul": 16, "residual_requant": 6, "quantize": 2,
                     "ragged_attention": 0, "paged_attention": 0,
                     "flash_prefill": 0, "flash_decode": 0}
    runs = []
    for rep in range(2):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits = R.resnet_int_forward(q_gpu, xg, CONFIG)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        got = logits.cpu()
        check(got.shape == (RESNET_BATCH, CONFIG.n_classes)
              and bool(torch.isfinite(got).all()),
              f"resnet forward: logits {tuple(got.shape)} not finite")
        check(torch.equal(got, want), f"resnet forward run {rep}: card "
              f"logits differ from the CPU's (max |diff| "
              f"{float((got - want).abs().max())})")
        check(launches == want_launches,
              f"resnet forward: launches {launches}, want {want_launches}")
        runs.append(dict(logits=got, launches=launches, wall_s=wall,
                         images_per_s=RESNET_BATCH / wall))
        log(f"[14] ResNet int forward run {rep} (CONFIG, batch "
            f"{RESNET_BATCH}): logits identical to the CPU's; launches K2 "
            f"{launches['int8_matmul']} K7 {launches['residual_requant']} K3 "
            f"{launches['quantize']}; {wall * 1e3:.2f} ms, "
            f"{RESNET_BATCH / wall:.1f} images/s (CPU plain path "
            f"{cpu_s:.2f} s, {RESNET_BATCH / cpu_s:.1f} images/s)")
    check(torch.equal(runs[0]["logits"], runs[1]["logits"]),
          "resnet forward: a repeated run gave other logits")
    log("[14] ResNet int forward: repeat run identical")
    res = dict(launches=runs[0]["launches"], cpu_s=cpu_s,
               runs=[{k: v for k, v in r.items() if k != "logits"}
                     for r in runs])
    out["resnet_forward"] = res
    return res


# ---------------------------------------------------------------------------
# phases 15-17: the legacy per-shape engine and speculative decoding (K4)
# ---------------------------------------------------------------------------

def _k4_case(torch, gen, b, c, h, kvh, d, bs, nbmax, last, q_dt, kv_dt,
             spec=False, padded_slot=None):
    """q (B, C, H, D) at positions ``last[b] - C + 1 .. last[b]`` (floored
    at 0) over a shuffled pool whose tables hold only the blocks a slot's
    positions need, trash after them; ``padded_slot`` gets an all-trash
    table at position 0; with ``spec`` the table has one trash column more
    and the last slot's last query sits on it (a padded draft row)."""
    from repro_torch.core.qscheme import quant
    nb = 1 + b * nbmax
    q = torch.randn((b, c, h, d), generator=gen, device="cuda").to(q_dt)
    kf = torch.randn((nb, bs, kvh, d), generator=gen, device="cuda")
    vf = torch.randn((nb, bs, kvh, d), generator=gen, device="cuda")
    if kv_dt == torch.int8:
        kp, vp = quant(kf, KV_FRAC_BITS), quant(vf, KV_FRAC_BITS)
    else:
        kp, vp = kf.to(kv_dt), vf.to(kv_dt)
    del kf, vf
    perm = (torch.randperm(nb - 1, generator=gen, device="cuda") + 1).to(
        torch.int32).reshape(b, nbmax)
    w = nbmax + 1 if spec else nbmax
    bt = torch.zeros((b, w), dtype=torch.int32, device="cuda")
    pos = torch.zeros((b, c), dtype=torch.int32, device="cuda")
    for i in range(b):
        if i == padded_slot:
            continue
        p = [max(last[i] - c + 1 + j, 0) for j in range(c)]
        pos[i] = torch.tensor(p, dtype=torch.int32)
        live = p[-1] // bs + 1
        bt[i, :live] = perm[i, :live]
    if spec:
        pos[b - 1, -1] = nbmax * bs
    nkv = KV_FRAC_BITS if kv_dt == torch.int8 else None
    return (q, kp, vp, bt, pos), nkv


def _k4_work(args):
    """Bytes K4 must move (q in, out, the kv rows its queries see, tables,
    positions) and its operations (QK and PV), from this case's data."""
    q, kp, vp, bt, pos = args
    b, c, h, d = q.shape
    bs, kvh = kp.shape[1], kp.shape[2]
    seen = (pos.max(dim=1).values.clamp(max=bt.shape[1] * bs - 1) + 1)
    n_bytes = (2 * q.numel() * q.element_size()
               + int(seen.sum()) * kvh * 2 * d * kp.element_size()
               + 4 * (bt.numel() + pos.numel()))
    n_ops = int((pos.clamp(max=bt.shape[1] * bs - 1) + 1).sum()) * h * 4 * d
    return n_bytes, n_ops


def _gather_sdpa(torch, args, nkv, mask, gqa):
    """The yardstick, two calls: gather + dequantize every block the tables
    name, then ``scaled_dot_product_attention`` under ``mask`` (B, 1, C,
    W * bs), True where a kv row is visible: the same function as K4."""
    F = torch.nn.functional
    q, kp, vp, bt, pos = args
    b, c, h, d = q.shape
    w, bs, kvh = bt.shape[1], kp.shape[1], kp.shape[2]
    k = _deq(torch, kp[bt.long()].reshape(b, w * bs, kvh, d), nkv, q.dtype)
    v = _deq(torch, vp[bt.long()].reshape(b, w * bs, kvh, d), nkv, q.dtype)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if gqa:
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)
    g = h // kvh
    return F.scaled_dot_product_attention(
        qt, kt.repeat_interleave(g, 1), vt.repeat_interleave(g, 1),
        attn_mask=mask)


def _table_fault_caught(torch, plain, args, want, rel, nkv, col):
    """The plain version over tables whose column ``col`` names the block
    of column ``col - 1`` (a kernel that reads one pool block twice and
    skips the next) must fall outside the row tolerance."""
    q, kp, vp, bt, pos = args
    bad_bt = bt.clone()
    bad_bt[:, col] = bt[:, col - 1]
    bad = plain(q, kp, vp, bad_bt, pos, kv_frac_bits=nkv)
    return not _rows_within(torch, bad, want, rel)


def _k4_held(torch, args, nkv, tol, what, rows=False):
    """K4 on the plan of its positions (planned once, as the engine
    plans) against its plain version and the split-and-combine twin on the
    same plan, within atol = rtol = ``tol`` (and, with ``rows``, within
    LONG_ROW_TOL of each row's largest |value|).  Returns (max |diff|,
    host plan, kernel output, plain output)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import paged_plan_from_positions
    q, kp, _, bt, pos = args
    work = paged_plan_from_positions(pos, table_width=bt.shape[1],
                                     block_size=kp.shape[1],
                                     groups=q.shape[2] // kp.shape[2])
    got = ops.paged_attention(*args, kv_frac_bits=nkv, work=work.to("cuda"))
    want = ref.paged_attention_ref(*args, kv_frac_bits=nkv)
    split = ref.paged_attention_split_ref(*args, work=work, kv_frac_bits=nkv)
    torch.cuda.synchronize()
    err = 0.0
    for name, plain in (("plain", want), ("split plain", split)):
        err = max(err, _close(torch, got, plain, tol, f"{what} vs {name}"))
        if rows:
            _close_rows(torch, got, plain, LONG_ROW_TOL, f"{what} vs {name}")
    return err, work, got, want


def phase_k4(torch, out):
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    _, sdpa_how = _sdpa(torch)
    # the CPU tests' grid: fp32 q, shuffled tables with trash tails, slot 2
    # padded, a position at a block edge, the spec table at C = 4
    n_grid, grid_err = 0, 0.0
    for c in (1, 4, 16):
        for groups in (1, 2, 4):
            for kv_dt in (torch.int8, torch.float32):
                for d, bs in ((64, 16), (128, 128)):
                    last = (bs, 3 * bs - 1, 0, min(5, bs - 1))
                    args, nkv = _k4_case(torch, gen, 4, c, 2 * groups, 2, d,
                                         bs, 3, last, torch.float32, kv_dt,
                                         spec=c == 4, padded_slot=2)
                    err, *_ = _k4_held(torch, args, nkv, 1e-4,
                                       f"K4 C {c} G {groups} {kv_dt} D {d} "
                                       f"bs {bs}")
                    grid_err = max(grid_err, err)
                    n_grid += 1
    log(f"[15] K4 grid ({n_grid} cases: C 1/4/16, GQA 1/2/4, int8/fp32 "
        f"pools, D 64/128, bs 16/128, fp32 q): within atol=rtol=1e-4 of the "
        f"plain version and of the split-and-combine twin (max |diff| "
        f"{grid_err:.2e})")
    h, kvh = K1_HEADS, K1_KV_HEADS
    # split cases at qwen3-1.7B's heads: positions before, at and after the
    # 512-row split edge and a 4096-row range, at C 1 and 4 (a 4-query run
    # ending there), head dims 12, 100 and 128, both q types over an int8
    # pool and q's own type as the pool
    n_split, split_err = 0, 0.0
    nbmax = K4_SPLIT_LAST[-1] // 16 + 1
    for c in (1, 4):
        for d in (12, 100, 128):
            for q_dt, kv_dt, tol in ((torch.bfloat16, torch.int8, 2e-2),
                                     (torch.float32, torch.int8, 1e-4),
                                     (torch.bfloat16, torch.bfloat16, 2e-2),
                                     (torch.float32, torch.float32, 1e-4)):
                args, nkv = _k4_case(torch, gen, 4, c, h, kvh, d, 16, nbmax,
                                     K4_SPLIT_LAST, q_dt, kv_dt)
                err, work, *_ = _k4_held(torch, args, nkv, tol,
                                         f"K4 split C {c} D {d} {q_dt} q "
                                         f"{kv_dt} pool")
                check(work.n_combine == 3, f"K4 split C {c}: "
                      f"{work.n_combine} combine entries, not 3")
                split_err = max(split_err, err)
                n_split += 1
    log(f"[15] K4 split cases ({n_split}: last positions "
        f"{list(K4_SPLIT_LAST)} x C 1/4 x D 12/100/128 x bf16/fp32 q over "
        f"int8 and q-typed pools, H {h} KVH {kvh}): within atol=rtol=2e-2 "
        f"(bf16 q) / 1e-4 (fp32 q) of the plain version and the split twin "
        f"(max |diff| {split_err:.2e})")
    # a 16-query chunk whose second item sees 33733 rows: 31 chunks of 1088
    # and a last one of 5, so 3 of its 8 queries see nothing of the last
    # chunk (a partial with m = -inf) and 5 see part of it
    for q_dt, kv_dt, tol in ((torch.bfloat16, torch.int8, 2e-2),
                             (torch.float32, torch.int8, 1e-4)):
        args, nkv = _k4_case(torch, gen, 1, 16, h, kvh, 128, 16,
                             K4_EDGE_LAST // 16 + 1, (K4_EDGE_LAST,), q_dt,
                             kv_dt)
        err, work, *_ = _k4_held(torch, args, nkv, tol,
                                 f"K4 chunk edge {q_dt} q", rows=True)
        starts = sorted(work.table[:work.n_items, 3].tolist())
        check(K4_EDGE_LAST - 7 < starts[-1] <= K4_EDGE_LAST,
              f"K4 chunk edge: no chunk starts among the queries "
              f"({starts[-3:]})")
        log(f"[15] K4 chunk edge (C 16 at positions {K4_EDGE_LAST - 15}.."
            f"{K4_EDGE_LAST}, a chunk from {starts[-1]}, {q_dt} q, int8 pool, "
            f"{work.n_items} items, {work.n_combine} split): within "
            f"atol=rtol={tol} and {LONG_ROW_TOL} of each row's largest "
            f"|value| (max |diff| {err:.2e})")
        del args
    rows = {}
    # the engine's three shapes (decode, prefill chunk, verify with a
    # padded draft row on the trash column) and one long int8 cache
    cases = [("decode shape", 4, 1, K4_NBMAX, K4_DECODE_POS, False, 200),
             ("prefill chunk", 1, 16, K4_NBMAX, K4_DECODE_POS[:1], False, 200),
             ("verify", 4, 4, K4_NBMAX, K4_DECODE_POS, True, 200),
             ("long int8 cache", 4, 1, K4_LONG_BLOCKS,
              (K4_LONG_BLOCKS * 16 - 1,) * 4, False, 20)]
    for name, b, c, nbmax, last, spec, iters in cases:
        args, nkv = _k4_case(torch, gen, b, c, h, kvh, K1_DIM, 16, nbmax,
                             last, torch.bfloat16, torch.int8, spec=spec)
        long = name.startswith("long")
        err, work, got, want = _k4_held(torch, args, nkv, 2e-2, f"K4 {name}",
                                        rows=long)
        if long:
            check(work.n_combine == b and _table_fault_caught(
                      torch, ref.paged_attention_ref, args, want,
                      LONG_ROW_TOL, nkv, K4_LONG_BLOCKS // 2),
                  f"K4 {name}: not split, or the row tolerance passes a "
                  f"repeated pool block")
        work_d = work.to("cuda")
        ms = time_ms(torch, lambda: ops.paged_attention(
            *args, kv_frac_bits=nkv, work=work_d), iters)
        plain_ms = time_ms(torch, lambda: ref.paged_attention_ref(
            *args, kv_frac_bits=nkv), 5, warmup=1)
        w_rows = args[3].shape[1] * args[1].shape[1]
        mask = (torch.arange(w_rows, device="cuda")[None, None, None, :]
                <= args[4][:, None, :, None])
        gqa = sdpa_how == "enable_gqa"
        gs = _gather_sdpa(torch, args, nkv, mask, gqa).transpose(1, 2)
        check(_rows_within(torch, gs, want, LONG_ROW_TOL),
              f"K4 {name}: gather + SDPA disagrees with the plain version")
        gs_ms = time_ms(torch, lambda: _gather_sdpa(torch, args, nkv, mask,
                                                    gqa), iters)
        n_bytes, n_ops = _k4_work(args)
        b_ms, b_by = bound_ms(n_bytes, n_ops, "bfloat16")
        rows[name] = dict(b=b, c=c, positions=args[4].tolist(), ms=ms,
                          plain_ms=plain_ms, gather_sdpa_ms=gs_ms,
                          bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                          bytes=n_bytes, ops=n_ops, library_ms=None,
                          items=work.n_items, splits=work.n_parts)
        log(f"[15] K4 {name} (B {b}, C {c}, last positions {list(last)[:4]}, "
            f"{args[3].shape[1]} blocks a table, bf16 q, int8 pool; "
            f"{work.n_items} items, {work.n_combine} split into "
            f"{work.n_parts} chunks): within atol=rtol=2e-2"
            + (f" and {LONG_ROW_TOL} of each row's largest |value|, which a "
               f"repeated pool block fails" if long else "")
            + f" (max |diff| {err:.2e}) | kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, gather + dequantize + SDPA ({sdpa_how}, two "
            f"calls) {gs_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}, "
            f"{n_bytes} B), {ms / b_ms:.1f}x the bound")
        del args, got, want
        torch.cuda.empty_cache()
    res = dict(rows["decode shape"], prefill=rows["prefill chunk"],
               verify=rows["verify"], long=rows["long int8 cache"],
               grid_max_abs_err=grid_err, split_max_abs_err=split_err,
               sdpa=sdpa_how)
    out["k4"] = res
    return res


def _paged_model_steps(vocab, bs, nbmax):
    """Four legacy steps as (tokens, positions, tables, real rows): A's
    16-token prefill chunk (blocks 1, 2); B's 12 tokens padded to a 16
    chunk (block 3, trash after it); a (4, 1) decode of A at 16 and B at 12
    with two padded slots; a (4, 4) verify of A's fed token + 3 drafts and
    B's fed token + 1 draft, padded rows on the extra trash column.  The
    real-row mask (B, C) marks the rows whose logits the engine reads."""
    import numpy as np
    rng = np.random.default_rng(16)
    a = rng.integers(0, vocab, size=20).astype(np.int32)
    b = rng.integers(0, vocab, size=14).astype(np.int32)
    s1 = (a[None, :16], np.arange(16, dtype=np.int32)[None],
          np.asarray([[1, 2]], np.int32), np.ones((1, 16), bool))
    tok = np.zeros((1, 16), np.int32)
    tok[0, :12] = b[:12]
    s2 = (tok, np.arange(16, dtype=np.int32)[None],
          np.asarray([[3, 0]], np.int32), np.arange(16)[None] < 12)
    bt3 = np.zeros((4, nbmax), np.int32)
    bt3[0], bt3[1] = (1, 2), (3, 0)
    s3 = (np.asarray([[a[16]], [b[12]], [0], [0]], np.int32),
          np.asarray([[16], [12], [0], [0]], np.int32), bt3,
          np.asarray([[True], [True], [False], [False]]))
    tok4 = np.zeros((4, 4), np.int32)
    tok4[0], tok4[1, :2] = a[16:20], b[12:14]
    pos4 = np.full((4, 4), nbmax * bs, np.int32)
    pos4[0], pos4[1, :2] = 17 + np.arange(4), 13 + np.arange(2)
    bt4 = np.zeros((4, nbmax + 1), np.int32)
    bt4[0, :2], bt4[1, :2] = (1, 2), (3, 4)
    real4 = np.zeros((4, 4), bool)
    real4[0], real4[1, :2] = True, True
    return s1, s2, s3, (tok4, pos4, bt4, real4)


def phase_paged_model(torch, out):
    """The legacy step card against CPU, fp32 on both sides, in phase 9's
    three cases.  The trash block (0) is left out of every pool comparison
    and padded rows out of every logits comparison: padded rows of several
    slots write the trash block's rows with different values (from layer 1
    on their inputs differ), in no fixed order on the card, and padded
    rows read those rows back; no engine reads a padded row's logits.

    * INT mode, int8 pool: phase 4's INT rule, the layer-0 pool identical,
      every code within one step of the CPU's and at most 0.1% differing,
      logits differing in at most 0.1% of entries by at most 0.25.
    * FP mode, fp32 pool: phase 4's FP rule, logits within atol=rtol=1e-3
      in at least 99.9% of entries and all within 5e-2; pool values within
      atol=rtol=1e-4.  No code can flip, so only fp32 summation orders
      differ.
    * FP mode, int8 pool: phase 9's rule for an int8 cache in FP mode.  A
      K/V value within an ulp of a rounding boundary may take the
      neighbouring code (the float projections sum in another order on the
      card; on an H100 one layer-0 K code of 114688 flipped, a place no
      attention kernel reaches), and every later logit of its sequence
      moves by about 1e-3.  So: every code within one step, at most 0.1%
      differing, logits all within 5e-2, the 1e-3 share printed."""
    from repro_torch.configs import get_config
    from repro_torch.core.qmodel import (QuantContext, QuantMode,
                                         quantize_weight_tree)
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import build_paged_step
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config("qwen3_1_7b"), n_layers=2,
                              dtype="float32")
    t0 = time.perf_counter()
    p_cpu = M.init_params(cfg, 0, device="cpu")
    p_gpu = _tree_to(p_cpu, "cuda")
    bs, nb, nbmax = 16, 8, 2
    steps = _paged_model_steps(cfg.vocab_size, bs, nbmax)
    res = {}
    for mode, kv_bits in (("int", 8), ("fp", None), ("fp", 8)):
        ctx = QuantContext(mode=QuantMode(mode))
        ccfg = dataclasses.replace(cfg, kv_cache_bits=kv_bits)
        case = f"{mode}, {'int8' if kv_bits else 'fp32'} pool"
        step_fn = build_paged_step(ccfg, ctx)
        pc, pg = p_cpu, p_gpu
        if ctx.mode is QuantMode.INT:
            pc, pg = quantize_weight_tree(p_cpu, ctx), \
                quantize_weight_tree(p_gpu, ctx)
        caches = {dv: M.init_paged_cache(ccfg, nb, bs, device=dv)
                  for dv in ("cpu", "cuda")}
        worst = {"frac": 0.0, "max": 0.0}
        ops.reset_launch_counts()
        for tokens, positions, bt, real in steps:
            logits = {}
            for dv, params in (("cpu", pc), ("cuda", pg)):
                with torch.no_grad():
                    lg, caches[dv] = step_fn(
                        params, torch.from_numpy(tokens).to(dv), caches[dv],
                        torch.from_numpy(positions).to(dv),
                        torch.from_numpy(bt).to(dv))
                logits[dv] = lg.float().cpu()
            a, b = logits["cuda"], logits["cpu"]
            check(bool(torch.isfinite(a).all()) and a.shape == b.shape
                  == (*tokens.shape, cfg.vocab_padded),
                  f"paged model {case}: non-finite or misshapen logits")
            a, b = a[torch.from_numpy(real)], b[torch.from_numpy(real)]
            diff = (a - b).abs()
            frac = float(((diff > 0) if mode == "int" else
                          (diff > 1e-3 + 1e-3 * b.abs())).float().mean())
            worst["frac"] = max(worst["frac"], frac)
            worst["max"] = max(worst["max"], float(diff.max()))
        launches = dict(ops.LAUNCHES)
        check(launches["paged_attention"] == cfg.n_layers * len(steps)
              and launches["ragged_attention"] == 0,
              f"paged model {case}: K4 launched "
              f"{launches['paged_attention']} times, want "
              f"{cfg.n_layers} x {len(steps)}")
        pools = []              # (k/v, layer, entries differing, max |diff|)
        n_entries = 0
        for name, arr_c, arr_g in zip(("k", "v"), caches["cpu"]["paged_kv"],
                                      caches["cuda"]["paged_kv"]):
            dd = (arr_g[:, 1:].cpu().double() - arr_c[:, 1:].double()).abs()
            if kv_bits is None:         # float pools: beyond atol=rtol=1e-4
                dd = dd * (dd > 1e-4 + 1e-4 * arr_c[:, 1:].double().abs())
            for layer in range(cfg.n_layers):
                pools.append((name, layer, int((dd[layer] > 0).sum()),
                              float(dd[layer].max())))
                n_entries += dd[layer].numel()
        max_code = max(p[3] for p in pools)
        frac_code = sum(p[2] for p in pools) / n_entries
        log(f"[16] paged model {case} (prefill chunks (1, 16), decode (4, 1),"
            f" verify (4, 4); 2 layers, full width, fp32): real rows' logits "
            f"max |diff| {worst['max']:.3e}, {worst['frac']:.2e} of entries "
            f"{'differ' if mode == 'int' else 'beyond 1e-3'}; pool entries "
            f"{'differing' if kv_bits else 'beyond 1e-4'} outside the trash "
            f"block (k/v, layer, count, max |diff|) {pools} of "
            f"{n_entries // len(pools)} a layer; K4 launches "
            f"{launches['paged_attention']}")
        if kv_bits is None:
            check(frac_code == 0, f"paged model {case}: pool values beyond "
                  f"atol=rtol=1e-4 {pools}")
            check(worst["frac"] <= 1e-3 and worst["max"] <= 5e-2,
                  f"paged model {case}: logits beyond tolerance in "
                  f"{worst['frac']:.2e} of entries, max {worst['max']}")
        else:
            check(max_code <= 1 and frac_code <= 1e-3,
                  f"paged model {case}: pool codes differ by {max_code} steps"
                  f" in {frac_code:.2e} of entries")
            if ctx.mode is QuantMode.INT:
                check(all(p[2] == 0 for p in pools if p[1] == 0),
                      f"paged model {case}: the layer-0 pool differs from "
                      "the CPU's")
                check(worst["frac"] <= 1e-3 and worst["max"] <= 0.25,
                      f"paged model {case}: logits differ in "
                      f"{worst['frac']:.2e} of entries, max {worst['max']}")
            else:
                check(worst["max"] <= 5e-2, f"paged model {case}: logits "
                      f"differ by up to {worst['max']}")
        res[case] = dict(logits_max_abs=worst["max"],
                         logits_frac=worst["frac"], pool_diff=pools,
                         launches=launches)
    log(f"[16] paged model phase {time.perf_counter() - t0:.1f} s")
    out["paged_model"] = res
    del p_cpu, p_gpu
    torch.cuda.empty_cache()


def _engine_run(torch, mode, ragged, spec_k):
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_engine
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    o = serve_engine("qwen3_1_7b", smoke=False, mode=mode, calibrate=False,
                     kv_bits=8, n_requests=8, n_slots=4, rate=1e9,
                     ragged=ragged, spec_k=spec_k, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    return dict(outputs=o["outputs"], requests=o["requests"],
                report=o["report"], launches=launches, wall_s=wall,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                engine=o["engine"])


def _divergence_margins(torch, legacy, ragged):
    """For each request whose tokens differ between the two engines'
    runs, the agreed prefix (prompt and the tokens both generated) replayed
    through the classic dense prefill on the card: the top-2 logit margin
    at the first divergent position, in units of the top logit's bf16 ulp
    (2^(floor(log2 |top|) - 7)), and which engine's token the replay
    takes.  Returns [(rid, index, legacy token, ragged token, replay's
    token, margin in ulps)]."""
    import numpy as np
    from repro_torch.models import model as M
    eng = legacy["engine"]
    rows = []
    for req in legacy["requests"]:
        a, b = legacy["outputs"][req.rid], ragged["outputs"][req.rid]
        n = min(len(a), len(b))
        diff = [i for i in range(n) if a[i] != b[i]]
        if not diff:
            continue
        i = diff[0]
        prefix = torch.from_numpy(np.concatenate(
            [np.asarray(req.prompt, np.int64), np.asarray(a[:i], np.int64)]
        )).to("cuda")[None]
        with torch.no_grad():
            logits, _ = M.prefill(eng.params, {"tokens": prefix}, eng.cfg,
                                  eng.ctx)
        top = torch.topk(logits[0].float(), 2)
        t1, t2 = (float(v) for v in top.values)
        ulp = (2.0 ** (math.floor(math.log2(abs(t1))) - 7) if t1
               else 2.0 ** -133)
        rows.append((req.rid, i, int(a[i]), int(b[i]),
                     int(top.indices[0]), (t1 - t2) / ulp))
    return rows


def _agree(a, b):
    """Share of b's tokens that a reproduces position for position."""
    same = 0
    for r in b:
        n = min(len(a[r]), len(b[r]))
        same += int((a[r][:n] == b[r][:n]).sum())
    return same / max(1, sum(len(b[r]) for r in b))


def phase_legacy_engine(torch, out):
    from repro_torch.configs import get_config
    cfg = get_config("qwen3_1_7b")
    L, per_dispatch_k2 = cfg.n_layers, 7 * cfg.n_layers + 1
    res = {}

    def summary(tag, r):
        rep = r["report"]
        sp = rep["speculative"]
        return (f"[17] {tag}: {rep['completed']} requests, "
                f"{rep['gen_tokens']} tokens, {rep['tokens_per_s']} tok/s, "
                f"TTFT p50 {rep['ttft_s']['p50']:.4f} s, TPOT p50 "
                f"{rep['tpot_s']['p50']:.4f} s, prefill chunks "
                f"{rep['prefill_chunks']}, decode steps {rep['decode_steps']},"
                f" verify steps {rep['spec_steps']}, ragged steps "
                f"{rep['ragged_steps']}, launches K1 "
                f"{r['launches']['ragged_attention']} K4 "
                f"{r['launches']['paged_attention']} K2 "
                f"{r['launches']['int8_matmul']}"
                + ("" if sp is None else
                   f", acceptance {sp['acceptance_rate']} "
                   f"({sp['accepted_tokens']}/{sp['drafted_tokens']})")
                + f", peak {r['peak_gib']:.2f} GiB, {r['wall_s']:.1f} s")

    def check_done(tag, r):
        check(r["report"]["completed"] == 8, f"{tag}: not all done")
        for req in r["requests"]:
            toks = r["outputs"][req.rid]
            check(1 <= len(toks) <= req.max_new_tokens
                  and int(toks.min()) >= 0
                  and int(toks.max()) < cfg.vocab_size,
                  f"{tag}: request {req.rid} tokens {toks}")
        check({k: r["launches"][k] for k in r["report"]["kernel_launches"]}
              == r["report"]["kernel_launches"],
              f"{tag}: report launches {r['report']['kernel_launches']}")

    def check_legacy(tag, r, mode):
        rep = r["report"]
        dispatches = (rep["decode_steps"] + rep["prefill_chunks"]
                      + rep["spec_steps"])
        want_k2 = per_dispatch_k2 * dispatches if mode == "int" else 0
        check(rep["ragged_steps"] == 0
              and r["launches"]["paged_attention"] == L * dispatches
              and r["launches"]["ragged_attention"] == 0
              and r["launches"]["int8_matmul"] == want_k2,
              f"{tag}: launches {r['launches']} over {dispatches} dispatches "
              f"(want K4 {L * dispatches}, K1 0, K2 {want_k2})")

    for mode in ("fp", "int"):
        runs = []
        for rep_i in range(2):
            r = _engine_run(torch, mode, False, 0)
            tag = f"legacy engine {mode} run {rep_i}"
            log(summary(tag, r))
            check_done(tag, r)
            check_legacy(tag, r, mode)
            runs.append(r)
        a, b = runs[0]["outputs"], runs[1]["outputs"]
        check(sorted(a) == sorted(b)
              and all(len(a[k]) == len(b[k]) and (a[k] == b[k]).all()
                      for k in a),
              f"legacy engine {mode}: a repeated greedy run gave other tokens")
        log(f"[17] legacy engine {mode}: repeat run token-identical")
        res[f"legacy_{mode}"] = {k: v for k, v in runs[0].items()
                                 if k not in ("outputs", "requests")}
        # each engine's speculative run against its own plain run
        plain = {False: runs[0]["outputs"]}
        r = _engine_run(torch, mode, True, 0)
        plain[True] = r["outputs"]
        share = _agree(r["outputs"], plain[False])
        log(summary(f"ragged engine {mode}", r) + f"; {share:.4f} of the "
            f"tokens agree with the legacy engine's")
        check_done(f"ragged engine {mode}", r)
        margins = _divergence_margins(torch, runs[0], r)
        for run in (*runs, r):     # the engines' weights and pools go
            run.pop("engine")
        for rid, i, ta, tb, tr, ulps in margins:
            log(f"[17]   request {rid}: first divergence at generated token "
                f"{i} (legacy {ta}, ragged {tb}); the dense prefill of the "
                f"agreed prefix picks {tr}, top-2 margin {ulps:.2f} bf16 ulp")
        log(f"[17] {mode}: {len(margins)} requests diverge between the "
            f"engines; largest top-2 margin at a first divergence "
            + (f"{max(m[-1] for m in margins):.2f} bf16 ulp" if margins
               else "none"))
        res[f"ragged_{mode}"] = dict(
            {k: v for k, v in r.items() if k not in ("outputs", "requests")},
            agree_with_legacy=share, divergence_margins_ulp=margins)
        for ragged in (False, True):
            r = _engine_run(torch, mode, ragged, 3)
            name = "ragged" if ragged else "legacy"
            tag = f"{name} engine {mode} spec_k=3"
            share = _agree(r["outputs"], plain[ragged])
            log(summary(tag, r) + f"; {share:.4f} of the tokens agree with "
                f"the same engine's non-speculative run")
            check_done(tag, r)
            check(share == 1.0, f"{tag}: {share:.4f} of the tokens agree "
                  f"with the same engine's non-speculative run, not all")
            check(r["report"]["speculative"]["drafted_tokens"] > 0,
                  f"{tag}: nothing was drafted")
            if ragged:
                steps = r["report"]["ragged_steps"]
                check(r["launches"]["ragged_attention"] == L * steps
                      and r["launches"]["paged_attention"] == 0,
                      f"{tag}: launches {r['launches']} over {steps} ragged "
                      f"steps (want K1 {L * steps}, K4 0)")
            else:
                check_legacy(tag, r, mode)
            r.pop("engine")
            entry = {k: v for k, v in r.items()
                     if k not in ("outputs", "requests")}
            entry["agree_with_plain"] = share
            res[f"{name}_spec_{mode}"] = entry
        torch.cuda.empty_cache()
    out["legacy_engine"] = res
    return res


# ---------------------------------------------------------------------------
# phase 18: the engine's observability at full depth
# ---------------------------------------------------------------------------

OBS_DIR = ROOT / "build" / "obs"


def _obs_run(torch, count_rows=False, **kw):
    """One full-depth engine run on phase 5's workload (8 requests at
    once, 4 slots, the int8 pool); with ``count_rows`` the rows each
    ragged step scatters into the pool (its ``dest`` outside the trash
    block) are counted from the step's own descriptors, independently of
    the engine's requant counters."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_engine
    from repro_torch.models import model as M
    from repro_torch.serving.kv_pool import TRASH_BLOCK
    rows = []
    real_step = M.ragged_step
    if count_rows:
        def counting_step(params, tokens, cache, positions, rb, cfg, ctx):
            bs = cache["paged_kv"][0].shape[2]
            rows.append(int((rb.dest // bs != TRASH_BLOCK).sum()))
            return real_step(params, tokens, cache, positions, rb, cfg, ctx)
        M.ragged_step = counting_step
    args = dict(smoke=False, kv_bits=8, n_requests=8, n_slots=4, rate=1e9,
                device="cuda")
    args.update(kw)
    if not args.get("w8a8"):
        args.setdefault("calibrate", False)
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        o = serve_engine("qwen3_1_7b", **args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        M.ragged_step = real_step
    o.update(launches=dict(ops.LAUNCHES), wall_s=wall, rows=sum(rows))
    return o


def _same_tokens(a, b) -> bool:
    return sorted(a) == sorted(b) and all(
        len(a[r]) == len(b[r]) and (a[r] == b[r]).all() for r in a)


def _trace_split(chrome, wall_s):
    """Wall time into dispatch spans by shape, and the host time between
    them (wall minus the spans' sum)."""
    by = {}
    for e in chrome["traceEvents"]:
        if e.get("cat") == "dispatch" and e["ph"] == "X":
            key = f"{e['name']} {e['args']['shape']}"
            n, us = by.get(key, (0, 0.0))
            by[key] = (n + 1, us + e["dur"])
    span_s = sum(us for _, us in by.values()) / 1e6
    return {k: {"calls": n, "s": us / 1e6} for k, (n, us) in sorted(
        by.items())}, span_s, wall_s - span_s


def _profile_check(path, n_dispatch):
    """Every ragged dispatch has its ``ragged_step#N`` annotation, and
    every annotation holds at least one launch of K1's kernel (its
    runtime launch call, matched to the kernel by correlation id, lies
    inside the annotation's range).  Returns the annotations, K1's
    kernels, the kernels launched inside each annotation and the summed
    device time of every kernel in the trace (s)."""
    import bisect
    events = json.loads(Path(path).read_text())["traceEvents"]
    ann = [e for e in events if str(e.get("name", "")).startswith(
        "ragged_step#") and e.get("cat") == "user_annotation"]
    launch_ts = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") == "cuda_runtime" and corr is not None:
            launch_ts[corr] = e["ts"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1 = [e for e in kernels if "RelLimit" in str(e.get("name", ""))]

    def launches(evs):
        return sorted(launch_ts[c] for c in
                      ((e.get("args") or {}).get("correlation")
                       for e in evs) if c in launch_ts)

    k1_ts, all_ts = launches(k1), launches(kernels)
    empty, per = [], []
    for a in ann:
        lo, hi = a["ts"], a["ts"] + a["dur"]
        i = bisect.bisect_left(k1_ts, lo)
        if i == len(k1_ts) or k1_ts[i] > hi:
            empty.append(a["name"])
        per.append(bisect.bisect_right(all_ts, hi)
                   - bisect.bisect_left(all_ts, lo))
    check(len(ann) == n_dispatch,
          f"profile: {len(ann)} ragged_step annotations for {n_dispatch} "
          f"dispatches")
    check(k1 and len(k1_ts) == len(k1) and len(all_ts) == len(kernels),
          f"profile: {len(k1)} K1 kernels and {len(kernels)} kernels in the "
          f"trace, {len(k1_ts)} and {len(all_ts)} matched to their launches")
    check(not empty, f"profile: no K1 launch inside {empty[:5]}")
    return len(ann), len(k1), per, sum(e["dur"] for e in kernels) / 1e6


def phase_obs(torch, out):
    from repro_torch.configs import get_config
    from repro_torch.core import hwcost
    from repro_torch.obs.replay import (WorkloadRecord, build_requests,
                                        engine_fingerprint, replay_workload)
    from repro_torch.obs.schema import diff_schema, schema_of
    from repro_torch.obs.trace import validate_chrome_trace
    from repro_torch.serving.engine import ServingEngine
    cfg = get_config("qwen3_1_7b")
    L = cfg.n_layers
    per_step_k2 = 7 * L + 1
    kv_elems = L * cfg.n_kv_heads * cfg.resolved_head_dim * 2
    OBS_DIR.mkdir(parents=True, exist_ok=True)
    res = {}

    def obs_checks(tag, on, off, fwd_elems):
        rep, eng = on["report"], on["engine"]
        steps = rep["ragged_steps"]
        check(_same_tokens(on["outputs"], off["outputs"]),
              f"{tag}: obs-on tokens differ from the obs-off run's")
        check(on["launches"] == off["launches"],
              f"{tag}: launches {on['launches']} with obs on, "
              f"{off['launches']} off")
        check(on["launches"]["ragged_attention"] == L * steps
              and on["launches"]["int8_matmul"] == per_step_k2 * steps
              and rep["kernel_launches"] == {
                  k: on["launches"][k] for k in rep["kernel_launches"]},
              f"{tag}: launches {on['launches']} over {steps} steps (want "
              f"K1 {L * steps}, K2 {per_step_k2 * steps})")
        errs = diff_schema(schema_of(eng.metrics), spec=False, cache=True,
                           slo=True)
        check(not errs, f"{tag}: schema drift {errs[:5]}")
        chrome = eng.tracer.to_chrome()
        faults = validate_chrome_trace(chrome)
        check(not faults, f"{tag}: chrome trace faults {faults[:5]}")
        spans = [e for e in chrome["traceEvents"]
                 if e.get("cat") == "dispatch" and e["ph"] == "X"]
        check(len(spans) == steps and rep["obs"]["trace_dropped"] == 0,
              f"{tag}: {len(spans)} dispatch spans for {steps} steps")
        en, hw = rep["energy"], rep["hwcost"]
        check(en["total_quant_ops"] == sum(
            en[p]["quant_ops"] for p in ("prefill", "decode", "spec_wasted"))
            == hw["requant_ops_performed"] + hw["requant_ops_forward"],
            f"{tag}: energy {en['total_quant_ops']} != hwcost "
            f"{hw['requant_ops_performed']} + {hw['requant_ops_forward']}")
        check(en["total_energy_uj"] == round(hwcost.estimate(
            "bit_shifting", hw["requant_ops_performed"]
            + hw["requant_ops_forward"]).energy_uj, 6),
            f"{tag}: energy uJ {en['total_energy_uj']}")
        check(hw["requant_ops_performed"] == on["rows"] * kv_elems
              and hw["requant_ops_forward"] == on["rows"] * fwd_elems
              and on["rows"] == rep["dispatched_tokens"]
              - rep["padded_tokens"] > 0,
              f"{tag}: requant ops performed {hw['requant_ops_performed']}"
              f", forward {hw['requant_ops_forward']}, for {on['rows']} "
              f"rows scattered into the pool ({kv_elems} and {fwd_elems} "
              f"a row)")
        split, span_s, host_s = _trace_split(chrome, rep["wall_s"])
        log(f"[18] {tag}: {steps} steps, {on['rows']} rows scattered, "
            f"requant ops {hw['requant_ops_performed']} performed / "
            f"{hw['requant_ops_avoided']} avoided / "
            f"{hw['requant_ops_avoided_prefix_cache']} prefix-cache / "
            f"{hw['requant_ops_forward']} forward, energy proxy "
            f"{en['proxy_uj_per_token']} uJ/token, slo alerts "
            f"{rep['slo']['alerts_fired']}; schema clean, trace clean")
        log(f"[18] {tag}: wall {rep['wall_s']:.4f} s = dispatch spans "
            f"{span_s:.4f} s + host between {host_s:.4f} s; "
            + ", ".join(f"{k} {v['calls']}x {v['s']:.4f} s"
                        for k, v in split.items()))
        return dict(steps=steps, rows=on["rows"], hwcost=hw, energy=en,
                    wall_s=rep["wall_s"], span_s=span_s, host_s=host_s,
                    split=split, slo=rep["slo"]["alerts_fired"])

    # INT: obs off and on interleaved (off, on, on, off) for tokens/s,
    # then an obs-on run that counts the rows scattered into the pool
    timed = {"off": [], "on": []}
    runs = []
    for i, on in enumerate((False, True, True, False)):
        kw = dict(trace=True, slo=True) if on else {}
        if on and i == 1:
            kw["metrics_path"] = str(OBS_DIR / "int.prom")
        r = _obs_run(torch, mode="int", **kw)
        rep = r["report"]
        timed["on" if on else "off"].append(
            (rep["tokens_per_s"], rep["tpot_s"]["p50"], rep["ttft_s"]["p50"]))
        r.pop("engine")
        runs.append(r)
        del r
        torch.cuda.empty_cache()
    for r in runs[1:]:
        check(_same_tokens(r["outputs"], runs[0]["outputs"])
              and r["launches"] == runs[0]["launches"],
              "int: the four timing runs differ in tokens or launches")
    text = (OBS_DIR / "int.prom").read_text()
    check("# TYPE hwcost_requant_ops_performed counter" in text
          and "kernel_launches" in text, "int: metrics export incomplete")
    for k in ("off", "on"):
        log(f"[18] int obs {k}: tokens/s "
            + ", ".join(f"{t[0]}" for t in timed[k]) + "; TPOT p50 "
            + ", ".join(f"{t[1]:.5f}" for t in timed[k]) + " s; TTFT p50 "
            + ", ".join(f"{t[2]:.5f}" for t in timed[k]) + " s")
    res["timed_int"] = timed
    off = runs[0]
    int_off = dict(outputs=off["outputs"], launches=off["launches"])
    on = _obs_run(torch, count_rows=True, mode="int", trace=True, slo=True)
    res["int"] = obs_checks("int", on, off, 0)
    del on, runs
    torch.cuda.empty_cache()

    # W8A8: obs off, then obs on with the row count
    off = _obs_run(torch, w8a8=True)
    off.pop("engine")
    on = _obs_run(torch, count_rows=True, w8a8=True, trace=True, slo=True,
                  metrics_path=str(OBS_DIR / "w8a8.prom"))
    fwd = hwcost.forward_quant_ops_per_token(
        dataclasses.replace(cfg, matmul_kernel="int8"))
    res["w8a8"] = obs_checks("w8a8", on, off, fwd)
    del on, off
    torch.cuda.empty_cache()

    # the flight recorder: record, JSON round trip, replay on a fresh
    # engine (the capture's weights and context, a new pool)
    for tag, kw in (("legacy int spec_k=3", dict(mode="int", ragged=False,
                                                  spec_k=3)),
                    ("ragged fp", dict(mode="fp"))):
        r = _obs_run(torch, record=True, **kw)
        eng = r["engine"]
        rec = WorkloadRecord.from_json(json.loads(json.dumps(
            r["record"].to_json())))
        es = rec.engine
        fresh = ServingEngine(
            eng.cfg, eng.params, eng.ctx, n_slots=es["n_slots"],
            block_size=es["block_size"], max_model_len=es["max_model_len"],
            num_blocks=es["num_blocks"], chunk=es["chunk"],
            prefill_token_budget=es["prefill_token_budget"],
            top_k=es["default_top_k"], seed=es["seed"],
            prefix_cache=es["prefix_cache"], spec_k=es["spec_k"],
            ragged=es["ragged"], record=True, virtual_dt=es["virtual_dt"],
            device="cuda")
        with torch.no_grad():
            rr = replay_workload(rec, fresh, strict_fingerprint=True)
        rep = r["report"]
        dispatches = rep["ragged_steps"] if es["ragged"] else (
            rep["prefill_chunks"] + rep["decode_steps"] + rep["spec_steps"])
        log(f"[18] {tag} record: {len(rec.requests)} requests, "
            f"{len(rec.decisions)} decisions, {dispatches} dispatches, "
            f"fingerprint {rec.fingerprint}; replay on a fresh engine: "
            f"tokens {'identical' if rr.token_identical else 'DIFFER'}, "
            f"decision diff {len(rr.decision_diff)} lines, fingerprint "
            f"{'match' if rr.fingerprint_match else 'MISMATCH'}")
        check(rr.ok and rr.fingerprint_match
              and rr.outputs == rec.outputs
              and engine_fingerprint(fresh) == rec.fingerprint,
              f"{tag}: replay differs {rr.mismatched_rids} "
              f"{rr.decision_diff[:10]}")
        check(build_requests(rec)[0].prompt == list(rec.requests[0]["prompt"]),
              f"{tag}: record requests")
        res[f"record {tag}"] = dict(decisions=len(rec.decisions),
                                    dispatches=dispatches)
        del r, eng, fresh, rr
        torch.cuda.empty_cache()

    # torch.profiler capture: one annotation per dispatch, K1 inside
    prof_dir = OBS_DIR / "profile"
    r = _obs_run(torch, mode="int", profile_dir=str(prof_dir))
    rep = r["report"]
    (path,) = rep["profile"]["trace_files"]
    n_ann, n_k1, per, dev_s = _profile_check(path, rep["ragged_steps"])
    check(_same_tokens(r["outputs"], int_off["outputs"])
          and r["launches"] == int_off["launches"],
          "profile: tokens or launches differ from the obs-off run's")
    log(f"[18] profile: {n_ann} ragged_step annotations for "
        f"{rep['ragged_steps']} dispatches, {n_k1} K1 kernels, each "
        f"annotation holding K1 launches -> {path}")
    log(f"[18] profile: kernels launched a dispatch min {min(per)} / mean "
        f"{sum(per) / len(per):.1f} / max {max(per)} ({sum(per) / len(per) / L:.1f}"
        f" a layer); device time of all kernels {dev_s:.4f} s over a "
        f"profiled wall of {rep['wall_s']:.4f} s (busy share "
        f"{dev_s / rep['wall_s']:.3f})")
    res["profile"] = dict(annotations=n_ann, k1_kernels=n_k1,
                          kernels_per_dispatch=per, device_s=dev_s,
                          wall_s=rep["wall_s"])
    del r
    torch.cuda.empty_cache()
    out["obs"] = res
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    ap.add_argument("--only", default=None, metavar="PHASES",
                    help="run only these phases after the build (1, the "
                         "build and launch floor, always runs), "
                         "comma-separated (1, 2, 3, 6, 7, 12, 15, 17, "
                         "18); "
                         "prints no kernels or ok line")
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
    if args.only:
        alone = {1: lambda torch, out: None, 2: phase_k2, 3: phase_k1,
                 6: phase_k5, 7: phase_k6, 12: phase_cnn_kernels,
                 15: phase_k4, 17: phase_legacy_engine, 18: phase_obs}
        try:
            picked = [alone[int(n)] for n in args.only.split(",")]
        except (KeyError, ValueError) as e:
            print(f"chip_smoke: --only takes phases {sorted(alone)}: {e}",
                  file=sys.stderr)
            return 2
        try:
            phase_device(torch, out)
            for phase in picked:
                phase(torch, out)
        except SmokeFailure as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(out, indent=1, default=str))
        log(f"partial run (phases {args.only}) passed in "
            f"{time.perf_counter() - t_start:.1f} s")
        return 0
    try:
        smi, build_s = phase_device(torch, out)
        k2 = phase_k2(torch, out)
        k1 = phase_k1(torch, out)
        phase_model(torch, out)
        eng = phase_engine(torch, out)
        k5 = phase_k5(torch, out)
        k6 = phase_k6(torch, out)
        cal = phase_calibrate(torch, out)
        phase_dense_model(torch, out, *cal)
        del cal
        torch.cuda.empty_cache()
        srv = phase_serve(torch, out)
        phase_w8a8(torch, out)
        torch.cuda.empty_cache()
        cnn = phase_cnn_kernels(torch, out)
        q_resnet = phase_resnet_calibrate(torch, out)
        rfwd = phase_resnet_forward(torch, out, q_resnet)
        del q_resnet
        torch.cuda.empty_cache()
        k4 = phase_k4(torch, out)
        phase_paged_model(torch, out)
        legacy = phase_legacy_engine(torch, out)
        torch.cuda.empty_cache()
        phase_obs(torch, out)
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
    # K5 / K6: one launch at the classic path's shapes (K5: the prefill of
    # the 4x32 prompt into the int8 48-position cache; K6: a decode step
    # at position 47); launches from phase 10's INT serve run
    srv_launches = srv["int"][0]["launches"]
    for name, key, res, line in (
            ("flash_prefill", "flash_prefill", k5, 68),
            ("flash_decode", "flash_decode", k6, 184)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": f"src/repro/kernels/flash_attention.py:{line}",
            "launches": srv_launches[key], "max_abs_err": res["max_abs_err"],
            "ms": res["ms"], "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
            "library_ms": res["library_ms"], "per": "launch"})
    # K3 / K7: one ResNet integer forward at batch 256 (each shape timed
    # alone, summed over the forward's launches); launches from phase 14
    for name, key, res, src, line in (
            ("quantize", "quantize", cnn["k3"], "quantize", 19),
            ("residual_requant", "residual_requant", cnn["k7"],
             "residual_requant", 20)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}.cu",
            "replaces": f"src/repro/kernels/{src}.py:{line}",
            "launches": rfwd["launches"][key],
            "max_abs_err": res["max_abs_err"],
            "ms": res["ms"], "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
            "library_ms": None,
            "per": f"ResNet forward at batch {RESNET_BATCH}: "
                   f"{rfwd['launches'][key]} launches"})
    # K4: one launch at the legacy engine's decode shape; launches from
    # phase 17's first INT legacy run.  No single PyTorch call reads a
    # block table: gather + dequantize + SDPA (two calls) is kept beside it
    kernels.append({
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:285",
        "launches": legacy["legacy_int"]["launches"]["paged_attention"],
        "max_abs_err": k4["max_abs_err"], "ms": k4["ms"],
        "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"], "library_ms": None, "per": "launch",
        "library_note": "no single PyTorch call reads a block table; gather "
                        f"+ dequantize + SDPA (two calls) "
                        f"{k4['gather_sdpa_ms']:.4f} ms"})
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
