"""Where one engine run's time goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_engine \
        [--mode int] [--top 15] [--no-graphs]

Serves the same workload as ``chip_smoke.py``'s engine phase (qwen3-1.7B
at full depth, 8 requests arriving at once, 4 slots) three times on one
engine: twice to warm up (kernel builds, the allocator, and with graphs,
the default, each step key's eager first call and its capture), then,
after ``reset_metrics``, the same requests again under
``torch.profiler`` with CPU and CUDA activities (every step a graph
replay; ``--no-graphs``: every step eager).  Prints the profiled run's
wall time, the summed device time of its kernels, copies and fills (one
stream: they do not overlap; the operators' rows, which repeat their
kernels' time, are left out), the device busy share (that time / wall;
the rest is host time the card waits on), the kernels with the most
device time and their launch counts, and K1's kernels as
``key_averages()`` and the profiler's Kineto events count them beside the
engine's own count.  Exits non-zero when no device time was recorded.
"""
from __future__ import annotations

import argparse
import sys
import time
from collections import Counter

WORKLOAD = dict(n_requests=8, rate=1e9)
# K1's kernel names carry its causal-limit policy (csrc/ragged_attention.cu)
K1_TAG = "RelLimit"


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v:
            return float(v)
    return 0.0


def profile_run(mode: str = "int", graphs=None) -> dict:
    """The profiled second run of :mod:`this module <repro_torch.launch.
    profile_engine>`'s workload: its report, wall time (s), summed kernel
    device time (s), busy share and ``(kernel, device us, launches)``
    rows, most device time first (from ``key_averages()``); and
    ``raw_counts``, the device events by name as the profiler's Kineto
    result holds them (``prof.profiler.kineto_results``, the one view of
    the records before ``key_averages()`` builds its table)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import poisson_workload, serve_engine
    kw = dict(smoke=False, mode=mode, calibrate=False, kv_bits=8, n_slots=4,
              graphs=graphs, device="cuda", **WORKLOAD)
    eng = serve_engine("qwen3_1_7b", **kw)["engine"]
    with torch.no_grad():
        eng.reset_metrics()
        eng.run(poisson_workload(eng.cfg.vocab_size, **WORKLOAD))
    requests = poisson_workload(eng.cfg.vocab_size, **WORKLOAD)
    eng.reset_metrics()
    torch.cuda.synchronize()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rep = eng.run(requests)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the device's own events (kernels, copies, fills) only: an operator
    # row's self device time is its kernels' again
    rows = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    dev_s = sum(r[1] for r in rows) / 1e6
    raw = Counter(e.name() for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA)
    return dict(report=rep, wall_s=wall, device_s=dev_s,
                busy=dev_s / wall, rows=rows, raw_counts=dict(raw),
                card=torch.cuda.get_device_name(0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="int", choices=["fp", "int"])
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--no-graphs", action="store_true",
                    help="every step eager instead of a graph replay")
    args = ap.parse_args(argv)
    r = profile_run(args.mode, graphs=False if args.no_graphs else None)
    rep = r["report"]
    steps = rep["ragged_steps"]
    events = sum(c for _, _, c in r["rows"])
    k1 = [sum(c for k, _, c in r["rows"] if K1_TAG in k),
          sum(c for k, c in r["raw_counts"].items() if K1_TAG in k)]
    print(f"profile {args.mode} "
          f"({'eager' if args.no_graphs else 'graphs'}): {steps} steps, "
          f"{rep['gen_tokens']} tokens, wall {r['wall_s']:.3f} s "
          f"(profiled), device time {r['device_s']:.3f} s, busy share "
          f"{r['busy']:.3f}, {events / max(steps, 1):.1f} kernels, "
          f"copies and fills a step; K1 kernels: {k1[0]} in "
          f"key_averages(), {k1[1]} in the Kineto events, "
          f"{rep['kernel_launches'].get('ragged_attention')} launched "
          f"(the engine's count); {r['card']}")
    if not r["rows"]:
        print("no device time recorded", file=sys.stderr)
        return 1
    for key, us, count in r["rows"][:args.top]:
        print(f"  {us / 1e3:10.3f} ms  {100 * us / 1e6 / r['device_s']:5.1f}%"
              f"  {count:7d}x  {key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
