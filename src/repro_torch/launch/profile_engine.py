"""Where one engine run's time goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_engine \
        [--mode int] [--top 15]

Serves the same workload as ``chip_smoke.py``'s engine phase (qwen3-1.7B
at full depth, 8 requests arriving at once, 4 slots) twice: once to warm
up (kernel builds, allocator), then under ``torch.profiler`` with CPU and
CUDA activities.  Prints the profiled run's wall time, the summed device
time of its kernels (one stream: kernels do not overlap), the device busy
share (kernel time / wall; the rest is host time the card waits on), and
the kernels with the most device time and their launch counts.  Exits
non-zero when no device time was recorded.
"""
from __future__ import annotations

import argparse
import sys
import time


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v:
            return float(v)
    return 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="int", choices=["fp", "int"])
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import serve_engine
    kw = dict(smoke=False, mode=args.mode, calibrate=False, kv_bits=8,
              n_requests=8, n_slots=4, rate=1e9, device="cuda")
    serve_engine("qwen3_1_7b", **kw)                       # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = serve_engine("qwen3_1_7b", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, _device_us(e), e.count) for e in prof.key_averages()]
    rows = [r for r in rows if r[1] > 0]
    dev_us = sum(r[1] for r in rows)
    rep = out["report"]
    print(f"profile {args.mode}: {rep['ragged_steps']} steps, "
          f"{rep['gen_tokens']} tokens, wall {wall:.3f} s (profiled), "
          f"device time {dev_us / 1e6:.3f} s, busy share "
          f"{dev_us / 1e6 / wall:.3f}, {torch.cuda.get_device_name(0)}")
    if not rows:
        print("no device time recorded", file=sys.stderr)
        return 1
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:args.top]:
        print(f"  {us / 1e3:10.3f} ms  {100 * us / dev_us:5.1f}%  "
              f"{count:7d}x  {key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
