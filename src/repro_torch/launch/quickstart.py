"""Quickstart: the paper's full pipeline on its own model family (ResNet),
the port's counterpart of ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu] [--batch 16]

1. Build a ResNet with BatchNorm, fold BN into conv weights (paper §1.2.1).
2. Build the dataflow plan (Fig. 1 unified modules) — count quant points.
3. Calibrate fractional bits with Algorithm 1 (grid search, no fine-tune).
4. Run the integer-only deploy path (int8 codes + bit shifts) and compare
   with the FP reference.
5. Price the requantization hardware (Table 5 model).

Runs on the CUDA device unless ``--device cpu`` is given; on the card the
integer forward runs on the hand-written kernels (K2, K3, K7).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.resnet_paper import ResNetConfig
from repro_torch.core import hwcost
from repro_torch.core.dataflow import count_quant_ops
from repro_torch.core.device import resolve_device
from repro_torch.models import resnet as R

__all__ = ["run", "main"]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(device: Optional[str] = None, batch: int = 16) -> dict:
    """The five steps on ``device`` (default ``cuda``), printed as they
    go; returns the numbers printed."""
    dev = resolve_device(device)
    cfg = ResNetConfig(stages=(16, 32), blocks_per_stage=2, img_size=32)
    gen = torch.Generator()           # the same weights on every device
    gen.manual_seed(0)
    params = R.init_resnet(cfg, generator=gen, device=dev)
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, size=(batch, cfg.img_size, cfg.img_size, 3)).astype(
            np.float32)).to(dev)

    plan = R.build_resnet_plan(cfg)
    counts = count_quant_ops(plan)
    print(f"[dataflow] unified modules: {len(plan.modules)} | "
          f"quant points joint={counts['joint_activation_points']} vs "
          f"naive={counts['naive_activation_points']} "
          f"(saved {counts['saved']})")

    print(f"[calibrate] running Algorithm 1 on {dev} ...")
    q = R.quantize_resnet(params, x, cfg)
    _sync(dev)
    print(f"  {len(q.report.results)} modules in {q.report.total_s:.1f}s, "
          f"shift histogram {q.report.shift_histogram()}")

    logits_fp = R.resnet_forward(params, x, cfg)
    R.resnet_int_forward(q, x, cfg)               # first call: kernel builds
    _sync(dev)
    t0 = time.perf_counter()
    logits_int = R.resnet_int_forward(q, x, cfg)
    _sync(dev)
    int_s = time.perf_counter() - t0
    rel = float(torch.linalg.norm(logits_int - logits_fp)
                / torch.linalg.norm(logits_fp))
    agree = float((logits_fp.argmax(-1) == logits_int.argmax(-1))
                  .float().mean())
    print(f"[deploy] integer-only path: rel_err={rel:.4f} "
          f"prediction agreement={agree:.3f} ({batch / int_s:.1f} images/s "
          f"on {dev})")

    n_requants = counts["joint_activation_points"] * 32 * 32 * 32
    energy = {}
    for kind in ("bit_shifting", "scaling_factor", "codebook"):
        r = hwcost.estimate(kind, n_requants)
        energy[kind] = r.energy_uj
        print(f"[hwcost] {kind:15s} {r.energy_uj:8.1f} uJ "
              f"({r.vs_bit_shift_energy:.1f}x bit-shift)")
    return dict(counts=counts, calib_s=q.report.total_s, rel_err=rel,
                agreement=agree, int_forward_s=int_s, energy_uj=energy)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu for the plain path")
    ap.add_argument("--batch", type=int, default=16)
    args = ap.parse_args(argv)
    run(args.device, args.batch)


if __name__ == "__main__":
    main()
