"""The paper's pipeline on an LM, the port's counterpart of
``examples/train_small_lm.py``: train llama3.2-1B's architecture on the
synthetic stream, calibrate the trained weights by Algorithm 1 (one
batch, no fine-tuning), and compare the integer-only forward's
predictions with the float one's.

    PYTHONPATH=src python -m repro_torch.launch.train_small_lm \
        [--steps 300] [--full] [--ckpt-dir DIR] [--device cpu]

The smoke config by default; ``--full`` trains the published width and
depth (1.236 B parameters: a card's job).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.lm_calibrate import calibrate_lm
from repro_torch.core.qmodel import QuantContext, QuantMode
from repro_torch.data import SyntheticLMStream
from repro_torch.launch.train import train
from repro_torch.models import model as M

__all__ = ["run", "main"]

ARCH = "llama3_2_1b"


def run(steps: int = 300, *, full: bool = False, ckpt_dir=None,
        batch: int = 8, seq: int = 128, attn_kernel=None,
        device=None) -> dict:
    """Train, calibrate, compare; prints as it goes and returns {"losses",
    "agreement" (FP vs INT argmax), "calibrate_s", "params", "ctx"}."""
    out = train(ARCH, steps, batch=batch, seq=seq, ckpt_dir=ckpt_dir,
                smoke=not full, attn_kernel=attn_kernel, device=device)
    losses = out["losses"]
    print(f"\ntrained {steps} steps: loss {losses[0]:.3f} -> "
          f"{losses[-1]:.3f}")
    cfg, params = out["cfg"], out["params"]
    dev = params["embed"].device
    stream = SyntheticLMStream(cfg.vocab_size, seq, batch, seed=123)
    b = {"tokens": torch.from_numpy(stream.batch(0)["tokens"]).to(dev)}
    t0 = time.perf_counter()
    ctx_cal, _ = calibrate_lm(lambda p, bb, c: M.forward(p, bb, cfg, c),
                              params, b)
    cal_s = time.perf_counter() - t0
    with torch.no_grad():
        lf, _ = M.forward(params, b, cfg, QuantContext(mode=QuantMode.FP))
        li, _ = M.forward(params, b, cfg,
                          dataclasses.replace(ctx_cal, mode=QuantMode.INT))
    agree = float(np.mean(lf.argmax(-1).cpu().numpy()
                          == li.argmax(-1).cpu().numpy()))
    print(f"post-training int8 deploy: prediction agreement {agree:.3f} "
          f"(calibration {cal_s:.1f}s, no fine-tuning)")
    return {"losses": losses, "agreement": agree, "calibrate_s": cal_s,
            "params": params, "ctx": ctx_cal}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--full", action="store_true",
                    help="the published config instead of the smoke one")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--attn-kernel", choices=["flash", "chunked"],
                    default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(args.steps, full=args.full, ckpt_dir=args.ckpt_dir,
               attn_kernel=args.attn_kernel, device=args.device)


if __name__ == "__main__":
    main()
