"""Fault-tolerant training, the port's counterpart of
``examples/fault_tolerant_train.py``: the supervisor's restart loop
surviving one injected node failure, re-planning the mesh for the
surviving devices and resuming from the last committed checkpoint.

    PYTHONPATH=src python -m repro_torch.launch.fault_tolerant_train \
        [--device cpu]

The mesh plans are the planner's (one card trains whatever the plan
says; the plan and the resume are what this shows).
"""
from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.core.device import resolve_device
from repro_torch.core.qmodel import QuantContext, QuantMode
from repro_torch.core.tree import unflatten
from repro_torch.data import SyntheticLMStream
from repro_torch.distributed.fault_tolerance import (ElasticPlanner,
                                                     RunSupervisor)
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import model as M
from repro_torch.optim import adamw

__all__ = ["run", "main"]


def run(*, total_steps: int = 25, crash_at: int = 12, ckpt_dir=None,
        device=None) -> dict:
    """Train qwen3-1.7B's smoke config for ``total_steps`` steps (a
    checkpoint every 5), losing 16 of 256 devices at step ``crash_at``
    once.  Returns {"final_step", "restarts", "history", "losses"
    (step -> loss, the resumed steps' last)}."""
    dev = resolve_device(device)
    cfg = get_smoke_config("qwen3_1_7b")
    ctx = QuantContext(mode=QuantMode.FP)
    opt = adamw(weight_decay=0.0)
    stream = SyntheticLMStream(cfg.vocab_size, 64, 4, seed=0)
    ck = Checkpointer(ckpt_dir or tempfile.mkdtemp(prefix="repro_ft_"))

    def step(p, s, batch):
        loss, _, grads = loss_and_grads(p, batch, cfg, ctx)
        p, s = opt.update(unflatten(p, grads), s, p, 1e-3)
        return p, s, loss

    state = {"params": M.init_params(cfg, 0, device=dev)}
    state["opt"] = opt.init(state["params"])
    armed = [True]
    losses: dict[int, float] = {}

    def train_segment(plan, start, total):
        print(f"  [segment] mesh {plan.shape} from step {start}")
        if start > 0:
            restored, _ = ck.restore(state)
            state.update(restored)
        for i in range(start + 1, total + 1):
            b = {k: torch.from_numpy(v).to(dev)
                 for k, v in stream.batch(i).items()}
            state["params"], state["opt"], loss = step(
                state["params"], state["opt"], b)
            losses[i] = float(loss)
            if i % 5 == 0:
                ck.save(i, dict(state), extra={"step": i}, blocking=True)
                print(f"    step {i} loss {losses[i]:.3f} (checkpointed)")
            if armed[0] and i == crash_at:
                armed[0] = False
                print("    !! injected node failure (16 devices lost)")
                return i, {"lost_devices": 16}
        return total, None

    sup = RunSupervisor(ElasticPlanner(model_axis=16), ck, train_segment)
    final = sup.run(n_devices=256, total_steps=total_steps)
    hist = [(h["devices"], h["from"], h["to"]) for h in sup.history]
    print(f"finished at step {final} after {sup.restarts} restart(s); "
          f"history: {hist}")
    return {"final_step": final, "restarts": sup.restarts,
            "history": sup.history, "losses": losses}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(ckpt_dir=args.ckpt_dir, device=args.device)


if __name__ == "__main__":
    main()
