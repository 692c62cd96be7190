"""The training loop (PyTorch counterpart of ``repro.launch.train``): the
synthetic data stream through the prefetching loader, the train step,
asynchronous checkpoints and the heartbeat monitor.

    python -m repro_torch.launch.train --arch llama3_2_1b --steps 200 \
        --batch 8 --seq 128 [--ckpt-dir DIR] [--full] [--mode fake] \
        [--accum 2] [--attn-kernel flash] [--device cpu] \
        [--mesh 1x2 [--dist-backend gloo]]

Runs on the CUDA device unless ``--device cpu``.  ``--mesh DxM`` trains
on a (data, model) mesh of D x M ranks (every language-model family;
the batch, and the audio family's stub frames, over data; heads, d_ff,
vocab, the experts and the recurrent projections over model), spawned
here, or joined
when ``torchrun`` started the process (``torchrun --nproc-per-node D*M
-m repro_torch.launch.train ... --mesh DxM``); rank 0 prints.  The
restart loop (restore the latest commit, re-plan, continue) is
``launch/fault_tolerant_train.py``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.device import resolve_device
from repro_torch.core.qmodel import QuantContext, QuantMode
from repro_torch.core.tree import tree_map
from repro_torch.data import ShardedLoader, SyntheticLMStream
from repro_torch.data.pipeline import check_data_split
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.fault_tolerance import HeartbeatMonitor
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as S
from repro_torch.models import model as M
from repro_torch.optim.schedule import warmup_cosine

__all__ = ["train", "train_rank", "main"]


def train(arch: str, steps: int, *, batch: int = 8, seq: int = 128,
          ckpt_dir: str | None = None, smoke: bool = True,
          mode: str = "fp", lr: float = 3e-3, accum: int = 1,
          ckpt_every: int = 50, log_every: int = 10, seed: int = 0,
          compress_grads: bool = False, attn_kernel: str | None = None,
          params=None, device=None, mesh_shape: tuple[int, int] = (1, 1),
          dist_backend: str | None = None, mesh=None) -> dict:
    """Train ``arch`` (its smoke config, or with ``smoke=False`` its
    published one) for ``steps`` steps of ``batch`` x ``seq`` tokens:
    the optimizer ``steps.pick_optimizer`` picks, a warmup-cosine rate
    peaking at ``lr`` after ``max(steps // 10, 1)`` steps, no remat.
    With ``ckpt_dir`` it resumes from the latest committed checkpoint
    there, at the stream position saved with it (``data_state``: the
    step after the one checkpointed; the reference restarts AT the
    checkpointed step and takes its batch twice, ROADMAP Queue 3), saves
    every ``ckpt_every`` steps and, blocking, at the end.
    ``attn_kernel`` overrides ``cfg.attn_kernel`` ('flash': K5 on the
    card).  ``params`` are carried weights (the seeded random ones by
    default), updated in place.  ``compress_grads`` is taken and, as in
    the reference, not used.

    ``mesh_shape`` (data, model) other than (1, 1) trains on a mesh of D
    x M ranks (``launch.mesh``: spawned here unless ``torchrun`` started
    this process) over ``dist_backend`` (default nccl on the card, gloo
    on the CPU): the reference's ``jit_train_step`` with ``fsdp=False``,
    its batch (and the audio family's ``encoder_features``) over ``data``
    (``batch`` a multiple of D x ``accum``), heads, d_ff, vocab, the
    experts and the recurrent families' projections over ``model``;
    checkpoints hold the whole state, so a run resumes on any mesh.  A
    caller that is already a rank passes its ``mesh`` (``launch.mesh.
    RankMesh``) instead.

    Returns {"params", "losses" (one a step run), "step_s" (host seconds
    a step, the device synchronized), "wall_s", "cfg"}; on a mesh rank
    0's, ``params`` whole, with ``mesh`` and ``ranks`` (every rank's,
    ``params`` None past rank 0's) added."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if attn_kernel is not None:
        cfg = dataclasses.replace(cfg, attn_kernel=attn_kernel)
    kw = dict(cfg=cfg, steps=steps, batch=batch, seq=seq, ckpt_dir=ckpt_dir,
              mode=mode, lr=lr, accum=accum, ckpt_every=ckpt_every,
              log_every=log_every, seed=seed, params=params)
    if mesh is not None or tuple(mesh_shape) == (1, 1):
        return train_rank(mesh, device=device, **kw)
    layout = mesh_lib.RankMesh(*(int(n) for n in mesh_shape))
    S._resolve_attn_kernel(cfg, layout, train=True)   # before any rank
    check_data_split(batch, layout.shape["data"], accum)
    ranks = mesh_lib.on_ranks(train_rank, tuple(mesh_shape), device,
                              dist_backend, kw)
    return dict(ranks[0], mesh=tuple(mesh_shape), ranks=ranks)


def train_rank(mesh, *, cfg, steps, batch, seq, ckpt_dir, mode, lr, accum,
               ckpt_every, log_every, seed, params, device=None) -> dict:
    """:func:`train`'s body on one process: the whole model (``mesh``
    None), or one rank of a mesh, which builds the whole seeded weights
    (or takes ``params``), keeps its pieces and trains them."""
    dev = resolve_device(device if mesh is None else mesh.device)
    ctx = QuantContext(mode=QuantMode(mode))
    opt = S.pick_optimizer(cfg)
    lr_fn = warmup_cosine(lr, max(steps // 10, 1), steps)
    monitor = HeartbeatMonitor(n_hosts=1)
    lead = mesh is None or mesh.rank == 0
    if params is None:
        params = M.init_params(cfg, seed, device=dev)
    if mesh is None:
        step_fn = S.build_train_step(cfg, ctx, opt, lr_fn, remat=False,
                                     accum_steps=accum)
        opt_state = opt.init(params)
        template, on_mesh = None, {}
    else:
        step_fn, (p_abs, o_abs, p_spec, o_spec) = S.jit_train_step(
            cfg, ctx, mesh, opt, lr_fn, remat=False, fsdp=False,
            accum_steps=accum)
        params = shd.shard_params(params, mesh, mesh.coords, cfg=cfg,
                                  fsdp=False, serve=False)
        params = tree_map(lambda t: t.to(dev), params)
        opt_state = shd.rank_zeros(o_abs, o_spec, mesh, dev)
        template = {"params": p_abs, "opt": o_abs}
        on_mesh = dict(mesh=mesh, specs={"params": p_spec, "opt": o_spec})
    audio = cfg.family == "audio"
    stream = SyntheticLMStream(
        cfg.vocab_size, seq, batch, seed=seed,
        encoder_seq=cfg.encdec.encoder_seq if audio else None,
        d_model=cfg.d_model if audio else None)
    data_state = {"step": 0, "seed": seed}
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    if ckpt and ckpt.latest_step() is not None:
        state, extra = ckpt.restore(
            template or {"params": params, "opt": opt_state}, **on_mesh)
        params, opt_state = state["params"], state["opt"]
        # the stream position saved beside the state: the batch after the
        # last one taken (the final commit, at ``steps``, has none)
        data_state = extra.get("data_state",
                               {"step": extra.get("step",
                                                  ckpt.latest_step()),
                                "seed": seed})
        if lead:
            print(f"resumed from step {data_state['step']}")
    loader = ShardedLoader.restore(
        stream, dev, data_state,
        **({} if mesh is None else dict(mesh=mesh, accum=accum)))
    start_step = data_state["step"]

    losses, step_s = [], []
    t_start = time.time()
    try:
        for _ in range(start_step, steps):
            step_i, b = next(loader)
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, b)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            monitor.beat(0, dt)
            losses.append(loss)
            step_s.append(dt)
            if lead and step_i % log_every == 0:
                print(f"step {step_i:5d} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.2f} "
                      f"({dt:.2f}s)")
            if ckpt and step_i and step_i % ckpt_every == 0:
                ckpt.save(step_i, {"params": params, "opt": opt_state},
                          extra={"step": step_i,
                                 "data_state": loader.state()}, **on_mesh)
    finally:
        loader.close()
        if ckpt:
            ckpt.save(steps, {"params": params, "opt": opt_state},
                      extra={"step": steps}, blocking=True, **on_mesh)

    if mesh is not None:    # the whole weights, on rank 0
        params = shd.unshard_params(params, on_mesh["specs"]["params"], mesh)
        params = tree_map(lambda t: t.cpu(), params) if lead else None
    return {"params": params, "losses": losses, "step_s": step_s,
            "wall_s": time.time() - t_start, "cfg": cfg}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--full", action="store_true",
                    help="full config (default: smoke-scale)")
    ap.add_argument("--mode", default="fp",
                    choices=["fp", "fake", "fake_sf", "int"])
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--attn-kernel", choices=["flash", "chunked"],
                    default=None,
                    help="attention path (default: the config's)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="train on a (data, model) mesh of ranks, e.g. "
                         "'1x2': the batch over data; heads, MLP hidden, "
                         "experts and vocab over model")
    ap.add_argument("--dist-backend", default=None, choices=["gloo", "nccl"],
                    help="[--mesh] the ranks' torch.distributed backend "
                         "(default nccl on the card, gloo on the CPU; ranks "
                         "sharing one card take gloo)")
    args = ap.parse_args(argv)
    out = train(args.arch, args.steps, batch=args.batch, seq=args.seq,
                ckpt_dir=args.ckpt_dir, smoke=not args.full, mode=args.mode,
                lr=args.lr, accum=args.accum,
                compress_grads=args.compress_grads,
                attn_kernel=args.attn_kernel, device=args.device,
                mesh_shape=(mesh_lib.parse_mesh(args.mesh) if args.mesh
                            else (1, 1)),
                dist_backend=args.dist_backend)
    if not mesh_lib.in_torchrun() or os.environ["RANK"] == "0":
        print(f"final loss {out['losses'][-1]:.4f} "
              f"(first {out['losses'][0]:.4f}) in {out['wall_s']:.0f}s")
    return out


if __name__ == "__main__":
    main()
