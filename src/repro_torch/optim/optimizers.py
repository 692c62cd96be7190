"""Optimizers as (init, update) pairs over the port's param trees
(PyTorch counterpart of ``repro.optim.optimizers``), with the reference's
arithmetic: fp32 state, the update computed in fp32 and cast to the
parameter's dtype.

Where the reference returns new trees, ``update`` writes the parameters,
the moments and the step IN PLACE under ``torch.no_grad()`` and returns
the same params and state: at llama3.2-1B's width the AdamW moments
alone are 9.9 GB, and a second copy of the tree would not be free.

  adamw     -- fp32 moments, bias-corrected, decoupled weight decay on
               every leaf.
  adafactor -- factored second moment (row / col) for leaves whose last
               two dims are >= 128, the full one otherwise; no momentum.

On a (data, model) mesh (``launch.steps.build_train_step(mesh=)``) each
rank updates its own pieces of the leaves: ``update`` and
:func:`clip_by_global_norm` take the mesh and the params' spec tree, and
all-reduce what is not elementwise (the global norm; adafactor's means
over a cut dim and its update RMS).  ``init`` takes the whole tree: the
factored / full choice reads the whole leaf's shape, and a rank's state
is its pieces (``distributed.sharding.rank_zeros``).
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.tree import leaves, leaves_with_paths, tree_map

__all__ = ["OptState", "Optimizer", "adamw", "adafactor",
           "clip_by_global_norm"]


class OptState(NamedTuple):
    step: torch.Tensor   # 0-d int32, on the params' device
    m: Any               # first moment (None for adafactor)
    v: Any               # second moment (a tensor, or a (row, col) tuple)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], OptState]
    update: Callable[[Any, OptState, Any, Any], tuple[Any, OptState]]


def _device_of(params) -> torch.device:
    return leaves(params)[0].device


def _zip(ref: Any, *trees: Any) -> list[tuple]:
    """(path, leaf of ``ref``, the matching leaf or subtree of each of
    ``trees``) in leaf order."""
    rows: list[tuple] = []
    tree_map(lambda *xs: rows.append(xs), ref, *trees)
    return [(path, *xs) for (path, _), xs in zip(leaves_with_paths(ref),
                                                 rows)]


def _reduced(t: torch.Tensor, axes, mesh, mean: bool = False
             ) -> torch.Tensor:
    """``t`` summed (``mean``: averaged) over the mesh axes ``axes``."""
    for a in axes:
        if mesh.shape[a] > 1:
            t = mesh.all_reduced(t, a)
            if mean:
                t = t / mesh.shape[a]
    return t


def _dim_axes(spec: tuple, dim: int) -> tuple:
    """The mesh axes cutting dim ``dim`` of a leaf of spec ``spec``."""
    if not spec or spec[dim] is None:
        return ()
    return spec[dim] if isinstance(spec[dim], tuple) else (spec[dim],)


def clip_by_global_norm(grads: Any, max_norm: float, *, mesh=None,
                        specs: Any = None) -> tuple[Any, torch.Tensor]:
    """Scale every gradient by ``min(1, max_norm / (norm + 1e-9))`` of
    their global fp32 norm, IN PLACE (each cast back to its dtype).
    Returns (grads, norm).  On ``mesh`` ``grads`` are one rank's pieces,
    cut as the spec tree ``specs`` says: each leaf's squares are summed
    over the axes that cut it (the leaves cut by the same axes in one sum,
    one all-reduce an axis), and a leaf whole over an axis counts once."""
    ls = leaves(grads)
    with torch.no_grad():
        total = torch.zeros((), dtype=torch.float32, device=ls[0].device)
        if mesh is None:
            for g in ls:
                total = total + torch.square(g.float()).sum()
        else:
            from repro_torch.distributed.sharding import spec_axes, spec_list
            parts: dict[tuple, torch.Tensor] = {}
            for g, sp in zip(ls, spec_list(grads, specs)):
                key = tuple(a for a in mesh.axis_names
                            if a in spec_axes(sp) and mesh.shape[a] > 1)
                parts[key] = parts.get(key, 0) + torch.square(g.float()).sum()
            for key, part in parts.items():
                total = total + _reduced(part, key, mesh)
        gn = torch.sqrt(total)
        scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
        for g in ls:
            g.copy_(g.float() * scale)
    return grads, gn


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        return OptState(
            step=torch.zeros((), dtype=torch.int32,
                             device=_device_of(params)),
            m=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params),
            v=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params))

    @torch.no_grad()
    def update(grads, state, params, lr, *, mesh=None, specs=None):
        del mesh, specs     # elementwise: a rank's pieces are enough
        stepf = state.step.add_(1).float()
        bc1 = 1 - b1 ** stepf
        bc2 = 1 - b2 ** stepf
        for _, p, g, m, v in _zip(params, grads, state.m, state.v):
            g32 = g.float()
            m.mul_(b1).add_((1 - b1) * g32)
            v.mul_(b2).add_((1 - b2) * g32 * g32)
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            u = u + weight_decay * p.float()
            p.copy_(p.float() - lr * u)
        return params, state

    return Optimizer(init=init, update=update)


def _stack_key(path: str) -> str:
    """The reference's stacked leaf a port leaf belongs to: the port keeps
    one dict per layer in a list where the reference stacks the layers on
    a leading axis, so list indices drop out."""
    return re.sub(r"(^|/)\d+(?=/|$)", r"\1*", path)


def adafactor(eps: float = 1e-30, clip_threshold: float = 1.0,
              weight_decay: float = 0.0, min_dim_factored: int = 128
              ) -> Optimizer:
    """Adafactor (Shazeer & Stern 2018) without momentum.  The update's
    RMS clip runs over each of the reference's leaves: the layers' leaves
    that it stacks into one (``blocks/<i>/attn/wq``) share one RMS."""

    def _factored(p) -> bool:
        return p.ndim >= 2 and p.shape[-1] >= min_dim_factored \
            and p.shape[-2] >= min_dim_factored

    def init(params):
        def v_init(p):
            def z(shape):
                return torch.zeros(shape, dtype=torch.float32,
                                   device=p.device)
            if _factored(p):
                return (z(p.shape[:-1]), z(p.shape[:-2] + p.shape[-1:]))
            return z(p.shape)

        return OptState(step=torch.zeros((), dtype=torch.int32,
                                         device=_device_of(params)),
                        m=None, v=tree_map(v_init, params))

    def vhat_of(v, spec=(), mesh=None):
        if isinstance(v, tuple):
            vr, vc = v
            # the row means' mean over the param's rows
            denom = vr.mean(-1, keepdim=True)
            if mesh is not None:
                denom = _reduced(denom, _dim_axes(spec, -2), mesh, True)
            denom = torch.clamp(denom, min=eps)
            return (vr[..., None] * vc[..., None, :]) / denom[..., None]
        return v

    @torch.no_grad()
    def update(grads, state, params, lr, *, mesh=None, specs=None):
        """``mesh``, ``specs``: the leaves are one rank's pieces cut as the
        params' spec tree says; a factored mean over a cut dim and each
        leaf's sum of u^2 are all-reduced over the axes cutting it."""
        beta2 = 1.0 - state.step.add_(1).float() ** -0.8
        rows = _zip(params, grads, state.v)
        if mesh is None:
            sps = [()] * len(rows)
        else:
            from repro_torch.distributed.sharding import spec_axes, spec_list
            sps = spec_list(params, specs)
        sq: dict[str, torch.Tensor] = {}
        count: dict[str, int] = {}
        # pass 1: the second moments, and each stacked leaf's sum of u^2
        for (path, p, g, v), sp in zip(rows, sps):
            g32 = g.float()
            g2 = g32 * g32 + eps
            if isinstance(v, tuple):
                vr, vc = v
                rmean, cmean = g2.mean(-1), g2.mean(-2)
                if mesh is not None:
                    rmean = _reduced(rmean, _dim_axes(sp, -1), mesh, True)
                    cmean = _reduced(cmean, _dim_axes(sp, -2), mesh, True)
                vr.mul_(beta2).add_((1 - beta2) * rmean)
                vc.mul_(beta2).add_((1 - beta2) * cmean)
            else:
                v.mul_(beta2).add_((1 - beta2) * g2)
            u = g32 / torch.sqrt(vhat_of(v, sp, mesh) + eps)
            key = _stack_key(path)
            usq, n = (u * u).sum(), u.numel()
            if mesh is not None:
                usq = _reduced(usq, spec_axes(sp), mesh)
                n *= math.prod(mesh.shape[a] for a in spec_axes(sp))
            sq[key] = sq.get(key, 0) + usq
            count[key] = count.get(key, 0) + n
        # pass 2: the clipped update from the new moments
        for (path, p, g, v), sp in zip(rows, sps):
            key = _stack_key(path)
            u = g.float() / torch.sqrt(vhat_of(v, sp, mesh) + eps)
            rms = torch.sqrt(sq[key] / count[key] + eps)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            if weight_decay:
                u = u + weight_decay * p.float()
            p.copy_(p.float() - lr * u)
        return params, state

    return Optimizer(init=init, update=update)
