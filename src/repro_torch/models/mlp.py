"""Feed-forward layer: the SwiGLU MLP (PyTorch counterpart of
``repro.models.mlp.init_mlp`` / ``mlp``).

Quantization placement (paper Fig. 1(b) generalized): the gate product
``silu(w1 x) * (w3 x)`` is ONE unified module — a single activation quant
point after the product feeds the down-projection.  The MoE layer is not
ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.core.qmodel import QuantContext
from repro_torch.models.common import linear

__all__ = ["init_mlp", "mlp"]


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` evaluated in float64 and rounded once to x's
    dtype, so every device rounds to the same value."""
    x64 = x.to(torch.float64)
    return (x64 * torch.sigmoid(x64)).to(x.dtype)


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return _silu(x)
    raise NotImplementedError(f"activation {kind!r} is not ported yet")


def init_mlp(init, d_model: int, d_ff: int, act: str = "silu") -> dict:
    p = {"w1": init.dense((d_model, d_ff)),
         "w2": init.dense((d_ff, d_model), fan_in=d_ff)}
    if act in ("silu",):  # gated
        p["w3"] = init.dense((d_model, d_ff))
    return p


def mlp(ctx: QuantContext, p: dict, x: torch.Tensor, act: str = "silu",
        name: str = "mlp") -> torch.Tensor:
    if "w3" in p:
        g = _act(linear(ctx, f"{name}/w1", x, p["w1"]), act)
        u = linear(ctx, f"{name}/w3", x, p["w3"])
        h = g * u   # unified-module boundary: ONE quant point after product
    else:
        h = _act(linear(ctx, f"{name}/w1", x, p["w1"]), act)
    return linear(ctx, f"{name}/w2", h, p["w2"])
