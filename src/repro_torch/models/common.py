"""Shared model building blocks: norms, rope, embeddings, initializer.

PyTorch counterpart of ``repro.models.common``.  Layers are plain
functions over dicts of tensors.  The float ops that feed a quantization
point keep the reference's cast order (fp32 statistics and angles, cast
to the activation dtype before they touch the activation); their
reductions and transcendentals run in float64 before that single fp32
rounding, so the CPU and CUDA paths round to the same fp32 values and
quantize to the same codes.  The reference's own fp32 values differ from
these in the last bit now and then (see ``inv_rms``).
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from repro_torch.core.qmodel import QuantContext, qlinear

__all__ = ["inv_rms", "rmsnorm", "rope_freqs", "rope_tables", "rotate", "apply_rope",
           "linear", "embed", "unembed", "Initializer"]


def inv_rms(x: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 ``rsqrt(mean(x^2) + eps)`` over the last axis, evaluated in
    float64 and rounded once.

    The one place the port departs from the reference's arithmetic: the
    reference sums in fp32 in XLA's order, which neither PyTorch device
    reproduces (their fp32 orders differ from XLA's and from each other).
    Rounding the float64 value gives the same bits on the CPU and the
    card, but not always XLA's: a flipped last bit can move an Eq.-1 code
    that sits on a rounding boundary, and at full qwen3 width that happens
    a few times per step (``tests/test_torch_model.py`` holds the port
    against the reference there)."""
    x64 = x.to(torch.float64)
    ms = (x64 * x64).sum(-1) / x.shape[-1]
    return torch.rsqrt(ms + eps).to(torch.float32)


def rmsnorm(x: torch.Tensor, gain: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """``x * (rsqrt(mean(x^2) + eps) * gain)``, the fp32 scale cast to
    x's dtype before the multiply (as the reference)."""
    scale = inv_rms(x, eps)[..., None] * gain.to(torch.float32)
    return x * scale.to(x.dtype)


def rope_freqs(head_dim: int, theta: float) -> torch.Tensor:
    """fp32 inverse frequencies, computed on the CPU (bit-identical to the
    reference's) whatever device the rotation later runs on."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32)
                            / head_dim))


@functools.lru_cache(maxsize=16)
def _rope_freqs_on(head_dim: int, theta: float,
                   device: torch.device) -> torch.Tensor:
    # one host-to-device copy per (head_dim, theta, device), not one per
    # call: a copy from pageable host memory waits for the device to drain
    return rope_freqs(head_dim, theta).to(device)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) for ``positions`` (..., S), shaped (..., S, 1, D/2) to
    broadcast over heads.  Angles are fp32 products (as the reference);
    cos/sin are evaluated in float64 from those fp32 angles, rounded once
    to fp32 and cast to the activation dtype.  One step computes them
    once and shares them across q, k and every layer."""
    freqs = _rope_freqs_on(head_dim, float(theta), positions.device)
    a64 = (positions[..., :, None, None].to(torch.float32) * freqs
           ).to(torch.float64)
    return (torch.cos(a64).to(torch.float32).to(dtype),
            torch.sin(a64).to(torch.float32).to(dtype))


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """Half-split rope rotation ``[x1 cos - x2 sin, x1 sin + x2 cos]`` over
    the two halves of D, in the activation dtype."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D), positions: (..., S) int (the reference's
    ``apply_rope``)."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta, x.dtype))


def linear(ctx: QuantContext, name: str, x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Unified-module linear — alias keeping model code terse."""
    return qlinear(ctx, name, x, w, b)


def embed(table: torch.Tensor, tokens: torch.Tensor,
          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return table[tokens.long()].to(dtype)


def unembed(ctx: QuantContext, x: torch.Tensor,
            table: torch.Tensor) -> torch.Tensor:
    """LM head; logits stay in the activation dtype."""
    return qlinear(ctx, "lm_head", x, table)


class Initializer:
    """Deterministic fan-in scaled truncated-normal initializer drawing
    from one ``torch.Generator`` on ``device``.  Matmul weights are
    ``trunc_normal(-2, 2) / sqrt(fan_in)`` in ``dtype``; norm gains are
    fp32 ones (as the reference)."""

    def __init__(self, generator: torch.Generator,
                 dtype: torch.dtype = torch.bfloat16,
                 device: Optional[torch.device] = None):
        self.gen = generator
        self.dtype = dtype
        self.device = device if device is not None else generator.device

    def dense(self, shape, fan_in: Optional[int] = None) -> torch.Tensor:
        fan = fan_in if fan_in is not None else shape[0]
        std = 1.0 / math.sqrt(max(fan, 1))
        w = torch.empty(shape, dtype=torch.float32, device=self.device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                    generator=self.gen)
        return (w * std).to(self.dtype)

    def ones(self, shape) -> torch.Tensor:
        return torch.ones(shape, dtype=torch.float32, device=self.device)

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=self.dtype, device=self.device)
