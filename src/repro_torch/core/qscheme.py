"""Power-of-two ("bit-shift") quantization scheme — Eq. (1) of the paper.

    Q(r; N_r, n_bits) = clip(round(r * 2^{N_r}),
                             -2^{n_bits-1}, 2^{n_bits-1} - 1) * 2^{-N_r}

PyTorch counterpart of ``repro.core.qscheme``: the same float32 op order
(scale by an exact power of two, round half away from zero, clip, cast)
and the same int32 shift semantics, so codes are bit-identical to the
JAX package's on every device.

* ``quant(r, N, bits)``   — float → integer code.
* ``dequant(q, N)``       — integer code → float.
* ``shift_requant(acc, s)`` — int32 accumulator → n-bit code by a
  round-half-away right shift (a negative ``s`` is a saturating left
  shift).
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["int_bounds", "round_half_away", "quant", "dequant",
           "shift_requant", "storage_dtype"]


def int_bounds(bits: int, unsigned: bool = False) -> tuple[int, int]:
    """Integer clipping range for a given bit width (sign bit included)."""
    if unsigned:
        return 0, (1 << bits) - 1
    return -(1 << (bits - 1)), (1 << (bits - 1)) - 1


def storage_dtype(bits: int, unsigned: bool = False) -> torch.dtype:
    if bits <= 8:
        return torch.uint8 if unsigned else torch.int8
    if bits <= 16:
        return torch.uint16 if unsigned else torch.int16
    return torch.uint32 if unsigned else torch.int32


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest, ties away from zero (hardware ``round()``).

    Not ``torch.round``, which rounds half to even.  The ``+/-0.5`` add
    runs in the input's float type, exactly as the reference does (the
    sign of the half differs from the reference's ``x >= 0`` test only at
    -0.0, where both round to zero)."""
    return torch.trunc(x + torch.copysign(torch.full_like(x, 0.5), x))


def quant(r: torch.Tensor, n: int, bits: int = 8, unsigned: bool = False,
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Float → integer code: ``clip(round(r * 2^n))`` (the r^I of Eq. 1)."""
    lo, hi = int_bounds(bits, unsigned)
    scaled = r.to(torch.float32) * (2.0 ** int(n))
    q = torch.clamp(round_half_away(scaled), lo, hi)
    return q.to(dtype if dtype is not None else storage_dtype(bits, unsigned))


def dequant(q: torch.Tensor, n: int,
            out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Integer code → float: ``q * 2^-n``."""
    return (q.to(torch.float32) * (2.0 ** (-int(n)))).to(out_dtype)


def _right_shift_round(a: torch.Tensor, s: int) -> torch.Tensor:
    """Round-half-away arithmetic right shift of int32 ``a`` by ``s > 0``:
    ``a >= 0 ? (a + half) >> s : -(((-a) + half) >> s)`` with int32
    wrap-around, as the reference computes it."""
    half = 1 << (s - 1)
    return torch.where(a >= 0, (a + half) >> s, -(((-a) + half) >> s))


def shift_requant(acc: torch.Tensor, shift: int, bits: int = 8,
                  unsigned: bool = False,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The paper's hardware requantization: int32 accumulator → n-bit code.

    ``shift = (N_x + N_w) - N_o`` (Eq. 3/4).  ``shift > 0`` is a right
    shift with round-half-away; ``shift < 0`` is a LEFT shift that
    saturates the accumulator to ``±(2^31-1) >> |shift|`` first (int32
    ``<<`` would otherwise wrap and flip the sign through the clip).
    Shifts are static Python ints in ``[-31, 31]``.
    """
    shift = int(shift)
    if not -31 <= shift <= 31:
        raise ValueError(f"shift {shift} outside the int32 range [-31, 31]")
    lo, hi = int_bounds(bits, unsigned)
    acc = acc.to(torch.int32)
    if shift > 0:
        acc = _right_shift_round(acc, shift)
    elif shift < 0:
        bound = (2**31 - 1) >> (-shift)
        acc = torch.clamp(acc, -bound, bound) << (-shift)
    out = torch.clamp(acc, lo, hi)
    return out.to(dtype if dtype is not None else storage_dtype(bits, unsigned))
