"""Power-of-two ("bit-shift") quantization scheme — Eq. (1) of the paper.

    Q(r; N_r, n_bits) = clip(round(r * 2^{N_r}),
                             -2^{n_bits-1}, 2^{n_bits-1} - 1) * 2^{-N_r}

PyTorch counterpart of ``repro.core.qscheme``: the same float32 op order
(scale by an exact power of two, round half away from zero, clip, cast)
and the same int32 shift semantics, so codes are bit-identical to the
JAX package's on every device.

* ``quant(r, N, bits)``   — float → integer code.
* ``dequant(q, N)``       — integer code → float.
* ``fake_quant(r, N, bits)`` — Eq. 1 in float arithmetic, ``dequant(quant(r))``;
  ``fake_quant_ste`` the same with a straight-through gradient.
* ``max_frac_bits(x)`` / ``search_window(x, tau)`` — Eq. 6 and the narrowed
  window of Algorithm 1.
* ``shift_requant(acc, s)`` — int32 accumulator → n-bit code by a
  round-half-away right shift (a negative ``s`` is a saturating left
  shift).
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["int_bounds", "round_half_away", "quant", "dequant",
           "fake_quant", "fake_quant_ste", "max_frac_bits", "search_window",
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


def fake_quant(r: torch.Tensor, n: int, bits: int = 8,
               unsigned: bool = False) -> torch.Tensor:
    """Eq. (1) in float arithmetic: ``dequant(quant(r))`` in r's dtype.

    The scales are exact powers of two.  (The reference's ``jnp.exp2`` is
    exact only for |n| <= 12; Algorithm 1's windows stay inside that.)"""
    lo, hi = int_bounds(bits, unsigned)
    scaled = r.to(torch.float32) * (2.0 ** int(n))
    q = torch.clamp(round_half_away(scaled), lo, hi)
    return (q * (2.0 ** (-int(n)))).to(r.dtype)


class _FakeQuantSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, n, bits, unsigned):
        lo, hi = int_bounds(bits, unsigned)
        scaled = r.to(torch.float32) * (2.0 ** int(n))
        ctx.save_for_backward((scaled >= lo) & (scaled <= hi))
        return fake_quant(r, n, bits, unsigned)

    @staticmethod
    def backward(ctx, g):
        inside, = ctx.saved_tensors
        return torch.where(inside, g, torch.zeros_like(g)), None, None, None


def fake_quant_ste(r: torch.Tensor, n: int, bits: int = 8,
                   unsigned: bool = False) -> torch.Tensor:
    """:func:`fake_quant` with a straight-through estimator: the gradient
    passes where ``r * 2^n`` lies inside ``[lo, hi]`` and is 0 where it
    is clipped.  (``fake_quant`` itself has a zero gradient: its
    ``trunc`` has none.)"""
    return _FakeQuantSTE.apply(r, n, bits, unsigned)


def max_frac_bits(x: torch.Tensor) -> int:
    """Eq. (6): ``N^max = ceil(log2(max|x| + 1)) + 1`` integer bits.

    ``max|x| + 1`` is rounded to fp32 as the reference does; its log2 is
    then read exactly off the binary exponent (``frexp``), so no device's
    ``log2`` rounding can move the ceiling at a power of two."""
    t = torch.max(torch.abs(x.to(torch.float32))) + 1.0
    mant, exp = torch.frexp(t)                   # t = mant * 2^exp, mant in [0.5, 1)
    return int(exp) - (1 if float(mant) == 0.5 else 0) + 1


def search_window(x: torch.Tensor, tau: int = 4) -> tuple[int, int]:
    """Algorithm 1 lines 3-5: the narrowed window ``[N^max - tau, N^max]``
    of integer bits, as Python ints (the grid search runs on the host)."""
    nmax = max_frac_bits(x)
    return nmax - tau, nmax


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
