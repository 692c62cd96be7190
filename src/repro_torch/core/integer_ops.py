"""Integer-arithmetic-only linear op — Eq. (2)-(4) of the paper.

PyTorch counterpart of ``repro.core.integer_ops`` (``int_linear`` and its
shift bookkeeping).  Every op takes and returns integer codes; the
accumulator is exact: PyTorch has no int32 matrix product on CUDA and no
BLAS behind its int64 one on the CPU, so the product runs in float64,
which is exact for |acc| < 2^53 (K * 128 * 128 stays far below), and is
then cast to int32.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.qscheme import shift_requant

__all__ = ["LinearQuantSpec", "bias_align", "int_linear"]


@dataclasses.dataclass(frozen=True)
class LinearQuantSpec:
    """Shift bookkeeping for one unified module (Eq. 3).

    n_x, n_w, n_b, n_o are fractional bits of input, weight, bias, output.
      bias_shift    = (n_x + n_w) - n_b   (align bias to the int32 acc)
      requant_shift = (n_x + n_w) - n_o   (right-shift acc to the n-bit code)
    """

    n_x: int
    n_w: int
    n_b: int
    n_o: int
    bits: int = 8
    out_unsigned: bool = False  # Fig. 1(b): post-ReLU output is unsigned

    @property
    def bias_shift(self) -> int:
        return (self.n_x + self.n_w) - self.n_b

    @property
    def requant_shift(self) -> int:
        return (self.n_x + self.n_w) - self.n_o


def bias_align(b_int: torch.Tensor, bias_shift: int) -> torch.Tensor:
    """Align an int8 bias code with the int32 accumulator grid (Eq. 3):
    a left shift for ``bias_shift >= 0``, else a round-half-away right
    shift by ``-bias_shift`` (the bias grid is finer than the acc's)."""
    b = b_int.to(torch.int32)
    if bias_shift >= 0:
        return b << int(bias_shift)
    return shift_requant(b, -int(bias_shift), bits=32)


def int_linear(x_int: torch.Tensor, w_int: torch.Tensor,
               b_int: Optional[torch.Tensor], spec: LinearQuantSpec,
               apply_relu: bool = False) -> torch.Tensor:
    """Integer-only linear layer: int8 x @ int8 w -> int32 -> shift -> int8.

    x_int: (..., K) codes, w_int: (K, N) int8 codes, b_int: (N,) int8.
    ``apply_relu`` is Fig. 1(b): ReLU on the int32 accumulator before the
    single requantization (the output is then unsigned when
    ``spec.out_unsigned``).
    """
    acc = torch.matmul(x_int.to(torch.float64),
                       w_int.to(torch.float64)).to(torch.int32)
    if b_int is not None:
        acc = acc + bias_align(b_int, spec.bias_shift)
    if apply_relu:
        acc = torch.clamp(acc, min=0)
    return shift_requant(acc, spec.requant_shift, bits=spec.bits,
                         unsigned=spec.out_unsigned and apply_relu)
