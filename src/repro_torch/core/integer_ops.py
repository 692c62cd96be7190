"""Integer-arithmetic-only inference ops — Eq. (2)-(4) of the paper.

PyTorch counterpart of ``repro.core.integer_ops``: ``int_linear``,
``int_conv2d`` (NHWC x HWIO, XLA's "SAME" padding), ``int_residual_add``
and their shift bookkeeping.  Every op takes and returns integer codes.

On a CPU tensor each op is plain PyTorch.  The product's accumulator is
exact: PyTorch has no int32 matrix product on CUDA and no BLAS behind
its int64 one on the CPU, so the product runs in float64, which is exact
for |acc| < 2^53 (K * 255 * 128 stays far below), and is then cast to
int32; a convolution is that product over an im2col gather.  On a CUDA
tensor the ops launch the hand-written kernels through ``kernels.ops``:
K2 for ``int_linear``, the convolution kernel for ``int_conv2d`` (no
gather; a residual add behind it in the same launch), K7 for
``int_residual_add``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.qscheme import shift_requant

__all__ = ["LinearQuantSpec", "bias_align", "int_linear", "int_conv2d",
           "int_residual_add", "same_padding", "im2col_same"]


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
    ``spec.out_unsigned``).  ``x_int`` may hold uint8 post-ReLU codes.
    """
    if x_int.device.type == "cuda":
        from repro_torch.kernels import ops
        return ops.int8_matmul(x_int, w_int, b_int, spec, relu=apply_relu)
    acc = torch.matmul(x_int.to(torch.float64),
                       w_int.to(torch.float64)).to(torch.int32)
    if b_int is not None:
        acc = acc + bias_align(b_int, spec.bias_shift)
    if apply_relu:
        acc = torch.clamp(acc, min=0)
    return shift_requant(acc, spec.requant_shift, bits=spec.bits,
                         unsigned=spec.out_unsigned and apply_relu)


def same_padding(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial axis: ``(lo, hi)`` with
    ``out = ceil(size / stride)``, ``total = max((out - 1) * stride + k -
    size, 0)``, ``lo = total // 2`` (a stride-2 3x3 convolution on an
    even size pads (0, 1), not 1 on each side)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def im2col_same(x: torch.Tensor, kh: int, kw: int, stride: int
                ) -> tuple[torch.Tensor, tuple[int, int, int]]:
    """The im2col gather of an NHWC tensor under "SAME" padding (zeros):
    a contiguous ``(B * H' * W', kh * kw * C)`` matrix whose columns are
    ordered (kernel row, kernel column, channel), the row-major order of an
    HWIO weight reshaped to ``(kh * kw * C, Cout)``; and ``(B, H', W')``."""
    bsz, h, w, c = x.shape
    ph, pw = same_padding(h, kh, stride), same_padding(w, kw, stride)
    xp = torch.nn.functional.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    win = xp.unfold(1, kh, stride).unfold(2, kw, stride)  # B,H',W',C,kh,kw
    ho, wo = win.shape[1], win.shape[2]
    cols = win.permute(0, 1, 2, 4, 5, 3).reshape(bsz * ho * wo, kh * kw * c)
    return cols, (bsz, ho, wo)


def int_conv2d(x_int: torch.Tensor, w_int: torch.Tensor,
               b_int: Optional[torch.Tensor], spec: LinearQuantSpec,
               stride: int = 1, padding: str = "SAME",
               apply_relu: bool = False,
               residual: Optional[tuple] = None) -> torch.Tensor:
    """Integer-only 2-D convolution (Eq. 2/3), NHWC x HWIO -> NHWC.

    int8 (or uint8 post-ReLU) input codes, int8 weights, int32
    accumulation, bias align + a single shift requant (+ optional fused
    ReLU per Fig. 1(b)).  Only the reference's "SAME" padding is taken.

    ``residual = (shortcut, n_a, n_b, n_o)`` fuses Fig. 1(c) behind it:
    the convolution's codes (grid ``n_a``) and the shortcut's (``n_b``)
    through :func:`int_residual_add` with ReLU at its default 8 bits (as
    the reference's forward calls it), uint8 codes on ``n_o``.
    On the CPU those are the two calls; on CUDA one launch of the
    convolution kernel, its residual epilogue doing the add.
    """
    if padding != "SAME":
        raise ValueError(f"int_conv2d takes padding='SAME', not {padding!r}")
    if x_int.device.type == "cuda":
        from repro_torch.kernels import ops
        return ops.int_conv2d(x_int, w_int, b_int, spec, stride=stride,
                              relu=apply_relu, residual=residual)
    kh, kw, cin, cout = w_int.shape
    cols, (bsz, ho, wo) = im2col_same(x_int, kh, kw, stride)
    y = int_linear(cols, w_int.reshape(kh * kw * cin, cout), b_int, spec,
                   apply_relu).reshape(bsz, ho, wo, cout)
    if residual is None:
        return y
    shortcut, n_a, n_b, n_o = residual
    return int_residual_add(y, n_a, shortcut, n_b, n_o, apply_relu=True)


def int_residual_add(a_int: torch.Tensor, n_a: int, b_int: torch.Tensor,
                     n_b: int, n_o: int, bits: int = 8,
                     apply_relu: bool = False) -> torch.Tensor:
    """Fig. 1(c)/(d): residual addition of two codes on different grids.

    Both operands are left-shifted onto the finer common grid
    ``n_hi = max(n_a, n_b)`` (int32, wrapping as the reference's ``<<``),
    added, then requantized once by ``n_hi - n_o`` with
    ``qscheme.shift_requant`` (a negative shift saturates first).  With
    ReLU (case c) the sign check happens on the int32 sum and the output
    is unsigned.  On CUDA, K7 in its saturating form.
    """
    if a_int.device.type == "cuda":
        from repro_torch.kernels import ops
        return ops.residual_requant(a_int, b_int, n_a=n_a, n_b=n_b, n_o=n_o,
                                    bits=bits, relu=apply_relu, saturate=True)
    n_hi = max(n_a, n_b)
    acc = (a_int.to(torch.int32) << (n_hi - n_a)) + \
        (b_int.to(torch.int32) << (n_hi - n_b))
    if apply_relu:
        acc = torch.clamp(acc, min=0)
    return shift_requant(acc, n_hi - n_o, bits=bits, unsigned=apply_relu)
