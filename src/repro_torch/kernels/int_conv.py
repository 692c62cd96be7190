"""Integer convolution binding: NHWC int8 / uint8 codes x HWIO int8
weights -> NHWC codes in one kernel (implicit GEMM), hand-written in CUDA
C++ for Hopper (``csrc/int_conv.cu``), with K7's residual add as an
optional epilogue.

Replaces no Pallas kernel: the JAX package's ``integer_ops.int_conv2d``
is XLA's integer convolution (``lax.conv_general_dilated``), and its
residual add (``int_residual_add``, K7's Pallas twin) plain ``jnp``.  On
an H100 the kernel is bound by bytes: it reads the input codes through
the convolution's index map straight into shared memory (no im2col matrix
in device memory), multiplies on the int8 tensor cores (``mma.sync``
m16n8k32, s8 or u8 x s8) and runs K2's epilogue (bias align, optional
ReLU, one round-half-away shift-requant, clip) in registers.  With a
shortcut, each code then takes K7's arithmetic with the shortcut's code
at the same NHWC offset (saturating form, ReLU, uint8 out), so a residual
block's add launches nothing of its own.

:func:`plan_int_conv` chooses the tile from the shapes alone, as
``plan_int8_matmul`` does for K2.  Called through
``kernels.ops.int_conv2d``, which counts the launches and takes the plain
version (``kernels.ref.int_conv2d_ref``) for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.core.integer_ops import same_padding
from repro_torch.kernels import _build

__all__ = ["int_conv_cuda", "plan_int_conv", "IntConvPlan", "ResidualShifts",
           "CONV_TILES"]

_NAME = "int_conv"
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"int_conv_launch": (ctypes.c_int, [_P] * 5 + [_I] * 23 + [_P])}
_CODES = (torch.int8, torch.uint8)

# (rows, columns) of the kernel's block tile, by configuration index
# (csrc/int_conv.cu::launch_cfg): for each column width of 16 / 32 / 64
# output channels a taller and a shorter tile of output pixels
CONV_TILES = ((256, 16), (128, 16), (256, 32), (128, 32), (128, 64), (64, 64))


class IntConvPlan(NamedTuple):
    """One launch: tile ``cfg`` of CONV_TILES (``bm`` x ``bn``) over the
    (``m``, ``n``) output matrix in a (``m`` / bm, ``n`` / bn) grid over
    K = ``k`` columns; the output is (B, ``ho``, ``wo``, N) and the input
    is padded by ``pad_h`` (top, bottom) and ``pad_w`` (left, right),
    XLA's "SAME" rule."""
    cfg: int
    bm: int
    bn: int
    grid: tuple
    m: int
    n: int
    k: int
    ho: int
    wo: int
    pad_h: tuple
    pad_w: tuple


class ResidualShifts(NamedTuple):
    """The residual epilogue's shifts (K7's arithmetic): the branch code
    shifted left by ``sa``, the shortcut's by ``sb``, added, ReLU'd,
    requantized by ``shift`` (a negative shift saturating first) and
    clipped to 0..255, the reference's 8-bit unsigned add."""
    sa: int
    sb: int
    shift: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def plan_int_conv(b: int, h: int, w: int, cin: int, cout: int, kh: int,
                  kw: int, stride: int, sm_count: int = 132) -> IntConvPlan:
    """The kernel's launch for a (b, h, w, cin) x (kh, kw, cin, cout)
    convolution at ``stride``, from the shapes alone: a 16-column tile for
    Cout <= 16, 32 for <= 32, else 64 (column tiles repeat past 64), the
    taller of its two tiles while that still gives a block to every SM.
    Cached: a model's forward plans the same few shapes every call."""
    ph, pw = same_padding(h, kh, stride), same_padding(w, kw, stride)
    ho, wo = _cdiv(h, stride), _cdiv(w, stride)
    m, k = b * ho * wo, kh * kw * cin
    first = 0 if cout <= 16 else 2 if cout <= 32 else 4
    tall = CONV_TILES[first]
    tiles = _cdiv(m, tall[0]) * _cdiv(cout, tall[1])
    cfg = first if tiles >= sm_count else first + 1
    bm, bn = CONV_TILES[cfg]
    return IntConvPlan(cfg, bm, bn, (_cdiv(m, bm), _cdiv(cout, bn)), m,
                       cout, k, ho, wo, ph, pw)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_shift(s: int, lo: int, what: str) -> None:
    if not lo <= s <= 31:
        raise ValueError(f"{what} {s} outside the int32 range [{lo}, 31]")


def int_conv_cuda(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                  *, stride: int, shift: int, bias_shift: int, relu: bool,
                  lo: int, hi: int, out_dtype: torch.dtype,
                  shortcut: Optional[torch.Tensor] = None,
                  res: Optional[ResidualShifts] = None) -> torch.Tensor:
    """Launch the convolution kernel on (B, H, W, Cin) int8 / uint8 x
    (KH, KW, Cin, Cout) int8 (+ (Cout,) int8 bias) CUDA tensors with XLA's
    "SAME" padding; returns (B, H', W', Cout) ``out_dtype`` codes.  With
    ``shortcut`` ((B, H', W', Cout) int8 / uint8) and ``res``, each code
    then takes the residual epilogue."""
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError("int_conv_cuda takes CUDA tensors on one device")
    if x.dtype not in _CODES or w.dtype != torch.int8:
        raise TypeError(f"the convolution takes int8 or uint8 x int8 codes, "
                        f"got {x.dtype} x {w.dtype}")
    if out_dtype not in _CODES:
        raise TypeError(f"the convolution emits int8 / uint8 codes, not "
                        f"{out_dtype}")
    if x.ndim != 4 or w.ndim != 4 or x.shape[3] != w.shape[2]:
        raise ValueError(f"shape mismatch NHWC {tuple(x.shape)} x HWIO "
                         f"{tuple(w.shape)}")
    if stride < 1:
        raise ValueError(f"stride {stride} < 1")
    _check_shift(shift, -31, "requant shift")
    _check_shift(bias_shift, -31, "bias shift")
    bsz, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    plan = plan_int_conv(bsz, h, wd, cin, cout, kh, kw, stride,
                         _sm_count(x.device.index or 0))
    out_shape = (bsz, plan.ho, plan.wo, cout)
    if (shortcut is None) != (res is None):
        raise ValueError("the residual epilogue takes a shortcut and its "
                         "shifts together")
    sc_args = (None, 0, 0, 0, 0)
    if shortcut is not None:
        if shortcut.device != x.device or shortcut.dtype not in _CODES:
            raise ValueError("the shortcut must be int8 / uint8 codes on "
                             "the input's device")
        if tuple(shortcut.shape) != out_shape:
            raise ValueError(f"shortcut {tuple(shortcut.shape)} is not the "
                             f"output's shape {out_shape}")
        _check_shift(res.sa, 0, "shortcut shift sa")
        _check_shift(res.sb, 0, "shortcut shift sb")
        _check_shift(res.shift, -31, "residual requant shift")
        shortcut = shortcut.contiguous()
        sc_args = (shortcut.data_ptr(), int(shortcut.dtype == torch.uint8),
                   int(res.sa), int(res.sb), int(res.shift))
    x, w = x.contiguous(), w.contiguous()
    if b is not None:
        if b.dtype != torch.int8 or b.shape != (cout,) or b.device != x.device:
            raise ValueError("bias must be (Cout,) int8 codes on the same "
                             "device")
        b = b.contiguous()
    out = torch.empty(out_shape, dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load(_NAME, _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.int_conv_launch(
            x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            out.data_ptr(), sc_args[0], bsz, h, wd, cin, cout, kh, kw,
            int(stride), plan.pad_h[0], plan.pad_w[0], plan.ho, plan.wo,
            int(shift), int(bias_shift), int(relu), int(lo), int(hi),
            int(x.dtype == torch.uint8), *sc_args[1:], plan.cfg, stream)
    if err != 0:
        raise RuntimeError(f"int_conv kernel launch failed: CUDA error {err}")
    return out
