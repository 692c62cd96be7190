"""K7 binding: the fused residual add of Fig. 1(c)/(d) on 8-bit codes,
hand-written in CUDA C++ for Hopper (``csrc/residual_requant.cu``).

Replaces the TPU kernel
``repro/kernels/residual_requant.py::residual_requant_kernel``.  It is
every residual add of the ResNet's integer forward.  Each operand is int8
or uint8; both are aligned onto the finer grid in int32, added,
optionally ReLU'd and requantized once, in one pass bound by bytes.  A
negative requant shift wraps (the TPU kernel's semantics) or, with
``saturate``, saturates first (``integer_ops.int_residual_add``'s).

Called through ``kernels.ops.residual_requant``, which counts the
launches and takes the plain version (``kernels.ref.residual_requant_ref``)
for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["residual_requant_cuda"]

_NAME = "residual_requant"
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"residual_requant_launch": (
    ctypes.c_int, [_P, _P, _P, ctypes.c_longlong] + [_I] * 9 + [_P])}
_CODES = (torch.int8, torch.uint8)


def residual_requant_cuda(a: torch.Tensor, b: torch.Tensor, *, sa: int,
                          sb: int, shift: int, relu: bool, lo: int, hi: int,
                          saturate: bool) -> torch.Tensor:
    """Launch K7 on two same-shape int8/uint8 CUDA tensors: codes
    ``clip(requant((a << sa) + (b << sb) [ReLU], shift), lo, hi)``, uint8
    with ``relu``, else int8."""
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError("residual_requant_cuda takes CUDA tensors on one "
                         "device")
    if a.dtype not in _CODES or b.dtype not in _CODES:
        raise TypeError(f"K7 takes int8 or uint8 codes, got {a.dtype} + "
                        f"{b.dtype}")
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {tuple(a.shape)} + {tuple(b.shape)}")
    if not (0 <= sa <= 31 and 0 <= sb <= 31 and -31 <= shift <= 31):
        raise ValueError(f"shifts ({sa}, {sb}, {shift}) outside the int32 "
                         "range")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty(a.shape, dtype=torch.uint8 if relu else torch.int8,
                      device=a.device)
    if a.numel() == 0:
        return out
    lib = _build.load(_NAME, _SIGNATURES)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.residual_requant_launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(),
            int(a.dtype == torch.uint8), int(b.dtype == torch.uint8),
            int(sa), int(sb), int(shift), int(relu), int(lo), int(hi),
            int(saturate), stream)
    if err != 0:
        raise RuntimeError(
            f"residual_requant kernel launch failed: CUDA error {err}")
    return out
