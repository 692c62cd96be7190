"""K3 binding: elementwise Eq.-1 quantization (float -> integer codes),
hand-written in CUDA C++ for Hopper (``csrc/quantize.cu``).

Replaces the TPU kernel ``repro/kernels/quantize.py::quantize_kernel``.
It quantizes the ResNet's image input and its pooled head input.  One
pass over memory, bound by bytes; ties round half away from zero and the
product and the add keep their own fp32 roundings, so the codes equal
``kernels.ref.quantize_ref`` (and ``qscheme.quant``) bit for bit.

Called through ``kernels.ops.quantize_act``, which counts the launches
and takes the plain version for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["quantize_cuda"]

_NAME = "quantize"
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"quantize_launch": (
    ctypes.c_int, [_P, _P, ctypes.c_longlong, _I, _I, ctypes.c_float, _I, _I,
                   _P])}


def quantize_cuda(x: torch.Tensor, *, n: int, lo: int, hi: int,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """Launch K3 on a float32 or bfloat16 CUDA tensor: codes
    ``clip(trunc(x * 2^n +- 0.5), lo, hi)`` as ``out_dtype`` (int8, uint8
    or int32), same shape."""
    if x.device.type != "cuda":
        raise ValueError("quantize_cuda takes a CUDA tensor")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K3 takes float32 or bfloat16, got {x.dtype}")
    if out_dtype not in (torch.int8, torch.uint8, torch.int32):
        raise TypeError(f"K3 emits int8, uint8 or int32 codes, not {out_dtype}")
    if not -126 <= n <= 127:
        raise ValueError(f"fractional bit {n} outside fp32's exponent range")
    x = x.contiguous()
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if x.numel() == 0:
        return out
    lib = _build.load(_NAME, _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.quantize_launch(
            x.data_ptr(), out.data_ptr(), x.numel(),
            int(x.dtype == torch.bfloat16), int(out_dtype == torch.int32),
            2.0 ** int(n), int(lo), int(hi), stream)
    if err != 0:
        raise RuntimeError(f"quantize kernel launch failed: CUDA error {err}")
    return out
