"""K2 binding: int8 x int8 -> int32 matmul with the fused bit-shift
requant epilogue, hand-written in CUDA C++ for Hopper
(``csrc/int8_matmul.cu``).

Replaces the TPU kernel ``repro/kernels/int8_matmul.py::int8_matmul_kernel``.
On an H100 it is bound by the bytes of the int8 weight codes at the
serving shapes; the epilogue (bias align, optional ReLU, round-half-away
shift-requant with a saturating negative shift, clip) runs in registers,
so the int32 accumulator never reaches device memory.  The source's
header note gives the design, and why it does not reach the weight-byte
bound yet (one pass over the weights per 16 stream rows).

The kernel takes the weight codes in their public (K, N) layout and
transposes each tile in shared memory, so no second copy of the weights
exists.  Called through ``kernels.ops.int8_matmul``, which counts the
launches and takes the plain version (``kernels.ref.int8_matmul_ref``)
for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

__all__ = ["int8_matmul_cuda"]

_NAME = "int8_matmul"
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"int8_matmul_launch": (
    ctypes.c_int, [_P, _P, _P, _P] + [_I] * 10 + [_P])}


def int8_matmul_cuda(x2: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor], *, shift: int,
                     bias_shift: int, relu: bool, lo: int, hi: int,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """Launch K2 on (M, K) int8 x (K, N) int8 (+ (N,) int8 bias) CUDA
    tensors; returns (M, N) ``out_dtype`` (int8 or uint8) codes."""
    if x2.device.type != "cuda" or w.device != x2.device:
        raise ValueError("int8_matmul_cuda takes CUDA tensors on one device")
    if x2.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"K2 takes int8 codes, got {x2.dtype} x {w.dtype}")
    if x2.ndim != 2 or w.ndim != 2 or x2.shape[1] != w.shape[0]:
        raise ValueError(f"shape mismatch {tuple(x2.shape)} x {tuple(w.shape)}")
    if out_dtype not in (torch.int8, torch.uint8):
        raise TypeError(f"K2 emits int8 or uint8 codes, not {out_dtype}")
    for s in (shift, bias_shift):
        if not -31 <= s <= 31:
            raise ValueError(f"shift {s} outside the int32 range [-31, 31]")
    m, k = x2.shape
    n = w.shape[1]
    x2, w = x2.contiguous(), w.contiguous()
    if b is not None:
        if b.dtype != torch.int8 or b.shape != (n,) or b.device != x2.device:
            raise ValueError("bias must be (N,) int8 codes on the same device")
        b = b.contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=x2.device)
    vec = int(k % 4 == 0 and n % 4 == 0 and x2.data_ptr() % 4 == 0
              and w.data_ptr() % 4 == 0)
    lib = _build.load(_NAME, _SIGNATURES)
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        err = lib.int8_matmul_launch(
            x2.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            out.data_ptr(), m, n, k, int(shift), int(bias_shift), int(relu),
            int(lo), int(hi), int(out_dtype == torch.uint8), vec, stream)
    if err != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: CUDA error {err}")
    return out
