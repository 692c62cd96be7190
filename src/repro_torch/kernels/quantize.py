"""K3 binding: elementwise Eq.-1 quantization (float -> integer codes),
hand-written in CUDA C++ for Hopper (``csrc/quantize.cu``).

Replaces the TPU kernel ``repro/kernels/quantize.py::quantize_kernel``.
Two forms, one arithmetic: :func:`quantize_multi_cuda` (one read, int8
or uint8 codes on up to three grids: the LM path's module input, and on
one grid the ResNet's image and pooled head input and the weights
quantized at run time) and :func:`quantize_scatter_cuda` (the LM path's
K/V write: codes stored straight to their pool rows).  One pass over
memory, bound by bytes and at the engine's shapes by the launch; ties
round half away from zero and the product and the add keep their own fp32
roundings, so the codes equal ``kernels.ref.quantize_ref`` (and
``qscheme.quant``) bit for bit.

Called through ``kernels.ops`` (``quantize_act``, ``quantize_multi``,
``quantize_scatter``), which counts the launches and takes the plain
versions for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

__all__ = ["quantize_multi_cuda", "quantize_scatter_cuda", "MAX_GRIDS"]

_NAME = "quantize"
_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_SIGNATURES = {
    "quantize_multi_launch": (_I, [_P, _LL, _I, _I, _F, _F, _F, _P, _P, _P,
                                   _I, _I, _I, _P]),
    "quantize_scatter_launch": (_I, [_P, _P, _P, _I, _I, _I, _LL, _I, _F,
                                     _I, _I, _P, _P, _P]),
}
MAX_GRIDS = 3             # grids one multi-grid launch writes
_THREADS_PER_SM = 2048    # resident threads an H100 SM holds: one wave


@functools.lru_cache(maxsize=None)
def _wave_blocks(index: int) -> int:
    """Blocks of the kernel's 256 threads that one wave of the card holds."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms * (_THREADS_PER_SM // 256)


def _check_float(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} takes CUDA tensors")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K3 takes float32 or bfloat16, got {x.dtype}")


def _check_n(n: int) -> None:
    if not -126 <= n <= 127:
        raise ValueError(f"fractional bit {n} outside fp32's exponent range")


def quantize_multi_cuda(x: torch.Tensor, ns, *, lo: int, hi: int,
                        out_dtype: torch.dtype = torch.int8
                        ) -> tuple[torch.Tensor, ...]:
    """One K3 launch over a float32 or bfloat16 CUDA tensor: its codes
    ``clip(trunc(x * 2^n +- 0.5), lo, hi)`` on each of the distinct grids
    ``ns`` (at most :data:`MAX_GRIDS`), one ``out_dtype`` (int8 or uint8,
    holding lo..hi) tensor of x's shape a grid, in the order of ``ns``."""
    _check_float(x, "quantize_multi_cuda")
    ns = [int(n) for n in ns]
    if not 1 <= len(ns) <= MAX_GRIDS or len(set(ns)) != len(ns):
        raise ValueError(f"K3 writes 1..{MAX_GRIDS} distinct grids, got {ns}")
    byte = {torch.int8: (-128, 127), torch.uint8: (0, 255)}.get(out_dtype)
    if byte is None or not byte[0] <= lo <= hi <= byte[1]:
        raise ValueError(f"K3 emits int8 or uint8 codes, not [{lo}, {hi}] "
                         f"as {out_dtype}")
    for n in ns:
        _check_n(n)
    x = x.contiguous()
    outs = tuple(torch.empty(x.shape, dtype=out_dtype, device=x.device)
                 for _ in ns)
    if x.numel() == 0:
        return outs
    scales = [2.0 ** n for n in ns] + [1.0] * (MAX_GRIDS - len(ns))
    ptrs = [o.data_ptr() for o in outs] + [None] * (MAX_GRIDS - len(ns))
    lib = _build.load(_NAME, _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.quantize_multi_launch(
            x.data_ptr(), x.numel(), int(x.dtype == torch.bfloat16), len(ns),
            *scales, *ptrs, int(lo), int(hi),
            _wave_blocks(x.device.index or 0), stream)
    if err != 0:
        raise RuntimeError(f"quantize_multi kernel launch failed: CUDA error "
                           f"{err}")
    return outs


def quantize_scatter_cuda(k: torch.Tensor, v: torch.Tensor,
                          index: torch.Tensor, k_rows: torch.Tensor,
                          v_rows: torch.Tensor, *, n: int, lo: int,
                          hi: int) -> None:
    """One K3 launch: K and V (R, W) float32 / bfloat16 CUDA rows
    quantized on the grid ``n`` and stored IN PLACE to rows ``index`` (R,)
    (int32 or int64, read on the card) of the int8 pools ``k_rows`` /
    ``v_rows`` (P, W), which must be contiguous (views of the
    pool tensors).  Rows that share an index race: which one's codes land
    is unspecified, word by word, as with ``index_copy_``."""
    _check_float(k, "quantize_scatter_cuda")
    _check_n(int(n))
    if v.dtype != k.dtype or v.shape != k.shape or k.ndim != 2:
        raise ValueError(f"K and V must be (R, W) of one float type, got "
                         f"{tuple(k.shape)} {k.dtype} and {tuple(v.shape)} "
                         f"{v.dtype}")
    rows, width = k.shape
    if index.dtype not in (torch.int32, torch.int64) or index.shape != (rows,):
        raise ValueError(f"index must be ({rows},) int32 or int64, got "
                         f"{tuple(index.shape)} {index.dtype}")
    for pool in (k_rows, v_rows):
        if (pool.dtype != torch.int8 or pool.ndim != 2
                or pool.shape[1] != width or not pool.is_contiguous()):
            raise ValueError(f"pools must be contiguous (P, {width}) int8 "
                             f"views, got {tuple(pool.shape)} {pool.dtype}")
    if v_rows.shape != k_rows.shape:
        raise ValueError("the K and V pools differ in shape")
    if len({t.device for t in (k, v, index, k_rows, v_rows)}) != 1:
        raise ValueError("quantize_scatter_cuda takes tensors on one device")
    if rows == 0:
        return
    k, v, index = k.contiguous(), v.contiguous(), index.contiguous()
    lib = _build.load(_NAME, _SIGNATURES)
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream(k.device).cuda_stream
        err = lib.quantize_scatter_launch(
            k.data_ptr(), v.data_ptr(), index.data_ptr(),
            int(index.dtype == torch.int64), rows, width, k_rows.shape[0],
            int(k.dtype == torch.bfloat16), 2.0 ** int(n), int(lo), int(hi),
            k_rows.data_ptr(), v_rows.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"quantize_scatter kernel launch failed: CUDA "
                           f"error {err}")
