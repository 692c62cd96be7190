"""K5 and K6 bindings: causal flash prefill and one-token flash decode over
a dense (B, S, KVH, D) KV cache, hand-written in CUDA C++ for Hopper
(``csrc/flash_attention.cu``); and K4's: paged attention over the serving
engine's KV block pool (``csrc/paged_attention.cu``), as the JAX file
keeps the paged decode kernel beside the dense ones.

Replace the TPU kernels ``repro/kernels/flash_attention.py::
_flash_prefill_kernel`` (K5) and ``_flash_decode_kernel`` (K6).  K5 serves
the dense-cache prefill and calibration's forward, K6 every decode step of
the classic serve path, both under ``attn_kernel='flash'``.  The cache may
hold int8 Eq.-1 codes (dequantized in registers, the grid's 2^-n folded
into the score scale and the final 1/l) or floats.  The source's header
note gives the design and what bounds each kernel.

K4 replaces ``_paged_flash_decode_kernel``: q (B, C, H, Dk) at per-token
positions attends over the pool blocks each slot's table names, for every
C (the legacy engine's decode, prefill-chunk and speculative-verify
shapes), the table walked by pointer, never gathered.

Called through ``kernels.ops.flash_attention`` / ``flash_decode`` /
``paged_attention``, which count the launches and take the plain versions
(``kernels.ref``) for CPU tensors.
"""
from __future__ import annotations

import ctypes
import math
import struct

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import DEFAULT_MASK_VALUE

__all__ = ["flash_prefill_cuda", "flash_decode_cuda", "paged_attention_cuda"]

_NAME = "flash_attention"
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "flash_prefill_launch": (ctypes.c_int, [_P] * 4 + [_I] * 12 + [_P]),
    "flash_decode_launch": (ctypes.c_int, [_P] * 4 + [_I] * 13 + [_P]),
}
_PAGED_NAME = "paged_attention"
_PAGED_SIGNATURES = {"paged_attention_launch": (
    ctypes.c_int, [_P] * 6 + [_I] * 12 + [_P])}
MAX_HEAD_DIM = 256
PREFILL_ROWS = 64          # (position, head) rows a K5 block carries
DECODE_MAX_GROUPS = 16     # query heads per KV head K6 carries
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _f32_bits(x: float) -> int:
    return struct.unpack("<i", struct.pack("<f", x))[0]


def _check(name, q, k, v, max_groups):
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if q.dtype not in _Q_CODES or k.dtype not in _KV_CODES \
            or v.dtype != k.dtype:
        raise TypeError(f"{name} takes q float32/bfloat16 and float32/"
                        f"bfloat16/int8 K/V, got q {q.dtype}, K/V "
                        f"{k.dtype}/{v.dtype}")
    b, _, h, dk = q.shape
    if k.ndim != 4 or v.ndim != 4 or k.shape[0] != b or k.shape[3] != dk \
            or v.shape[:3] != k.shape[:3] or h % k.shape[2]:
        raise ValueError(f"{name}: shape mismatch q {tuple(q.shape)}, K "
                         f"{tuple(k.shape)}, V {tuple(v.shape)}")
    if h // k.shape[2] > max_groups or max(dk, v.shape[3]) > MAX_HEAD_DIM:
        raise ValueError(f"{name} carries at most {max_groups} query heads "
                         f"per KV head and head dims <= {MAX_HEAD_DIM}; got "
                         f"groups={h // k.shape[2]}, dk={dk}, "
                         f"dv={v.shape[3]}")


def _launch(entry: str, *args, name=_NAME, signatures=_SIGNATURES) -> None:
    lib = _build.load(name, signatures)
    err = getattr(lib, entry)(*args)
    if err != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {err}")


def flash_prefill_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       kv_frac_bits: int) -> torch.Tensor:
    """Launch K5: causal attention of q (B, Sq, H, Dk) over K/V
    (B, Skv, KVH, D) with q at positions 0..Sq-1; returns (B, Sq, H, Dv)
    in q's dtype.  ``kv_frac_bits`` is the int8 cache's fractional bit (0
    for floats)."""
    _check("flash_prefill_cuda", q, k, v, PREFILL_ROWS)
    b, sq, h, dk = q.shape
    skv, kvh, dv = k.shape[1], k.shape[2], v.shape[3]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=q.device)
    score_scale = 2.0 ** (-kv_frac_bits) / math.sqrt(dk)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch("flash_prefill_launch", q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), b, sq, skv, h, kvh, dk, dv,
                _f32_bits(score_scale), int(kv_frac_bits),
                _f32_bits(DEFAULT_MASK_VALUE), _Q_CODES[q.dtype],
                _KV_CODES[k.dtype], stream)
    return out


def flash_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      pos: int, kv_frac_bits: int) -> torch.Tensor:
    """Launch K6: q (B, 1, H, Dk) at absolute position ``pos`` over the
    cache (B, S_max, KVH, D), kv rows ``<= pos`` visible; returns
    (B, 1, H, Dv) in q's dtype.  The kernel reads the cache only up to
    ``pos``."""
    _check("flash_decode_cuda", q, k, v, DECODE_MAX_GROUPS)
    b, sq, h, dk = q.shape
    s_max, kvh, dv = k.shape[1], k.shape[2], v.shape[3]
    if sq != 1:
        raise ValueError(f"flash_decode_cuda is the q_len=1 kernel, got "
                         f"q_len={sq}")
    if not 0 <= pos < s_max:
        raise ValueError(f"pos {pos} outside the cache [0, {s_max})")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty((b, 1, h, dv), dtype=q.dtype, device=q.device)
    bk = 128 if max(dk, dv) <= 128 else 64     # kv rows a tile
    score_scale = 2.0 ** (-kv_frac_bits) / math.sqrt(dk)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch("flash_decode_launch", q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), b, s_max, h, kvh, dk, dv, bk,
                int(pos), _f32_bits(score_scale), int(kv_frac_bits),
                _f32_bits(DEFAULT_MASK_VALUE), _Q_CODES[q.dtype],
                _KV_CODES[k.dtype], stream)
    return out


def paged_attention_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                         v_pool: torch.Tensor, block_tables: torch.Tensor,
                         q_positions: torch.Tensor, *, kv_frac_bits: int,
                         scale: float) -> torch.Tensor:
    """Launch K4: q (B, C, H, Dk) at positions ``q_positions`` (B, C) over
    the pool (NB, bs, KVH, D) through ``block_tables`` (B, W), kv rows
    ``<= position`` visible, scores times ``scale``; returns (B, C, H, Dv)
    in q's dtype.  The table's width is read from its shape.  Head dims
    are multiples of 16 (16-byte rows for every pool type)."""
    dev = q.device
    if dev.type != "cuda" or any(a.device != dev for a in (
            k_pool, v_pool, block_tables, q_positions)):
        raise ValueError("paged_attention_cuda takes CUDA tensors on one "
                         "device")
    if q.dtype not in _Q_CODES or k_pool.dtype not in _KV_CODES \
            or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"K4 takes q float32/bfloat16 and a float32/"
                        f"bfloat16/int8 pool, got q {q.dtype}, pool "
                        f"{k_pool.dtype}/{v_pool.dtype}")
    b, c, h, dk = q.shape
    _, bs, kvh, dk_pool = k_pool.shape
    dv = v_pool.shape[-1]
    w = block_tables.shape[1]
    if dk_pool != dk or v_pool.shape[:3] != k_pool.shape[:3] or h % kvh \
            or block_tables.shape[0] != b or q_positions.shape != (b, c):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}, "
                         f"tables {tuple(block_tables.shape)}, positions "
                         f"{tuple(q_positions.shape)}")
    if dk % 16 or dv % 16 or max(dk, dv) > MAX_HEAD_DIM:
        raise ValueError(f"K4 takes head dims that are multiples of 16 up to "
                         f"{MAX_HEAD_DIM}; got dk={dk}, dv={dv}")
    out = torch.empty((b, c, h, dv), dtype=q.dtype, device=dev)
    bt = block_tables.to(torch.int32).contiguous()
    pos = q_positions.to(torch.int32).contiguous()
    q, k_pool, v_pool = q.contiguous(), k_pool.contiguous(), v_pool.contiguous()
    score_scale = scale * 2.0 ** (-kv_frac_bits)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch("paged_attention_launch", q.data_ptr(), k_pool.data_ptr(),
                v_pool.data_ptr(), bt.data_ptr(), pos.data_ptr(),
                out.data_ptr(), b, c, h, kvh, dk, dv, w, bs,
                _f32_bits(score_scale), int(kv_frac_bits), _Q_CODES[q.dtype],
                _KV_CODES[k_pool.dtype], stream, name=_PAGED_NAME,
                signatures=_PAGED_SIGNATURES)
    return out
