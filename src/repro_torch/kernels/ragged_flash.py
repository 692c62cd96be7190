"""K1 binding: unified ragged paged attention over the KV block pool,
hand-written in CUDA C++ for Hopper (``csrc/ragged_attention.cu``).

Replaces the TPU kernel
``repro/kernels/ragged_flash.py::_ragged_paged_flash_kernel``.  One launch
serves a whole mixed serving step (prefill chunks, decode rows,
speculative tails) from a flattened (T, H, Dk) stream and per-sequence
descriptors.  On an H100 it is bound by the KV bytes each sequence reads,
which at the serving sizes is small enough that the launch itself is the
cost.  The source's header note gives the design: one thread block per
(sequence, KV head, q tile) carrying the whole GQA group, the block table
walked by pointer up to ``kv_len``, int8 codes dequantized in registers
with 2^-n folded into the score scale and the final 1/l.

Descriptor contract (host-built, as ``repro.kernels.ragged_flash``):
``q_start`` nondecreasing, row windows disjoint, ``q_len <= kv_len``,
padding slots with ``q_len == kv_len == 0``.  The output is zero-filled
here, so rows no descriptor covers are exactly 0.  Called through
``kernels.ops.ragged_attention``, which counts launches and takes the
plain version for CPU tensors.
"""
from __future__ import annotations

import ctypes
import math
import struct

import torch

from repro_torch.kernels import _build

__all__ = ["ragged_attention_cuda"]

_NAME = "ragged_attention"
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"ragged_paged_attention_launch": (
    ctypes.c_int, [_P] * 8 + [_I] * 13 + [_P])}

ROWS_PER_BLOCK = 16        # (token, head) rows one block carries
MAX_HEAD_DIM = 256
MAX_BLOCK_SIZE = 128       # kv rows per pool block
MAX_SMEM = 227 * 1024      # dynamic shared memory a block may use
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _f32_bits(x: float) -> int:
    return struct.unpack("<i", struct.pack("<f", x))[0]


def ragged_attention_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, block_tables: torch.Tensor,
                          q_start: torch.Tensor, q_len: torch.Tensor,
                          kv_len: torch.Tensor, *,
                          kv_frac_bits: int) -> torch.Tensor:
    """Launch K1; returns (T, H, Dv) in q's dtype, scores scaled by
    1/sqrt(Dk).  ``kv_frac_bits`` is the int8 pool's fractional bit (0 for
    a float pool).  The grid covers T rows per sequence, so every q_len a
    valid descriptor can hold is served."""
    t, h, dk = q.shape
    nb, bs, kvh, dk_pool = k_pool.shape
    dv = v_pool.shape[-1]
    s, nbmax = block_tables.shape
    dev = q.device
    if dev.type != "cuda" or any(a.device != dev for a in (
            k_pool, v_pool, block_tables, q_start, q_len, kv_len)):
        raise ValueError("ragged_attention_cuda takes CUDA tensors on one "
                         "device")
    if q.dtype not in _Q_CODES or k_pool.dtype not in _KV_CODES \
            or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"K1 takes q float32/bfloat16 and a float32/"
                        f"bfloat16/int8 pool, got q {q.dtype}, pool "
                        f"{k_pool.dtype}/{v_pool.dtype}")
    if dk_pool != dk or v_pool.shape[:3] != k_pool.shape[:3] or h % kvh:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    groups = h // kvh
    if groups > ROWS_PER_BLOCK or max(dk, dv) > MAX_HEAD_DIM \
            or bs > MAX_BLOCK_SIZE:
        raise ValueError(f"K1 carries at most {ROWS_PER_BLOCK} query heads "
                         f"per KV head, head dims <= {MAX_HEAD_DIM} and pool "
                         f"blocks <= {MAX_BLOCK_SIZE}; got groups={groups}, "
                         f"dk={dk}, dv={dv}, bs={bs}")
    # staged per block: q rows, one K page (padded rows), one V page
    if (ROWS_PER_BLOCK * dk + bs * (dk + 1 + dv)) * 4 > MAX_SMEM:
        raise ValueError(f"block size {bs} x head dims ({dk}+{dv}) exceeds "
                         f"the shared memory a block can stage")
    desc = [a.to(torch.int32).contiguous()
            for a in (block_tables, q_start, q_len, kv_len)]
    q, k_pool, v_pool = q.contiguous(), k_pool.contiguous(), v_pool.contiguous()
    out = torch.zeros((t, h, dv), dtype=q.dtype, device=dev)
    tq = max(1, ROWS_PER_BLOCK // groups)
    n_tiles = -(-t // tq)
    score_scale = 2.0 ** (-kv_frac_bits) / math.sqrt(dk)
    lib = _build.load(_NAME, _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ragged_paged_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            *(a.data_ptr() for a in desc), out.data_ptr(),
            h, kvh, dk, dv, s, nbmax, bs, n_tiles, tq,
            _f32_bits(score_scale), int(kv_frac_bits), _Q_CODES[q.dtype],
            _KV_CODES[k_pool.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ragged attention kernel launch failed: CUDA "
                           f"error {err}")
    return out
