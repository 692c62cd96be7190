"""K5 and K6 bindings: flash prefill (causal, or non-causal for whisper's
encoder and cross-attention) and one-token flash decode over a dense
(B, S, KVH, D) KV cache, hand-written in CUDA C++ for Hopper
(``csrc/flash_attention.cu``); and K4's: paged attention over the serving
engine's KV block pool (``csrc/paged_attention.cu``), as the JAX file
keeps the paged decode kernel beside the dense ones.

K5 replaces the TPU kernel ``repro/kernels/flash_attention.py::
_flash_prefill_kernel`` and K6 ``_flash_decode_kernel``.  K5 serves the
dense-cache prefill and calibration's forward (non-causal: the audio
family's encoder and the cross-attention over its memory), K6 every
decode step of the classic serve path (the cross-attention's too, one
query over every memory row at the fixed position S_enc - 1), both under
``attn_kernel='flash'``.  The cache may
hold int8 Eq.-1 codes (converted exactly on their way to the products,
the grid's 2^-n folded into the score scale and the final 1/l) or floats.

- K5 on bf16 q runs both products on the tensor cores (``mma.sync``
  m16n8k16, bf16 in, fp32 accumulate); a long prefill is bound by those
  operations.  K5 on fp32 q keeps the CUDA-core kernel (TF32 would miss
  the fp32 tolerance).
- K6 is bound by the bytes of the cache up to ``pos``.  It splits the
  cache's rows into chunks, one block each, and a second small kernel
  merges the blocks' partial softmax states.  ``pos`` is a 0-d int32
  tensor on the card that every block reads, as the TPU kernel takes it
  by scalar prefetch, so the host never reads it and one launch captured
  in a CUDA graph serves every position.  :func:`plan_decode_splits`
  chooses the chunks on the host from the cache length S_max, ``B * KVH``
  and the SM count; a block whose chunk starts past ``pos`` reads nothing
  and its (empty) partial weighs 0.

The source's header note gives each design, what bounds it and what is
left.

K4 replaces ``_paged_flash_decode_kernel``: q (B, C, H, Dk) at per-token
positions attends over the pool blocks each slot's table names, for every
C (the legacy engine's decode, prefill-chunk and speculative-verify
shapes), the table walked by pointer, never gathered.  It runs K1's body
(``csrc/paged_kv_attention.cuh``) on K1's work-list layout:
:func:`plan_paged_work` lists the items from the host positions, a long
range split into chunks merged by a combine kernel.  The legacy engine
plans once per dispatch and every layer shares the list (padded to
:func:`paged_capacity` when the step is replayed from a CUDA graph); a
caller without a plan gets one from :func:`paged_plan_from_positions`,
which reads the positions back to the host.

Called through ``kernels.ops.flash_attention`` / ``flash_decode`` /
``paged_attention``, which count the launches and take the plain versions
(``kernels.ref``) for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
import math
import struct
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ragged_flash import (ITEM_COLS, MAX_BLOCK_SIZE,
                                              ROWS_PER_ITEM, RaggedWork,
                                              WorkCapacity, _capacity,
                                              _Planner)
from repro_torch.kernels.ref import DEFAULT_MASK_VALUE

__all__ = ["flash_prefill_cuda", "flash_decode_cuda", "paged_attention_cuda",
           "plan_decode_splits", "plan_paged_work", "paged_capacity",
           "paged_plan_from_positions"]

_NAME = "flash_attention"
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "flash_prefill_launch": (ctypes.c_int, [_P] * 4 + [_I] * 13 + [_P]),
    "flash_decode_launch": (ctypes.c_int, [_P] * 6 + [_I] * 13 + [_P]),
}
_PAGED_NAME = "paged_attention"
_PAGED_SIGNATURES = {"paged_attention_launch": (
    ctypes.c_int, [_P] * 8 + [_I] * 14 + [_P])}
MAX_HEAD_DIM = 256
PREFILL_MAX_GROUPS = 64    # query heads per KV head K5 carries
DECODE_MAX_GROUPS = 16     # query heads per KV head K6 carries
# K6's split of the kv axis: a block's chunk is a multiple of its 4 warps'
# 32-row slices, at least SPLIT_MIN_ROWS rows (fewer would leave a warp one
# slice to amortise its start), and the grid aims at SPLIT_BLOCKS_PER_SM
# blocks an SM
SPLIT_ROW_ALIGN = 128
SPLIT_MIN_ROWS = 256
SPLIT_BLOCKS_PER_SM = 8
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _f32_bits(x: float) -> int:
    return struct.unpack("<i", struct.pack("<f", x))[0]


def plan_decode_splits(rows: int, batch: int, kv_heads: int,
                       sm_count: int = 132) -> tuple[int, int]:
    """K6's split of a cache of ``rows`` (S_max) kv rows: ``(splits,
    chunk)``, split i covering rows ``[i * chunk, min((i + 1) * chunk,
    rows))``, of which a launch reads those ``<= pos``.  Enough splits
    that ``batch * kv_heads * splits`` blocks fill ``sm_count`` SMs
    SPLIT_BLOCKS_PER_SM times over, no split shorter than SPLIT_MIN_ROWS
    unless it is the only one (so one split, and no combine pass, up to
    256 rows), chunks rounded up to SPLIT_ROW_ALIGN rows, and no empty
    split of the cache."""
    rows = int(rows)
    want = -(-SPLIT_BLOCKS_PER_SM * sm_count // (batch * kv_heads))
    n = max(1, min(want, -(-rows // SPLIT_MIN_ROWS)))
    chunk = -(-rows // n)
    chunk = -(-chunk // SPLIT_ROW_ALIGN) * SPLIT_ROW_ALIGN
    return -(-rows // chunk), chunk


def plan_paged_work(positions, *, table_width: int, block_size: int,
                    groups: int) -> RaggedWork:
    """K4's work list for queries at the host ``positions`` (B, C) over
    block tables of ``table_width`` blocks of ``block_size`` rows, for
    ``groups`` query heads per KV head: K1's layout (``RaggedWork``), each
    item's column 0 its slot b, column 6 the stream row b * C + c of its
    first token in q read as (B * C, H, D), column 7 0 (the kernel reads
    every row's causal limit from the positions on the device).

    A slot's tokens go in items of consecutive c, at most 16 // groups
    (16 (token, head) rows); a token joins its predecessor's item only
    when its position is the predecessor's or one more, so an item's
    rows see at most ``nt - 1`` kv rows fewer than its range.  A decode
    row, a prefill chunk, a verify chunk's fed token and drafts are each
    one run.  A padded verify row, which the engine puts on the table's
    extra trash column (position ``nbmax * bs``, past every real row),
    starts an item of its own with the padded rows after it, so it never
    widens a real row's range (unless the real row is at ``nbmax * bs -
    1``, where it adds the one row an ordinary next token would).  An item
    sees kv rows ``[0, largest position + 1)`` clipped to ``table_width *
    block_size``; past SPLIT_ROWS rows it is split as K1's items are."""
    if not 1 <= groups <= ROWS_PER_ITEM:
        raise ValueError(f"K4 carries 1..{ROWS_PER_ITEM} query heads per KV "
                         f"head, not {groups}")
    pos = np.asarray(positions, dtype=np.int64)
    if pos.ndim != 2 or (pos < 0).any():
        raise ValueError(f"K4 takes (B, C) positions >= 0, got shape "
                         f"{pos.shape}")
    b, c = pos.shape
    rows = int(table_width) * int(block_size)
    tq = ROWS_PER_ITEM // groups
    plan = _Planner()
    step = np.diff(pos, axis=1)
    for slot in range(b):
        t0 = 0
        for t in range(1, c + 1):
            if t == c or t - t0 == tq or not 0 <= step[slot, t - 1] <= 1:
                vis = min(int(pos[slot, t0:t].max()) + 1, rows)
                plan.add(slot, t0, t - t0, slot * c + t0, 0, vis)
                t0 = t
    return plan.work()


def paged_capacity(batch: int, chunk: int, *, groups: int,
                   table_width: int, block_size: int) -> WorkCapacity:
    """The capacity (``ragged_flash.pad_work``) of every work list
    :func:`plan_paged_work` makes of the legacy engine's (B, C) steps over
    tables of ``table_width`` blocks: a slot's positions are one run of
    consecutive positions (a decode row, a prefill chunk), or one run and
    the padded verify rows on the trash column after it, so a slot gives
    at most ``min(C, ceil(C / (16 // groups)) + 1)`` q tiles, each seeing
    at most ``table_width * block_size`` kv rows."""
    if not 1 <= groups <= ROWS_PER_ITEM:
        raise ValueError(f"K4 carries 1..{ROWS_PER_ITEM} query heads per KV "
                         f"head, not {groups}")
    tq = ROWS_PER_ITEM // groups
    return _capacity(batch * min(chunk, -(-chunk // tq) + 1),
                     int(table_width) * int(block_size))


def paged_plan_from_positions(positions: torch.Tensor, *, table_width: int,
                              block_size: int, groups: int,
                              device: Optional[torch.device] = None
                              ) -> RaggedWork:
    """K4's work list from positions held as a tensor, read back to the
    host (a device sync): for callers that pass no plan."""
    work = plan_paged_work(positions.cpu().numpy(), table_width=table_width,
                           block_size=block_size, groups=groups)
    return work if device is None else work.to(device)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
                       kv_frac_bits: int, causal: bool = True
                       ) -> torch.Tensor:
    """Launch K5: attention of q (B, Sq, H, Dk) over K/V (B, Skv, KVH, D),
    causal with q at positions 0..Sq-1 or, with ``causal=False``, every
    query over every kv row; returns (B, Sq, H, Dv) in q's dtype.
    ``kv_frac_bits`` is the int8 cache's fractional bit (0 for floats)."""
    _check("flash_prefill_cuda", q, k, v, PREFILL_MAX_GROUPS)
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
                _KV_CODES[k.dtype], int(bool(causal)), stream)
    return out


def flash_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      pos: torch.Tensor, kv_frac_bits: int,
                      plan_shards: int = 1) -> torch.Tensor:
    """Launch K6: q (B, 1, H, Dk) at absolute position ``pos`` (a 0-d int32
    tensor on q's device, read by the kernel and never by the host) over
    the cache (B, S_max, KVH, D), kv rows ``<= pos`` visible; returns
    (B, 1, H, Dv) in q's dtype, NaN where ``pos`` lies outside
    ``[0, S_max)`` (the caller, which knows the position, checks it).  The
    kernel reads the cache only up to ``pos``; with more than one split
    its blocks write fp32 partials (m, l, acc) to a workspace from the
    caching allocator (inside a capture, the graph's pool), merged by the
    combine kernel in the same call.  ``plan_shards``: the operands are
    one of that many ranks' slices (heads, batch) of a mesh's decode, and
    the splits are planned for the whole (``plan_decode_splits`` of batch
    x KV heads x ``plan_shards``), so each head's partials combine in the
    one-rank order."""
    _check("flash_decode_cuda", q, k, v, DECODE_MAX_GROUPS)
    b, sq, h, dk = q.shape
    s_max, kvh, dv = k.shape[1], k.shape[2], v.shape[3]
    if sq != 1:
        raise ValueError(f"flash_decode_cuda is the q_len=1 kernel, got "
                         f"q_len={sq}")
    if not isinstance(pos, torch.Tensor) or pos.device != q.device \
            or pos.dtype != torch.int32 or pos.numel() != 1:
        raise TypeError("flash_decode_cuda takes pos as one int32 on q's "
                        "device (a 0-d tensor)")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty((b, 1, h, dv), dtype=q.dtype, device=q.device)
    splits, chunk = plan_decode_splits(s_max, b * plan_shards, kvh,
                                       _sm_count(q.device.index or 0))
    ws_ptr = 0
    if splits > 1:
        ws = torch.empty((b, kvh, splits, h // kvh, dv + 2),
                         dtype=torch.float32, device=q.device)
        ws_ptr = ws.data_ptr()
    score_scale = 2.0 ** (-kv_frac_bits) / math.sqrt(dk)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch("flash_decode_launch", q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), ws_ptr, pos.data_ptr(), b,
                s_max, h, kvh, dk, dv, splits, chunk, _f32_bits(score_scale),
                int(kv_frac_bits), _f32_bits(DEFAULT_MASK_VALUE),
                _Q_CODES[q.dtype], _KV_CODES[k.dtype], stream)
    return out


def paged_attention_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                         v_pool: torch.Tensor, block_tables: torch.Tensor,
                         q_positions: torch.Tensor, *, kv_frac_bits: int,
                         scale: float, work: RaggedWork) -> torch.Tensor:
    """Launch K4 over ``work`` (:func:`plan_paged_work` of these positions
    and this table width, on q's device): q (B, C, H, Dk) at positions
    ``q_positions`` (B, C) over the pool (NB, bs, KVH, D) through
    ``block_tables`` (B, W), kv rows ``<= position`` visible, scores times
    ``scale``; returns (B, C, H, Dv) in q's dtype.  Any head dim up to
    256.  The (n_parts, KVH, 16, Dv + 2) fp32 workspace of the split
    items' partial states is allocated only when the list has combine
    entries."""
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
    groups = h // kvh
    if groups > ROWS_PER_ITEM or max(dk, dv) > MAX_HEAD_DIM \
            or bs > MAX_BLOCK_SIZE or w < 1:
        raise ValueError(f"K4 carries at most {ROWS_PER_ITEM} query heads "
                         f"per KV head, head dims <= {MAX_HEAD_DIM}, pool "
                         f"blocks <= {MAX_BLOCK_SIZE} and a table of at "
                         f"least one block; got groups={groups}, dk={dk}, "
                         f"dv={dv}, bs={bs}, W={w}")
    if work.n_items <= 0:
        raise ValueError("K4's work list has no item")
    table = work.table
    if not isinstance(table, torch.Tensor) or table.device != dev \
            or table.dtype != torch.int32 or not table.is_contiguous() \
            or table.shape != (work.n_items + work.n_combine, ITEM_COLS):
        raise ValueError(f"the work list must be a contiguous (items + "
                         f"combines, {ITEM_COLS}) int32 tensor on q's device "
                         f"(RaggedWork.to)")
    out = torch.empty((b, c, h, dv), dtype=q.dtype, device=dev)
    ws = (torch.empty((work.n_parts, kvh, ROWS_PER_ITEM, dv + 2),
                      dtype=torch.float32, device=dev)
          if work.n_combine else None)
    bt = block_tables.to(torch.int32).contiguous()
    pos = q_positions.to(torch.int32).contiguous()
    q, k_pool, v_pool = q.contiguous(), k_pool.contiguous(), v_pool.contiguous()
    score_scale = scale * 2.0 ** (-kv_frac_bits)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch("paged_attention_launch", q.data_ptr(), k_pool.data_ptr(),
                v_pool.data_ptr(), bt.data_ptr(), pos.data_ptr(),
                table.data_ptr(), out.data_ptr(),
                None if ws is None else ws.data_ptr(), h, kvh, dk, dv, w, bs,
                work.n_items, work.n_combine, work.max_splits,
                (work.max_rows - 1) // bs + 2,  # pool blocks a range touches
                _f32_bits(score_scale), int(kv_frac_bits), _Q_CODES[q.dtype],
                _KV_CODES[k_pool.dtype], stream, name=_PAGED_NAME,
                signatures=_PAGED_SIGNATURES)
    return out
