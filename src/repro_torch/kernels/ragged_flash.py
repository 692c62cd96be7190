"""K1 binding: unified ragged paged attention over the KV block pool,
hand-written in CUDA C++ for Hopper (``csrc/ragged_attention.cu``).

Replaces the TPU kernel
``repro/kernels/ragged_flash.py::_ragged_paged_flash_kernel``.  One launch
serves a whole mixed serving step (prefill chunks, decode rows,
speculative tails) from a flattened (T, H, Dk) stream and per-sequence
descriptors.  On an H100 it is bound by the KV bytes each sequence reads.

:func:`plan_ragged_work` turns the step's descriptors into the kernel's
work list on the host: items of up to 16 (token, head) rows of one KV head
(``16 // groups`` tokens times the GQA group) over a kv range, a long
range cut into chunks whose partial softmax states a second small kernel
merges (split-KV).  The serving engine plans once per step from the numpy
descriptors it already holds and every layer shares the uploaded list
(``RaggedBatch.work``); a caller without a plan gets one built here from
the descriptors, which only then are read back to the host.  A step
replayed from a CUDA graph launches with one grid and one shared-memory
size for its whole step shape: :func:`pad_work` pads its list to the
shape's capacity (:func:`ragged_capacity`) with entries the kernels skip.
The source's header note gives the design: the block table walked up to
``kv_len``, pages staged by 16-byte ``cp.async``, bf16 q on the tensor
cores, fp32 q on the CUDA cores, int8 codes converted exactly with 2^-n
folded into the score scale and the final 1/l.

Descriptor contract (host-built, as ``repro.kernels.ragged_flash``):
``q_start`` nondecreasing, row windows disjoint, ``q_len <= kv_len``,
padding slots with ``q_len == kv_len == 0``.  The output is zero-filled
here, so rows no descriptor covers are exactly 0.  Called through
``kernels.ops.ragged_attention``, which counts launches and takes the
plain version for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
import math
import struct
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.kernels import _build

__all__ = ["ragged_attention_cuda", "plan_ragged_work", "plan_from_descriptors",
           "RaggedWork", "WorkCapacity", "ragged_capacity", "pad_work"]

_NAME = "ragged_attention"
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"ragged_paged_attention_launch": (
    ctypes.c_int, [_P] * 7 + [_I] * 14 + [_P])}

ROWS_PER_ITEM = 16         # (token, head) rows one item (one block) carries
MAX_HEAD_DIM = 256
MAX_BLOCK_SIZE = 128       # kv rows per pool block
STAGE_ROWS = 64            # kv rows a pipeline stage: a split is a multiple
SPLIT_ROWS = 512           # an item seeing more kv rows than this is split
# chunks an item is cut into, at most: a longer context gets longer chunks
# (a 32768-row decode ran faster as 32 chunks of 1024 rows than as 64 of
# 512, a 4104-row prefill tile faster as 9 of 512 than as 5 of 832)
MAX_SPLITS = 32
ITEM_COLS = 8
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


class RaggedWork(NamedTuple):
    """K1's work list for one step.  ``table`` (n_items + n_combine, 8)
    int32 holds the items — (sequence, first token, tokens, kv begin, kv
    end, partial slot or -1, the first token's stream row, its causal
    limit), longest kv range first — then the combine entries (sequence,
    first token, tokens, first slot, slots, 0, stream row, 0): a host numpy
    array from :func:`plan_ragged_work`, or that array on the card
    (:meth:`to`).  ``max_splits`` is the most slots one entry lists and
    ``max_rows`` the longest item kv range."""
    table: Union[np.ndarray, torch.Tensor]
    n_items: int
    n_combine: int
    n_parts: int
    max_splits: int
    max_rows: int

    def to(self, device) -> "RaggedWork":
        return self._replace(table=torch.from_numpy(self.table).to(device))


def plan_ragged_work(q_start, q_len, kv_len, *, groups: int) -> RaggedWork:
    """The work list of a step whose descriptors are the host arrays
    ``q_start`` / ``q_len`` / ``kv_len``, for ``groups`` query heads per
    KV head.  Each sequence's tokens go in items of ``16 // groups``; an
    item whose last token sees more than SPLIT_ROWS kv rows is cut into
    equal chunks of a multiple of STAGE_ROWS rows (the last one shorter,
    none empty; at most MAX_SPLITS, so chunks grow past SPLIT_ROWS on very
    long contexts), each with its own partial slot."""
    if not 1 <= groups <= ROWS_PER_ITEM:
        raise ValueError(f"K1 carries 1..{ROWS_PER_ITEM} query heads per KV "
                         f"head, not {groups}")
    q_start, q_len, kv_len = (np.asarray(a, dtype=np.int64)
                              for a in (q_start, q_len, kv_len))
    tq = ROWS_PER_ITEM // groups
    plan = _Planner()
    for s in range(len(q_len)):
        ql, kl = int(q_len[s]), int(kv_len[s])
        for t0 in range(0, max(ql, 0), tq):
            nt = min(tq, ql - t0)
            row0, lim0 = int(q_start[s]) + t0, kl - ql + t0
            # over the kv rows the item's last token sees
            plan.add(s, t0, nt, row0, lim0, lim0 + nt)
    return plan.work()


def _split(vis: int) -> tuple[int, int]:
    """``(chunks, rows a chunk)`` of an item over kv rows ``[0, vis)``:
    one item up to SPLIT_ROWS rows, else equal chunks of a multiple of
    STAGE_ROWS rows (the last one shorter, none empty, at most
    MAX_SPLITS)."""
    if vis <= SPLIT_ROWS:
        return 1, vis
    n = min(-(-vis // SPLIT_ROWS), MAX_SPLITS)
    chunk = -(-(-(-vis // n)) // STAGE_ROWS) * STAGE_ROWS
    return -(-vis // chunk), chunk


class _Planner:
    """Items and combine entries of a work list, as K1's and K4's
    planners add them."""

    def __init__(self):
        self.items, self.combines, self.n_parts = [], [], 0

    def add(self, s: int, t0: int, nt: int, row0: int, lim0: int,
            vis: int) -> None:
        """Tokens ``t0 .. t0 + nt`` of sequence ``s`` (stream rows from
        ``row0``) over kv rows ``[0, vis)``, cut as :func:`_split` says;
        a cut range gets a combine entry over its chunks' slots."""
        n, chunk = _split(vis)
        if n == 1:
            self.items.append((s, t0, nt, 0, vis, -1, row0, lim0))
            return
        self.combines.append((s, t0, nt, self.n_parts, n, 0, row0, 0))
        self.items += [(s, t0, nt, i * chunk, min(vis, (i + 1) * chunk),
                        self.n_parts + i, row0, lim0) for i in range(n)]
        self.n_parts += n

    def work(self) -> RaggedWork:
        # longest kv range first
        items = sorted(self.items, key=lambda it: it[3] - it[4])
        table = np.array(items + self.combines,
                         dtype=np.int32).reshape(-1, ITEM_COLS)
        return RaggedWork(table, len(items), len(self.combines),
                          self.n_parts,
                          max((c[4] for c in self.combines), default=0),
                          max((it[4] - it[3] for it in items), default=0))


class WorkCapacity(NamedTuple):
    """The fixed launch of a padded work list: items, combine entries and
    partial slots it holds, and the largest ``max_splits`` and
    ``max_rows`` any list it pads may have."""
    n_items: int
    n_combine: int
    n_parts: int
    max_splits: int
    max_rows: int


@functools.lru_cache(maxsize=None)
def _worst_split(rows: int) -> tuple[int, int]:
    """The most chunks any item over at most ``rows`` kv rows is cut
    into, and the longest range such an item or chunk spans."""
    splits = [_split(v) for v in range(1, max(rows, 1) + 1)]
    return (max(n for n, _ in splits),
            max(v if n == 1 else c for v, (n, c) in enumerate(splits, 1)))


def _capacity(tiles: int, rows: int) -> WorkCapacity:
    """The capacity of ``tiles`` q tiles, each over at most ``rows`` kv
    rows."""
    n, max_rows = _worst_split(rows)
    if n == 1:
        return WorkCapacity(tiles, 0, 0, 0, max_rows)
    return WorkCapacity(tiles * n, tiles, tiles * n, n, max_rows)


def ragged_capacity(t_pad: int, s_pad: int, *, groups: int,
                    rows: int) -> WorkCapacity:
    """The capacity of every work list :func:`plan_ragged_work` makes of
    a step of at most ``t_pad`` tokens over ``s_pad`` sequence slots,
    ``groups`` query heads per KV head, no sequence seeing more than
    ``rows`` kv rows (the engine's longest context, ``nbmax *
    block_size``).  A sequence's first token opens a q tile and every
    ``16 // groups`` more tokens another, so ``m = min(s_pad, t_pad)``
    sequences give at most ``m + (t_pad - m) // (16 // groups)`` tiles;
    each is cut into at most as many chunks as the longest range is."""
    if not 1 <= groups <= ROWS_PER_ITEM:
        raise ValueError(f"K1 carries 1..{ROWS_PER_ITEM} query heads per KV "
                         f"head, not {groups}")
    m = min(s_pad, t_pad)
    return _capacity(m + (t_pad - m) // (ROWS_PER_ITEM // groups), rows)


def pad_work(work: RaggedWork, cap: WorkCapacity) -> RaggedWork:
    """``work`` (a host table) padded to ``cap``: its items, padding items
    (no token, no kv row, no slot), its combine entries, padding combine
    entries (no slot), and the capacity's counts and maxima, so that
    every step of one step shape launches the kernels with the same grid,
    shared memory and arguments.  The kernels return at once on a padding
    entry: the output is the unpadded list's, bit for bit.  Raises when
    ``work`` does not fit."""
    if (work.n_items > cap.n_items or work.n_combine > cap.n_combine
            or work.n_parts > cap.n_parts or work.max_splits > cap.max_splits
            or work.max_rows > cap.max_rows):
        raise ValueError(f"work list ({work.n_items} items, {work.n_combine} "
                         f"combines, {work.n_parts} slots, max_splits "
                         f"{work.max_splits}, max_rows {work.max_rows}) "
                         f"exceeds its capacity {tuple(cap)}")
    table = np.zeros((cap.n_items + cap.n_combine, ITEM_COLS), np.int32)
    table[:work.n_items] = work.table[:work.n_items]
    table[work.n_items:cap.n_items, 5] = -1
    table[cap.n_items:cap.n_items + work.n_combine] = work.table[work.n_items:]
    return RaggedWork(table, *cap)


def _f32_bits(x: float) -> int:
    return struct.unpack("<i", struct.pack("<f", x))[0]


def ragged_attention_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, block_tables: torch.Tensor,
                          q_start: torch.Tensor, q_len: torch.Tensor,
                          kv_len: torch.Tensor, *, kv_frac_bits: int,
                          work: RaggedWork) -> torch.Tensor:
    """Launch K1 over ``work`` (:func:`plan_ragged_work` of these
    descriptors, at least one item); returns (T, H, Dv) in q's dtype,
    scores scaled by 1/sqrt(Dk).  ``kv_frac_bits`` is the int8 pool's
    fractional bit (0 for a float pool)."""
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
    if groups > ROWS_PER_ITEM or max(dk, dv) > MAX_HEAD_DIM \
            or bs > MAX_BLOCK_SIZE:
        raise ValueError(f"K1 carries at most {ROWS_PER_ITEM} query heads "
                         f"per KV head, head dims <= {MAX_HEAD_DIM} and pool "
                         f"blocks <= {MAX_BLOCK_SIZE}; got groups={groups}, "
                         f"dk={dk}, dv={dv}, bs={bs}")
    if work.n_items <= 0:
        raise ValueError("K1's work list has no item")
    table = work.table
    if not isinstance(table, torch.Tensor) or table.device != dev \
            or table.dtype != torch.int32 or not table.is_contiguous() \
            or table.shape != (work.n_items + work.n_combine, ITEM_COLS):
        raise ValueError(f"the work list must be a contiguous (items + "
                         f"combines, {ITEM_COLS}) int32 tensor on q's device "
                         f"(RaggedWork.to)")
    bt = block_tables.to(torch.int32).contiguous()
    q, k_pool, v_pool = q.contiguous(), k_pool.contiguous(), v_pool.contiguous()
    out = torch.zeros((t, h, dv), dtype=q.dtype, device=dev)
    ws = (torch.empty((work.n_parts, kvh, ROWS_PER_ITEM, dv + 2),
                      dtype=torch.float32, device=dev)
          if work.n_combine else None)
    score_scale = 2.0 ** (-kv_frac_bits) / math.sqrt(dk)
    lib = _build.load(_NAME, _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ragged_paged_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), bt.data_ptr(),
            table.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), h, kvh, dk, dv, nbmax, bs,
            work.n_items, work.n_combine, work.max_splits,
            (work.max_rows - 1) // bs + 2,      # pool blocks a range touches
            _f32_bits(score_scale), int(kv_frac_bits), _Q_CODES[q.dtype],
            _KV_CODES[k_pool.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ragged attention kernel launch failed: CUDA "
                           f"error {err}")
    return out


def plan_from_descriptors(q_start: torch.Tensor, q_len: torch.Tensor,
                          kv_len: torch.Tensor, groups: int,
                          device: Optional[torch.device] = None
                          ) -> RaggedWork:
    """The work list of descriptors held as tensors, read back to the
    host (a device sync): for callers that pass no plan."""
    work = plan_ragged_work(q_start.cpu().numpy(), q_len.cpu().numpy(),
                            kv_len.cpu().numpy(), groups=groups)
    return work if device is None else work.to(device)
