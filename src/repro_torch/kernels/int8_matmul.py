"""K2 binding: int8 x int8 -> int32 matmul with the fused bit-shift
requant epilogue, hand-written in CUDA C++ for Hopper
(``csrc/int8_matmul.cu``).

Replaces the TPU kernel ``repro/kernels/int8_matmul.py::int8_matmul_kernel``.
On an H100 it is bound by bytes: the int8 weight codes at the serving
shapes, the activation rows at large-M products.  The
products run on the tensor cores (``mma.sync`` m16n8k32, s8 or u8 x s8);
the epilogue (bias align, optional ReLU, round-half-away shift-requant
with a saturating negative shift, clip) runs in registers, and stores the
8-bit codes or, for the LM path's projections, the dequantized activation
``code * 2^-n_o`` as bf16 / fp32 (exact in both, so equal to
``qscheme.dequant`` of the codes bit for bit).

:func:`plan_int8_matmul` chooses, on the host and from the shapes alone,
the kernel's tile (one block row covers every stream row up to 128 rows,
so the weights are read once a launch) and how many splits of K keep the
card full when the column tiles are few.  A split launch adds its int32
partial sums in a workspace allocated here and runs the epilogue once on
the full sum; it is still one launch of ``int8_matmul``.  Shapes the
tensor-core kernel does not take (K % 16 != 0, N % 8 != 0, misaligned
operands) go to the kernel's ``dp4a`` tile.

:func:`int8_matmul_grouped_cuda` is its grouped form for the MoE experts
(no TPU twin: the reference leaves the experts' int8 product to XLA):
one launch over (E, C, K) x (E, K, N) stacks, the expert a grid
dimension, each expert's row count read on the card, so padding experts
and empty capacity rows cost one early exit a block.  Under a data cut
each expert's C rows are D segments of C / D rows (the data shards'
slices of its capacity, the reference's exchange layout) with an (E, D)
count grid, one grid block row a segment; and where a mesh cuts the
experts' hidden over ``data`` it stores the raw int32 sums (the int32
output kind), whose epilogue :func:`int8_matmul_finish_cuda` runs once
after the ranks' sums are added.

Its rank-split form, for a row-cut module on a tensor-parallel mesh, is
:func:`int8_matmul_cuda` with ``out_dtype=torch.int32`` (one rank's
(M, N) sums, no epilogue), the ranks' sums added in int32 by an
all-reduce, and :func:`int8_matmul_finish_cuda`, the epilogue once over
them, so the module's output is one rank's bit for bit (``core.qmodel``'s
row-cut modules).

Activations are int8 codes, or uint8 post-ReLU codes.  The ResNet's
convolutions run in ``csrc/int_conv.cu``; only its head comes here.
The weight codes stay in their public (K, N) layout, so
no second copy of the weights exists.  Called through
``kernels.ops.int8_matmul``, which counts the launches and takes the plain
version (``kernels.ref.int8_matmul_ref``) for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build

__all__ = ["int8_matmul_cuda", "int8_matmul_grouped_cuda",
           "int8_matmul_finish_cuda",
           "plan_int8_matmul", "Int8MatmulPlan", "MMA_TILES", "DP4A_TILE",
           "K_STEP"]

_NAME = "int8_matmul"
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"int8_matmul_launch": (
    ctypes.c_int, [_P] * 5 + [_I] * 13 + [ctypes.c_float, _P]),
    "int8_matmul_grouped_launch": (
    ctypes.c_int, [_P] * 4 + [_I] * 10 + [ctypes.c_float, _I, _I, _P]),
    "int8_matmul_finish_launch": (
    ctypes.c_int, [_P] * 3 + [_I] * 8 + [ctypes.c_float, _P])}
# the kernel's out_kind, by output dtype (int32: the raw sums, no epilogue)
_OUT_KIND = {torch.int8: 0, torch.uint8: 0, torch.bfloat16: 1,
             torch.float32: 2, torch.int32: 3}

# (rows, columns) of the tensor-core kernel's block tile, by configuration
# index (csrc/int8_matmul.cu::launch_cfg): 0-3 cover M <= 16 / 32 / 64 /
# 128 in one block row; 4-9 are tall tiles for large M, narrow ones (32,
# 64 columns) for narrow N (on the card's paths now only chip_smoke.py's
# old-chain comparison, an im2col product, reaches 4-7)
MMA_TILES = ((16, 128), (32, 128), (64, 128), (128, 128),
             (256, 32), (128, 32), (128, 64), (64, 64),
             (128, 128), (64, 128))
DP4A_TILE = (64, 64)
K_STEP = 64               # K rows a pipeline stage; a split is a multiple
SMALL_M = 128             # rows one block row covers
# split K only while the grid is under SPLIT_BLOCKS_PER_SM blocks an SM;
# a split keeps at least SPLIT_MIN_ROWS K rows and 8 x its tile's rows (so
# its int32 partials stay under half the weight bytes it reads)
SPLIT_BLOCKS_PER_SM = 2
SPLIT_MIN_ROWS = 128


class Int8MatmulPlan(NamedTuple):
    """``cfg`` indexes MMA_TILES (-1: the dp4a kernel); ``splits`` pieces
    of K, piece i covering rows ``[i * k_chunk, min(K, (i + 1) *
    k_chunk))``."""
    cfg: int
    bm: int
    bn: int
    splits: int
    k_chunk: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan_int8_matmul(m: int, k: int, n: int, sm_count: int = 132, *,
                     aligned: bool = True) -> Int8MatmulPlan:
    """K2's launch for an (m, k) x (k, n) product, from the shapes alone
    (``aligned``: the operands' addresses suit the tensor-core kernel's
    16- / 8-byte copies)."""
    if not (k % 16 == 0 and n % 8 == 0 and aligned):
        return Int8MatmulPlan(-1, *DP4A_TILE, 1, k)
    want = SPLIT_BLOCKS_PER_SM * sm_count
    if m <= SMALL_M:
        cfg = (0, 1, 2, 2, 3, 3, 3, 3)[_cdiv(m, 16) - 1]
    else:
        big, small = (4, 5) if n <= 32 else (6, 7) if n <= 64 else (8, 9)
        tiles = _cdiv(m, MMA_TILES[big][0]) * _cdiv(n, MMA_TILES[big][1])
        cfg = big if tiles >= want else small
    bm, bn = MMA_TILES[cfg]
    tiles = _cdiv(m, bm) * _cdiv(n, bn)
    splits = 1
    if m <= SMALL_M and tiles < want:
        cap = max(1, k // max(SPLIT_MIN_ROWS, 8 * bm))
        splits = min(_cdiv(want, tiles), cap)
    chunk = _cdiv(_cdiv(k, splits), K_STEP) * K_STEP
    return Int8MatmulPlan(cfg, bm, bn, _cdiv(k, chunk), chunk)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def int8_matmul_cuda(x2: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor], *, shift: int,
                     bias_shift: int, relu: bool, lo: int, hi: int,
                     out_dtype: torch.dtype,
                     n_o: Optional[int] = None) -> torch.Tensor:
    """Launch K2 on (M, K) int8 or uint8 x (K, N) int8 (+ (N,) int8 bias)
    CUDA tensors; returns (M, N) ``out_dtype`` (int8 or uint8) codes, or
    with ``out_dtype`` bfloat16 / float32 the codes times ``2^-n_o``, or
    with int32 the raw sums (the rank-split form's first pass: no bias, no
    epilogue; a split launch's partials added in int32)."""
    if x2.device.type != "cuda" or w.device != x2.device:
        raise ValueError("int8_matmul_cuda takes CUDA tensors on one device")
    if x2.dtype not in (torch.int8, torch.uint8) or w.dtype != torch.int8:
        raise TypeError(f"K2 takes int8 or uint8 x int8 codes, got "
                        f"{x2.dtype} x {w.dtype}")
    if x2.ndim != 2 or w.ndim != 2 or x2.shape[1] != w.shape[0]:
        raise ValueError(f"shape mismatch {tuple(x2.shape)} x {tuple(w.shape)}")
    if out_dtype not in _OUT_KIND:
        raise TypeError(f"K2 emits int8 / uint8 codes, their bf16 / fp32 "
                        f"values or the int32 sums, not {out_dtype}")
    if (n_o is None) != (_OUT_KIND[out_dtype] in (0, 3)):
        raise ValueError("a float output takes its grid n_o; codes and sums "
                         "take none")
    if out_dtype == torch.int32 and b is not None:
        raise ValueError("the int32 sums take no bias: the finish adds it")
    if n_o is not None and not -126 <= n_o <= 126:
        raise ValueError(f"output grid {n_o} outside fp32's exponent range")
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
    plan = plan_int8_matmul(
        m, k, n, _sm_count(x2.device.index or 0),
        aligned=x2.data_ptr() % 16 == 0 and w.data_ptr() % 8 == 0)
    ws = (torch.empty((plan.splits, m, n), dtype=torch.int32,
                      device=x2.device) if plan.splits > 1 else None)
    lib = _build.load(_NAME, _SIGNATURES)
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        err = lib.int8_matmul_launch(
            x2.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            out.data_ptr(), None if ws is None else ws.data_ptr(), m, n, k,
            int(shift), int(bias_shift), int(relu), int(lo), int(hi),
            int(x2.dtype == torch.uint8), plan.cfg, plan.splits,
            plan.k_chunk, _OUT_KIND[out_dtype],
            2.0 ** -int(n_o or 0), stream)
    if err != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: CUDA error {err}")
    return out


def int8_matmul_grouped_cuda(x3: torch.Tensor, w3: torch.Tensor,
                             counts: torch.Tensor, *, rows_cap: int,
                             shift: int, lo: int, hi: int,
                             out_dtype: torch.dtype,
                             n_o: Optional[int] = None) -> torch.Tensor:
    """Launch K2's grouped form on (E, C, K) int8 x (E, K, N) int8 CUDA
    stacks.  ``counts`` (int32 on the card, never read on the host) is
    (E,), each expert's rows one segment of C, or (E, D), each expert's C
    rows D segments of C / D rows (the data shards' slices): segment s of
    expert e computes its first ``min(counts[e, s], rows_cap)`` rows
    through K2's epilogue (shift-requant, clip; no bias or ReLU), as
    ``out_dtype`` codes or, with bfloat16 / float32, their values times
    ``2^-n_o``, or with int32 the raw sums (no epilogue: a data-cut
    hidden's partial, finished by :func:`int8_matmul_finish_cuda` after
    the ranks' sums are added).  Returns (E, C, N); rows past a segment's
    count are left unwritten (``torch.empty``).  The tile is planned for
    ``rows_cap`` rows (an upper bound of every count that the caller
    knows on the host: at most one row a token of the shard)."""
    if x3.device.type != "cuda" or w3.device != x3.device \
            or counts.device != x3.device:
        raise ValueError("int8_matmul_grouped_cuda takes CUDA tensors on "
                         "one device")
    if x3.dtype != torch.int8 or w3.dtype != torch.int8 \
            or counts.dtype != torch.int32:
        raise TypeError(f"the grouped K2 takes int8 x int8 codes and int32 "
                        f"counts, got {x3.dtype} x {w3.dtype}, "
                        f"{counts.dtype}")
    segs = counts.shape[1] if counts.ndim == 2 else 1
    if x3.ndim != 3 or w3.ndim != 3 or x3.shape[0] != w3.shape[0] \
            or x3.shape[2] != w3.shape[1] or counts.ndim not in (1, 2) \
            or counts.shape[0] != x3.shape[0] or x3.shape[1] % segs:
        raise ValueError(f"shape mismatch {tuple(x3.shape)} x "
                         f"{tuple(w3.shape)}, counts {tuple(counts.shape)}")
    e, c, k = x3.shape
    n = w3.shape[2]
    stride = c // segs
    if k % 16 or n % 8:
        raise ValueError(f"the grouped K2 takes K % 16 == 0 and N % 8 == 0, "
                         f"got K={k}, N={n}")
    if not 1 <= rows_cap <= stride or e * segs > 65535:
        raise ValueError(f"rows_cap {rows_cap} outside [1, {stride}] (C={c} "
                         f"in {segs} segments) or {e} x {segs} segments > "
                         f"65535")
    if out_dtype not in _OUT_KIND:
        raise TypeError(f"K2 emits int8 codes, their bf16 / fp32 values or "
                        f"the int32 sums, not {out_dtype}")
    if (n_o is None) != (_OUT_KIND[out_dtype] in (0, 3)):
        raise ValueError("a float output takes its grid n_o; codes and sums "
                         "take none")
    if not -31 <= shift <= 31:
        raise ValueError(f"shift {shift} outside the int32 range [-31, 31]")
    x3, w3, counts = x3.contiguous(), w3.contiguous(), counts.contiguous()
    out = torch.empty((e, c, n), dtype=out_dtype, device=x3.device)
    plan = plan_int8_matmul(rows_cap, k, n)
    lib = _build.load(_NAME, _SIGNATURES)
    with torch.cuda.device(x3.device):
        stream = torch.cuda.current_stream(x3.device).cuda_stream
        err = lib.int8_matmul_grouped_launch(
            x3.data_ptr(), w3.data_ptr(), counts.data_ptr(), out.data_ptr(),
            e, c, int(rows_cap), n, k, int(shift), int(lo), int(hi),
            plan.cfg, _OUT_KIND[out_dtype], 2.0 ** -int(n_o or 0), segs,
            stride, stream)
    if err != 0:
        raise RuntimeError(f"int8_matmul_grouped kernel launch failed: CUDA "
                           f"error {err}")
    return out


def int8_matmul_finish_cuda(acc: torch.Tensor, b: Optional[torch.Tensor], *,
                            shift: int, bias_shift: int, relu: bool, lo: int,
                            hi: int, out_dtype: torch.dtype,
                            n_o: Optional[int] = None) -> torch.Tensor:
    """The rank-split form's finish: K2's epilogue once over the (M, N)
    int32 CUDA sums ``acc`` (+ the (N,) int8 bias), as ``out_dtype`` codes
    or, with bfloat16 / float32, their values times ``2^-n_o``; N % 4 ==
    0."""
    if acc.device.type != "cuda" or acc.dtype != torch.int32 \
            or acc.ndim != 2:
        raise TypeError("the finish takes (M, N) int32 sums on the card")
    m, n = acc.shape
    if n % 4:
        raise ValueError(f"the finish takes N % 4 == 0, got N={n}")
    if out_dtype not in _OUT_KIND or out_dtype == torch.int32:
        raise TypeError(f"the finish emits int8 / uint8 codes or their "
                        f"bf16 / fp32 values, not {out_dtype}")
    if (n_o is None) != (_OUT_KIND[out_dtype] == 0):
        raise ValueError("a float output takes its grid n_o; codes take none")
    for s in (shift, bias_shift):
        if not -31 <= s <= 31:
            raise ValueError(f"shift {s} outside the int32 range [-31, 31]")
    acc = acc.contiguous()
    if b is not None:
        if b.dtype != torch.int8 or b.shape != (n,) or b.device != acc.device:
            raise ValueError("bias must be (N,) int8 codes on the same device")
        b = b.contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=acc.device)
    lib = _build.load(_NAME, _SIGNATURES)
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        err = lib.int8_matmul_finish_launch(
            acc.data_ptr(), None if b is None else b.data_ptr(),
            out.data_ptr(), m, n, int(shift), int(bias_shift), int(relu),
            int(lo), int(hi), _OUT_KIND[out_dtype], 2.0 ** -int(n_o or 0),
            stream)
    if err != 0:
        raise RuntimeError(f"int8_matmul finish launch failed: CUDA error "
                           f"{err}")
    return out
