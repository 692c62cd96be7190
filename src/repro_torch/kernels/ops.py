"""Public wrappers around the hand-written kernels.

Each wrapper takes the kernel's plain PyTorch version (``kernels.ref``)
only because the tensor it was given lies on the CPU; for a CUDA tensor
it launches the CUDA kernel or raises — there is no quiet fallback.  The
plain version's output is returned contiguous, as the kernel writes its
own, so that the code after a wrapper runs the same ops on every device.
The TPU package's shape rules (small shapes to the reference, lane-multiple
head dims for the ragged and flash kernels) were TPU layout rules and do not carry
over: on a CUDA tensor the kernel launches for every shape.

``LAUNCHES`` counts kernel launches per kernel, one per launch and
nowhere else, so a run can show that its path went through the kernels.

Under an active cost counter (``launch.analysis.CostMode``) each wrapper
charges its kernel's reckoning (``kernels.cost``) once a call, on the
card after the launch and on the CPU or ``meta`` around the plain
version, whose own aten ops are then not counted; counting changes
nothing that runs.  On ``meta`` a wrapper runs the plain version, which
there only makes the output's shape.

Under a tensor-parallel mesh each rank calls these wrappers on its own
slices: K2's rank-split form (:func:`int8_matmul_partial`, then an int32
all-reduce, then :func:`int8_matmul_finish`) serves the row-cut modules,
and its grouped form's int32 kind (:func:`int8_matmul_grouped_partial`)
the experts' hidden cut over ``data``, over the exchanged layout (an
(E, D) count grid),
and the attention wrappers take the ``mesh`` (:func:`attn_shard_size`):
their operands hold this rank's KV heads, whole GQA groups.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.integer_ops import LinearQuantSpec
from repro_torch.core.qscheme import int_bounds
from repro_torch.kernels import cost, ref
from repro_torch.kernels.flash_attention import (flash_decode_cuda,
                                                 flash_prefill_cuda,
                                                 paged_attention_cuda,
                                                 paged_plan_from_positions)
from repro_torch.kernels.int8_matmul import (int8_matmul_cuda,
                                             int8_matmul_finish_cuda,
                                             int8_matmul_grouped_cuda)
from repro_torch.kernels.int_conv import ResidualShifts, int_conv_cuda
from repro_torch.kernels.quantize import (quantize_multi_cuda,
                                          quantize_scatter_cuda)
from repro_torch.kernels.ragged_flash import (RaggedWork,
                                             plan_from_descriptors,
                                             ragged_attention_cuda)
from repro_torch.kernels.residual_requant import residual_requant_cuda

__all__ = ["int8_matmul", "int8_matmul_grouped",
           "int8_matmul_grouped_partial", "int8_matmul_partial",
           "int8_matmul_finish", "attn_shard_size", "int_conv2d",
           "quantize_act", "quantize_multi", "quantize_scatter",
           "residual_requant",
           "ragged_attention", "paged_attention", "flash_attention",
           "flash_decode", "LAUNCHES", "FORM_LAUNCHES",
           "reset_launch_counts"]

# launches per kernel since the last reset (process-wide, like the
# loaded kernel libraries themselves)
LAUNCHES = {"int8_matmul": 0, "int8_matmul_grouped": 0,
            "ragged_attention": 0, "paged_attention": 0,
            "flash_prefill": 0, "flash_decode": 0, "quantize": 0,
            "residual_requant": 0, "int_conv": 0}


# launches of one form of a kernel, counted beside (not instead of) the
# kernel's own count in LAUNCHES
FORM_LAUNCHES = {"flash_prefill_noncausal": 0, "int8_matmul_partial": 0,
                 "int8_matmul_finish": 0, "int8_matmul_grouped_partial": 0,
                 "int8_matmul_grouped_segments": 0}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, FORM_LAUNCHES):
        for name in counts:
            counts[name] = 0


def _on_cuda(t: torch.Tensor, what: str) -> bool:
    """Whether ``t``'s wrapper launches its kernel: on a CUDA tensor; the
    plain version runs for a CPU tensor, and for a ``meta`` one, where it
    only makes the output's shape and type (a traced step's)."""
    if t.device.type in ("cpu", "meta"):
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"{what}: no kernel for device {t.device}")


def _k2_out(spec: LinearQuantSpec, relu: bool,
            out_float: Optional[torch.dtype]):
    """K2's clip bounds, output dtype and float grid for ``spec``: codes
    (uint8 on [0, 2^bits - 1] with ``relu`` and ``spec.out_unsigned``),
    or with ``out_float`` their values in that type."""
    if spec.bits > 8:
        raise ValueError(f"int8_matmul emits 8-bit codes, not {spec.bits}")
    unsigned = relu and spec.out_unsigned
    lo, hi = ((0, (1 << spec.bits) - 1) if unsigned
              else (-(1 << (spec.bits - 1)), (1 << (spec.bits - 1)) - 1))
    if out_float is None:
        return lo, hi, torch.uint8 if unsigned else torch.int8, None
    if out_float not in (torch.bfloat16, torch.float32):
        raise TypeError(f"K2's float epilogue writes bfloat16 or float32, "
                        f"not {out_float}")
    return lo, hi, out_float, spec.n_o


@cost.counted("int8_matmul", cost.int8_matmul)
def int8_matmul(x_int: torch.Tensor, w_int: torch.Tensor,
                b_int: Optional[torch.Tensor], spec: LinearQuantSpec,
                *, relu: bool = False,
                out_float: Optional[torch.dtype] = None) -> torch.Tensor:
    """(..., K) int8 @ (K, N) int8 -> (..., N) int8 with fused requant.

    Leading dims (a ragged (T,) token stream, a (B, S) batch) flatten into
    M.  ``x_int`` may hold uint8 post-ReLU codes.  Shift constants come
    from ``spec``, whose ``bits`` is at most 8.  With ``relu`` and
    ``spec.out_unsigned`` the output is uint8 on [0, 2^bits - 1].  With
    ``out_float`` (bfloat16 or float32) the epilogue writes the codes'
    values ``code * 2^-spec.n_o`` in that type instead (the module's
    dequantized output, ``qscheme.dequant`` of the codes bit for bit)."""
    lo, hi, out_dtype, n_o = _k2_out(spec, relu, out_float)
    *batch, k = x_int.shape
    n = w_int.shape[-1]
    if not _on_cuda(x_int, "int8_matmul"):
        return ref.int8_matmul_ref(x_int, w_int, b_int,
                                   shift=spec.requant_shift,
                                   bias_shift=spec.bias_shift, relu=relu,
                                   lo=lo, hi=hi, out_dtype=out_dtype,
                                   n_o=n_o).contiguous()
    m = math.prod(batch)
    if m == 0 or n == 0:
        return torch.empty((*batch, n), dtype=out_dtype, device=x_int.device)
    out = int8_matmul_cuda(x_int.reshape(m, k), w_int, b_int,
                           shift=spec.requant_shift,
                           bias_shift=spec.bias_shift, relu=relu, lo=lo,
                           hi=hi, out_dtype=out_dtype, n_o=n_o)
    LAUNCHES["int8_matmul"] += 1
    return out.reshape(*batch, n)


@cost.counted("int8_matmul_partial", cost.int8_matmul_partial)
def int8_matmul_partial(x_int: torch.Tensor,
                        w_int: torch.Tensor) -> torch.Tensor:
    """K2's rank-split form, first pass: (..., K) int8 / uint8 codes x
    (K, N) int8 codes -> the (..., N) int32 sums, no epilogue (a row-cut
    module's partial on one rank: this rank's rows of K).  Add the ranks'
    sums in int32 (an all-reduce: exact in any order), then
    :func:`int8_matmul_finish` runs the epilogue once."""
    *batch, k = x_int.shape
    n = w_int.shape[-1]
    if not _on_cuda(x_int, "int8_matmul_partial"):
        return ref.int8_matmul_partial_ref(x_int, w_int).contiguous()
    m = math.prod(batch)
    if m == 0 or n == 0:
        return torch.zeros((*batch, n), dtype=torch.int32,
                           device=x_int.device)
    out = int8_matmul_cuda(x_int.reshape(m, k), w_int, None, shift=0,
                           bias_shift=0, relu=False, lo=0, hi=0,
                           out_dtype=torch.int32)
    LAUNCHES["int8_matmul"] += 1
    FORM_LAUNCHES["int8_matmul_partial"] += 1
    return out.reshape(*batch, n)


@cost.counted("int8_matmul_finish", cost.int8_matmul_finish)
def int8_matmul_finish(acc: torch.Tensor, b_int: Optional[torch.Tensor],
                       spec: LinearQuantSpec, *, relu: bool = False,
                       out_float: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """K2's rank-split form, finish: the epilogue of :func:`int8_matmul`
    (bias, ReLU, shift-requant, clip; codes or, with ``out_float``, their
    values) once over the (..., N) int32 sums ``acc``.  Equal, bit for
    bit, to :func:`int8_matmul` of the product whose sums they are."""
    lo, hi, out_dtype, n_o = _k2_out(spec, relu, out_float)
    *batch, n = acc.shape
    if not _on_cuda(acc, "int8_matmul_finish"):
        return ref.int8_matmul_finish_ref(
            acc, b_int, shift=spec.requant_shift, bias_shift=spec.bias_shift,
            relu=relu, lo=lo, hi=hi, out_dtype=out_dtype,
            n_o=n_o).contiguous()
    m = math.prod(batch)
    if m == 0 or n == 0:
        return torch.empty((*batch, n), dtype=out_dtype, device=acc.device)
    out = int8_matmul_finish_cuda(acc.reshape(m, n), b_int,
                                  shift=spec.requant_shift,
                                  bias_shift=spec.bias_shift, relu=relu,
                                  lo=lo, hi=hi, out_dtype=out_dtype, n_o=n_o)
    LAUNCHES["int8_matmul"] += 1
    FORM_LAUNCHES["int8_matmul_finish"] += 1
    return out.reshape(*batch, n)


def _grouped_launched(counts: torch.Tensor) -> None:
    LAUNCHES["int8_matmul_grouped"] += 1
    if counts.ndim == 2 and counts.shape[1] > 1:
        FORM_LAUNCHES["int8_matmul_grouped_segments"] += 1


@cost.counted("int8_matmul_grouped", cost.int8_matmul_grouped)
def int8_matmul_grouped(x_int: torch.Tensor, w_int: torch.Tensor,
                        counts: torch.Tensor, spec: LinearQuantSpec, *,
                        rows_cap: Optional[int] = None,
                        out_float: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """The MoE experts' product: (E, C, K) int8 codes x (E, K, N) int8
    codes -> (E, C, N), expert by expert, each requantized by ``spec``
    (no bias), in ONE launch of K2's grouped form.  ``counts`` (int32 on
    the operands' device, read there) is (E,): expert e's rows ``<
    min(counts[e], rows_cap)`` are computed; or (E, D), the exchanged
    layout of a data cut: expert e's C rows are D segments of C / D rows
    (shard s's at ``[s C / D, s C / D + min(counts[e, s], rows_cap))``)
    and ``FORM_LAUNCHES["int8_matmul_grouped_segments"]`` counts the
    launch too.  ``rows_cap`` defaults to C / D; the plain version writes
    the other rows as 0, the kernel leaves them unwritten.  ``out_float``
    as :func:`int8_matmul`'s."""
    if spec.bits > 8:
        raise ValueError(f"int8_matmul_grouped emits 8-bit codes, not "
                         f"{spec.bits}")
    lo, hi = int_bounds(spec.bits)
    out_dtype, n_o = torch.int8, None
    if out_float is not None:
        if out_float not in (torch.bfloat16, torch.float32):
            raise TypeError(f"K2's float epilogue writes bfloat16 or "
                            f"float32, not {out_float}")
        out_dtype, n_o = out_float, spec.n_o
    cap = _grouped_rows_cap(x_int, counts, rows_cap)
    if not _on_cuda(x_int, "int8_matmul_grouped"):
        return ref.int8_matmul_grouped_ref(
            x_int, w_int, counts, rows_cap=cap, shift=spec.requant_shift,
            lo=lo, hi=hi, out_dtype=out_dtype, n_o=n_o).contiguous()
    out = int8_matmul_grouped_cuda(x_int, w_int, counts, rows_cap=cap,
                                   shift=spec.requant_shift, lo=lo, hi=hi,
                                   out_dtype=out_dtype, n_o=n_o)
    _grouped_launched(counts)
    return out


def _grouped_rows_cap(x_int: torch.Tensor, counts: torch.Tensor,
                      rows_cap: Optional[int]) -> int:
    segs = counts.shape[1] if counts.ndim == 2 else 1
    return x_int.shape[1] // segs if rows_cap is None else int(rows_cap)


@cost.counted("int8_matmul_grouped_partial", cost.int8_matmul_grouped_partial)
def int8_matmul_grouped_partial(x_int: torch.Tensor, w_int: torch.Tensor,
                                counts: torch.Tensor, *,
                                rows_cap: Optional[int] = None
                                ) -> torch.Tensor:
    """K2's grouped form with the int32 output kind: the experts' (E, C,
    N) int32 sums, no epilogue, over the rows :func:`int8_matmul_grouped`
    computes (``counts`` (E,) or (E, D) as there; other rows 0 on the
    CPU, unwritten on the card).  A mesh that cuts the experts' hidden
    over ``data`` adds the ranks' sums in int32 (exact in any order), then
    :func:`int8_matmul_finish` runs the epilogue once.  Counted as a
    grouped launch and in ``FORM_LAUNCHES["int8_matmul_grouped_partial"]``."""
    cap = _grouped_rows_cap(x_int, counts, rows_cap)
    if not _on_cuda(x_int, "int8_matmul_grouped_partial"):
        return ref.int8_matmul_grouped_partial_ref(
            x_int, w_int, counts, rows_cap=cap).contiguous()
    out = int8_matmul_grouped_cuda(x_int, w_int, counts, rows_cap=cap,
                                   shift=0, lo=0, hi=0,
                                   out_dtype=torch.int32)
    _grouped_launched(counts)
    FORM_LAUNCHES["int8_matmul_grouped_partial"] += 1
    return out


@cost.counted("int_conv2d", cost.int_conv2d)
def int_conv2d(x_int: torch.Tensor, w_int: torch.Tensor,
               b_int: Optional[torch.Tensor], spec: LinearQuantSpec, *,
               stride: int = 1, relu: bool = False,
               residual: Optional[tuple] = None) -> torch.Tensor:
    """Integer NHWC x HWIO convolution with XLA's "SAME" padding and the
    requant epilogue fused, in ONE launch of the convolution kernel (no
    im2col matrix).  ``x_int`` holds int8 or uint8 codes; returns
    (B, H', W', Cout) codes as ``int8_matmul``.  With ``residual =
    (shortcut, n_a, n_b, n_o)`` (Fig. 1(c)): those codes, on grid ``n_a``,
    and the shortcut's (B, H', W', Cout) int8 / uint8 codes on ``n_b`` are
    added on the finer grid, ReLU'd and requantized once to ``n_o``
    (``integer_ops.int_residual_add``'s saturating arithmetic, K7's) in the
    same launch: uint8 codes on 8 bits, whatever ``spec.bits`` (the
    reference's add requantizes at its default 8 bits)."""
    if spec.bits > 8:
        raise ValueError(f"int_conv2d emits 8-bit codes, not {spec.bits}")
    if not _on_cuda(x_int, "int_conv2d"):
        return ref.int_conv2d_ref(x_int, w_int, b_int, spec, stride=stride,
                                  relu=relu, residual=residual).contiguous()
    unsigned = relu and spec.out_unsigned
    lo, hi = int_bounds(spec.bits, unsigned)
    kw = dict(stride=stride, shift=spec.requant_shift,
              bias_shift=spec.bias_shift, relu=relu, lo=lo, hi=hi)
    if residual is None:
        out = int_conv_cuda(x_int, w_int, b_int,
                            out_dtype=torch.uint8 if unsigned else torch.int8,
                            **kw)
    else:
        shortcut, n_a, n_b, n_o = residual
        n_hi = max(n_a, n_b)
        out = int_conv_cuda(x_int, w_int, b_int, out_dtype=torch.uint8,
                            shortcut=shortcut,
                            res=ResidualShifts(n_hi - n_a, n_hi - n_b,
                                               n_hi - n_o), **kw)
    if out.numel():                 # an empty output launches nothing
        LAUNCHES["int_conv"] += 1
    return out


@cost.counted("quantize_act", cost.quantize_act)
def quantize_act(x: torch.Tensor, n: int, bits: int = 8,
                 unsigned: bool = False) -> torch.Tensor:
    """Elementwise Eq.-1 quantization of a float32 / bfloat16 tensor:
    int8 or uint8 codes (int32 when ``bits > 8``, on the CPU only: no
    path of the card quantizes wider than 8 bits).  On the card, K3's
    multi-grid form with one grid."""
    if not _on_cuda(x, "quantize_act"):
        return ref.quantize_ref(x, n=n, bits=bits,
                                unsigned=unsigned).contiguous()
    if bits > 8:
        raise ValueError(f"K3 emits 8-bit codes on the card, not {bits}")
    lo, hi = int_bounds(bits, unsigned)
    (out,) = quantize_multi_cuda(
        x, [int(n)], lo=lo, hi=hi,
        out_dtype=torch.uint8 if unsigned else torch.int8)
    if x.numel():                   # an empty tensor launches nothing
        LAUNCHES["quantize"] += 1
    return out


@cost.counted("quantize_multi", cost.quantize_multi)
def quantize_multi(x: torch.Tensor, ns, bits: int = 8
                   ) -> tuple[torch.Tensor, ...]:
    """Eq.-1 int8 codes of one float32 / bfloat16 tensor on each grid of
    ``ns`` (the inputs of modules that read the same activation), in ONE
    launch over x; equal grids share one codes tensor (one entry per
    ``ns`` entry).  At most three distinct grids."""
    if bits > 8:
        raise ValueError(f"quantize_multi emits 8-bit codes, not {bits}")
    if not _on_cuda(x, "quantize_multi"):
        return tuple(c.contiguous()
                     for c in ref.quantize_multi_ref(x, ns, bits=bits))
    distinct = list(dict.fromkeys(int(n) for n in ns))
    lo, hi = int_bounds(bits)
    codes = dict(zip(distinct, quantize_multi_cuda(x, distinct, lo=lo,
                                                   hi=hi)))
    if x.numel():                   # an empty tensor launches nothing
        LAUNCHES["quantize"] += 1
    return tuple(codes[int(n)] for n in ns)


@cost.counted("quantize_scatter", cost.quantize_scatter)
def quantize_scatter(k: torch.Tensor, v: torch.Tensor, index: torch.Tensor,
                     k_rows: torch.Tensor, v_rows: torch.Tensor, *,
                     n: int) -> None:
    """The int8 K/V write: K and V (R, W) float32 / bfloat16 rows quantized
    on the pool's grid ``n`` and stored IN PLACE to rows ``index`` (R,)
    (int32 or int64, on the pools' device) of the pools viewed as (P, W)
    int8 rows, in ONE launch for both.  Rows that share an index (padding
    rows on the trash block) race, as with ``index_copy_``."""
    if not _on_cuda(k, "quantize_scatter"):
        ref.quantize_scatter_ref(k, v, index, k_rows, v_rows, n=n)
        return
    lo, hi = int_bounds(8)
    quantize_scatter_cuda(k, v, index, k_rows, v_rows, n=int(n), lo=lo,
                          hi=hi)
    if k.numel():
        LAUNCHES["quantize"] += 1


@cost.counted("residual_requant", cost.residual_requant)
def residual_requant(a_int: torch.Tensor, b_int: torch.Tensor, *, n_a: int,
                     n_b: int, n_o: int, bits: int = 8, relu: bool = False,
                     saturate: bool = False) -> torch.Tensor:
    """Fused Fig. 1(c)/(d) residual add of two int8/uint8 code tensors on
    grids ``n_a`` / ``n_b``, requantized to ``n_o``: uint8 with ``relu``,
    else int8.  A negative requant shift wraps, as the TPU kernel's does,
    or saturates first with ``saturate`` (``integer_ops.int_residual_add``)."""
    if a_int.shape != b_int.shape:
        raise ValueError(f"shape mismatch {tuple(a_int.shape)} + "
                         f"{tuple(b_int.shape)}")
    if not _on_cuda(a_int, "residual_requant"):
        return ref.residual_requant_ref(a_int, b_int, n_a=n_a, n_b=n_b,
                                        n_o=n_o, bits=bits, relu=relu,
                                        saturate=saturate).contiguous()
    if bits > 8:
        raise ValueError(f"residual_requant emits 8-bit codes, not {bits}")
    n_hi = max(n_a, n_b)
    lo, hi = int_bounds(bits, relu)
    out = residual_requant_cuda(a_int, b_int, sa=n_hi - n_a, sb=n_hi - n_b,
                                shift=n_hi - n_o, relu=relu, lo=lo, hi=hi,
                                saturate=saturate)
    LAUNCHES["residual_requant"] += 1
    return out


def attn_shard_size(mesh) -> int:
    """Size of the mesh axis the attention heads are cut over, ``model``
    (1 without a mesh or without that axis: one rank holds every head)."""
    if mesh is None or "model" not in mesh.axis_names:
        return 1
    return mesh.shape["model"]


def _check_head_divisibility(kvh: int, tp: int) -> None:
    """A config's KV heads must split over the tensor axis in whole GQA
    groups (checked where the config is known: ``launch.steps`` and
    ``distributed.sharding.local_config``)."""
    if kvh % tp:
        raise NotImplementedError(
            f"attention shards KV heads over mesh axis 'model' (size "
            f"{tp}), which must divide the KV head count ({kvh}); the "
            f"reference's sequence-cut decode for such meshes is ROADMAP "
            f"Queue 1 item 8's")


def _rank_heads(q: torch.Tensor, kv: torch.Tensor, mesh, what: str) -> int:
    """The wrappers' backstop on a mesh: ``q`` (..., H, D) and the K/V
    (..., KVH, D) are this rank's slice, which must hold whole GQA groups
    (H a multiple of KVH).  Returns the axis size."""
    tp = attn_shard_size(mesh)
    if tp > 1 and q.shape[-2] % kv.shape[-2]:
        raise NotImplementedError(
            f"{what}: a rank of mesh axis 'model' (size {tp}) holds "
            f"{q.shape[-2]} query heads over {kv.shape[-2]} KV heads, not "
            f"whole GQA groups")
    return tp


@cost.counted("ragged_attention", cost.ragged_attention)
def ragged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, block_tables: torch.Tensor,
                     q_start: torch.Tensor, q_len: torch.Tensor,
                     kv_len: torch.Tensor, *,
                     kv_frac_bits: Optional[int] = None,
                     work: Optional[RaggedWork] = None,
                     mesh=None) -> torch.Tensor:
    """Unified ragged-batch attention over the paged KV pool.

    q (T, H, Dk) is the flattened mixed stream; ``q_start`` / ``q_len``
    / ``kv_len`` (S,) and ``block_tables`` (S, NBmax) say which rows
    belong to which sequence and how much KV each sees (contract in
    ``kernels.ragged_flash``).  Pools are (NB, bs, KVH, D): int8 Eq.-1
    codes on the 2^-``kv_frac_bits`` grid, or floats.  Scores are scaled
    by 1/sqrt(Dk).  ``work`` is the kernel's work list for these
    descriptors (``ragged_flash.plan_ragged_work``, on q's device); without
    it one is planned from the descriptors, read back to the host.
    Returns (T, H, Dv) with rows no descriptor covers exactly zero.  On a
    ``mesh`` q and the pools hold this rank's heads of its ``model`` axis;
    the descriptors and tables are every rank's (the work list does not
    depend on the head count)."""
    _rank_heads(q, k_pool, mesh, "ragged_attention")
    nkv = ref.kv_frac_bits_of(k_pool, kv_frac_bits)
    if not _on_cuda(q, "ragged_attention"):
        return ref.ragged_attention_ref(
            q, k_pool, v_pool, block_tables, q_start, q_len, kv_len,
            kv_frac_bits=kv_frac_bits).contiguous()
    if work is None and q.shape[0] and block_tables.shape[0]:
        work = plan_from_descriptors(q_start, q_len, kv_len,
                                     q.shape[1] // k_pool.shape[2], q.device)
    if work is None or work.n_items == 0:
        return torch.zeros((*q.shape[:2], v_pool.shape[-1]), dtype=q.dtype,
                           device=q.device)
    out = ragged_attention_cuda(q, k_pool, v_pool, block_tables, q_start,
                                q_len, kv_len, kv_frac_bits=nkv, work=work)
    LAUNCHES["ragged_attention"] += 1
    return out


@cost.counted("paged_attention", cost.paged_attention)
def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    q_positions: torch.Tensor, *,
                    kv_frac_bits: Optional[int] = None,
                    scale: Optional[float] = None,
                    work: Optional[RaggedWork] = None,
                    mesh=None) -> torch.Tensor:
    """Attention over the serving engine's paged KV block pool (the
    legacy per-shape engine's steps).

    q (B, C, H, Dk): C == 1 is a decode row per slot, C > 1 a prefill
    chunk or a speculative verify chunk.  Pools (NB, bs, KVH, D) hold
    every sequence's blocks, int8 Eq.-1 codes on the 2^-``kv_frac_bits``
    grid or floats; ``block_tables`` (B, W) maps each slot's logical
    blocks to pool blocks (any width: unused tail entries name the trash
    block and are masked); ``q_positions`` (B, C) are the queries'
    absolute positions, and a query attends to kv rows ``<=`` its own.
    Scores are scaled by ``scale`` (default 1/sqrt(Dk)).  ``work`` is
    K4's work list for these positions and this table width
    (``flash_attention.plan_paged_work``, on q's device); without it one
    is planned from the positions, read back to the host.  The CPU path
    takes no plan.  Returns (B, C, H, Dv) in q's dtype.  ``mesh`` as
    :func:`ragged_attention`'s."""
    _rank_heads(q, k_pool, mesh, "paged_attention")
    nkv = ref.kv_frac_bits_of(k_pool, kv_frac_bits)
    if not _on_cuda(q, "paged_attention"):
        return ref.paged_attention_ref(q, k_pool, v_pool, block_tables,
                                       q_positions, kv_frac_bits=kv_frac_bits,
                                       scale=scale).contiguous()
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    if work is None:
        work = paged_plan_from_positions(
            q_positions, table_width=block_tables.shape[1],
            block_size=k_pool.shape[1], groups=q.shape[2] // k_pool.shape[2],
            device=q.device)
    out = paged_attention_cuda(q, k_pool, v_pool, block_tables, q_positions,
                               kv_frac_bits=nkv, scale=scale, work=work)
    LAUNCHES["paged_attention"] += 1
    return out


@cost.counted("flash_attention", cost.flash_attention)
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    kv_frac_bits: Optional[int] = None,
                    causal: bool = True, mesh=None) -> torch.Tensor:
    """Flash attention over a dense cache: q (B, Sq, H, Dk) at positions
    0..Sq-1 x K/V (B, Skv, KVH, D) -> (B, Sq, H, Dv), scores scaled by
    1/sqrt(Dk).  K/V may be int8 Eq.-1 codes on the 2^-``kv_frac_bits``
    grid, converted exactly on the card.  Causal by default: kv rows past
    Sq (an empty cache tail) are masked and never read.  With
    ``causal=False`` every query attends to every kv row (the audio
    family's encoder, and the cross-attention over its memory, where Sq
    != Skv).

    Differentiable over float K/V: where autograd records (any of q, k, v
    requires grad), K5 runs the forward and the backward recomputes
    through the plain version, as the reference pairs its Pallas forward
    with the chunked reference's VJP (:class:`_FlashPrefill`).  Over int8
    codes a ``q`` that requires grad raises: the reference takes no VJP
    there.  On a ``mesh`` the operands hold this rank's heads (and batch
    slice) of its ``model`` axis; no collective runs: softmax is over each
    head's own rows."""
    _rank_heads(q, k, mesh, "flash_attention")
    nkv = ref.kv_frac_bits_of(k, kv_frac_bits)
    if not _on_cuda(q, "flash_attention"):
        return ref.flash_attention_ref(q, k, v, kv_frac_bits=kv_frac_bits,
                                       causal=causal).contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if k.dtype == torch.int8:
            raise NotImplementedError(
                "flash_attention: int8 K/V codes are the inference "
                "dataflow and take no gradient (the reference pairs K5 "
                "with a backward only over float K/V); attend over float "
                "K/V to train, or run without grad")
        return _FlashPrefill.apply(q, k, v, causal)
    return _flash_prefill_launch(q, k, v, nkv, causal)


def _flash_prefill_launch(q, k, v, nkv: int, causal: bool) -> torch.Tensor:
    out = flash_prefill_cuda(q, k, v, kv_frac_bits=nkv, causal=causal)
    LAUNCHES["flash_prefill"] += 1
    if not causal:
        FORM_LAUNCHES["flash_prefill_noncausal"] += 1
    return out


class _FlashPrefill(torch.autograd.Function):
    """K5 over float K/V with the reference's backward: the forward is the
    kernel (q, k, v saved), the backward autograd of the plain version
    recomputed on the saved inputs (the JAX wrapper's ``custom_vjp``,
    ``repro/kernels/ops.py:288-305``: no backward kernel)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return _flash_prefill_launch(q, k, v, 0, causal)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = ref.flash_attention_ref(*inputs, causal=ctx.causal)
            grads = torch.autograd.grad(out, inputs, g)
        return (*(gi if need else None for gi, need in
                  zip(grads, ctx.needs_input_grad)), None)


@cost.counted("flash_decode", cost.flash_decode)
def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 pos, kv_frac_bits: Optional[int] = None, mesh=None,
                 batch_shards: int = 1) -> torch.Tensor:
    """One-token decode over a dense cache: q (B, 1, H, Dk) at absolute
    position ``pos`` over (B, S_max, KVH, D), kv rows ``<= pos`` visible
    -> (B, 1, H, Dv).  On the card ``pos`` is a 0-d int32 tensor on q's
    device, which K6 reads there (the plain version also takes a host
    int).  The cache is read in place, up to ``pos`` only.  On a ``mesh``
    the operands hold this rank's heads of its ``model`` axis (and, with
    ``batch_shards`` > 1, its slice of the batch): the kernel's splits are
    planned for the whole mesh's heads and batch, so a head's partials
    combine in the order one rank's would."""
    tp = _rank_heads(q, k, mesh, "flash_decode")
    nkv = ref.kv_frac_bits_of(k, kv_frac_bits)
    if not _on_cuda(q, "flash_decode"):
        return ref.flash_decode_ref(q, k, v, pos=pos,
                                    kv_frac_bits=kv_frac_bits).contiguous()
    out = flash_decode_cuda(q, k, v, pos=pos, kv_frac_bits=nkv,
                            plan_shards=tp * batch_shards)
    LAUNCHES["flash_decode"] += 1
    return out
