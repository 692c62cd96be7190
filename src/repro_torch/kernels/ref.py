"""Plain PyTorch versions of the hand-written kernels.

The CPU path of every kernel wrapper in ``ops`` and the yardstick the
CUDA kernels are held to on the card.  Kept independent of the kernel
sources (no shared helper) so a bug cannot cancel itself out; semantics
mirror ``repro.kernels.ref``.  A negative requant shift is a left shift
in two flavours, both kept: K2's (``int8_matmul_ref``) SATURATES to
``+-(2^31-1) >> |s|`` first, as the TPU int8-matmul kernel and
``int_linear`` do; K7's (``residual_requant_ref``) WRAPS by default, as the
TPU residual kernel and the JAX ``ref._requant`` do, and saturates with
``saturate=True``, the semantics of ``integer_ops.int_residual_add``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.integer_ops import LinearQuantSpec, im2col_same
from repro_torch.core.qscheme import dequant, int_bounds

__all__ = ["int8_matmul_ref", "int8_matmul_partial_ref",
           "int8_matmul_finish_ref", "int8_matmul_split_ref",
           "int8_matmul_grouped_ref", "int8_matmul_grouped_partial_ref",
           "int_conv2d_ref",
           "quantize_ref",
           "quantize_multi_ref", "quantize_scatter_ref",
           "residual_requant_ref", "ragged_token_meta", "ragged_attention_ref",
           "ragged_attention_split_ref", "paged_attention_ref",
           "paged_attention_split_ref",
           "flash_attention_ref", "flash_decode_ref", "flash_decode_split_ref",
           "kv_frac_bits_of", "DEFAULT_MASK_VALUE"]

_I32_MIN, _I32_MAX = -(2**31), 2**31 - 1

# the flash kernels' finite stand-in for -inf (the reference's value)
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def kv_frac_bits_of(k: torch.Tensor, kv_frac_bits: Optional[int]) -> int:
    """The KV grid's fractional bits: ``kv_frac_bits`` for int8 codes
    (required), 0 for float K/V."""
    if k.dtype == torch.int8:
        if kv_frac_bits is None:
            raise ValueError("int8 KV codes require kv_frac_bits (the "
                             "cache's static Eq.-1 fractional bit)")
        return int(kv_frac_bits)
    return 0


def _requant(acc: torch.Tensor, shift: int, lo: int, hi: int,
             saturate: bool = True) -> torch.Tensor:
    acc = acc.to(torch.int32)
    if shift > 0:
        half = 1 << (shift - 1)
        acc = torch.where(acc >= 0, (acc + half) >> shift,
                          -(((-acc) + half) >> shift))
    elif shift < 0:
        if saturate:
            bound = _I32_MAX >> (-shift)
            acc = torch.clamp(acc, -bound, bound)
        acc = acc << (-shift)          # int32 wrap-around when unsaturated
    return torch.clamp(acc, lo, hi)


def int8_matmul_ref(x_int: torch.Tensor, w_int: torch.Tensor,
                    b_int: Optional[torch.Tensor], *, shift: int,
                    bias_shift: int = 0, relu: bool = False,
                    lo: int = -128, hi: int = 127,
                    out_dtype: torch.dtype = torch.int8,
                    n_o: Optional[int] = None) -> torch.Tensor:
    """(..., K) x (K, N) int8 codes -> (..., N) requantized codes, or,
    with a float ``out_dtype`` (K2's float epilogue), the codes' values
    ``code * 2^-n_o`` in that type: :func:`int8_matmul_finish_ref` of
    :func:`int8_matmul_partial_ref`."""
    return int8_matmul_finish_ref(
        int8_matmul_partial_ref(x_int, w_int), b_int, shift=shift,
        bias_shift=bias_shift, relu=relu, lo=lo, hi=hi, out_dtype=out_dtype,
        n_o=n_o)


def int8_matmul_partial_ref(x_int: torch.Tensor,
                            w_int: torch.Tensor) -> torch.Tensor:
    """K2's rank-split first pass: the (..., N) int32 sums of (..., K) x
    (K, N) int8 / uint8 codes, no epilogue.  Computed in float64 (exact
    below 2^53) and cast, since PyTorch has no int32 matmul on CUDA and no
    BLAS behind its int64 one on the CPU."""
    return torch.matmul(x_int.to(torch.float64),
                        w_int.to(torch.float64)).to(torch.int32)


def int8_matmul_finish_ref(acc: torch.Tensor, b_int: Optional[torch.Tensor],
                           *, shift: int, bias_shift: int = 0,
                           relu: bool = False, lo: int = -128, hi: int = 127,
                           out_dtype: torch.dtype = torch.int8,
                           n_o: Optional[int] = None) -> torch.Tensor:
    """K2's epilogue, once, on the (..., N) int32 sums ``acc`` (one
    product's, or the int32 sum of the ranks' partials): bias, ReLU,
    shift-requant and clip to codes, or their values ``code * 2^-n_o`` in
    a float ``out_dtype``."""
    if not out_dtype.is_floating_point:
        return _int8_epilogue(acc, b_int, shift=shift, bias_shift=bias_shift,
                              relu=relu, lo=lo, hi=hi, out_dtype=out_dtype)
    if n_o is None:
        raise ValueError("a float output takes its grid n_o")
    codes = _int8_epilogue(acc, b_int, shift=shift, bias_shift=bias_shift,
                           relu=relu, lo=lo, hi=hi, out_dtype=torch.int32)
    return (codes.to(torch.float32) * (2.0 ** -int(n_o))).to(out_dtype)


def int8_matmul_split_ref(x_int: torch.Tensor, w_int: torch.Tensor,
                          b_int: Optional[torch.Tensor], *, k_chunk: int,
                          shift: int, bias_shift: int = 0,
                          relu: bool = False, lo: int = -128, hi: int = 127,
                          out_dtype: torch.dtype = torch.int8
                          ) -> torch.Tensor:
    """K2's split-K arithmetic, for the tests: K is cut into pieces of
    ``k_chunk`` rows, each piece's int32 partial product is taken alone,
    the partials are added in int32, and the epilogue runs once on the
    sum.  Bit-identical to ``int8_matmul_ref`` (integer addition is exact
    in any order)."""
    k = x_int.shape[-1]
    acc = None
    for k0 in range(0, k, k_chunk):
        part = torch.matmul(x_int[..., k0:k0 + k_chunk].to(torch.float64),
                            w_int[k0:k0 + k_chunk].to(torch.float64)
                            ).to(torch.int32)
        acc = part if acc is None else acc + part
    return _int8_epilogue(acc, b_int, shift=shift, bias_shift=bias_shift,
                          relu=relu, lo=lo, hi=hi, out_dtype=out_dtype)


def _grouped_live(counts: torch.Tensor, c: int, rows_cap: int
                  ) -> torch.Tensor:
    """(E, C) bool: the rows K2's grouped form computes.  ``counts`` (E,)
    is one segment of C rows an expert; (E, D) cuts each expert's C rows
    into D segments of C / D rows, segment s's first ``min(counts[e, s],
    rows_cap)`` live."""
    seg = counts.reshape(counts.shape[0], -1).to(torch.int64)
    stride = c // seg.shape[1]
    rows = torch.clamp(seg, 0, rows_cap)                      # (E, D)
    r = torch.arange(c, device=counts.device)
    return (r % stride)[None, :] < rows.repeat_interleave(stride, dim=1)


def int8_matmul_grouped_partial_ref(x_int: torch.Tensor, w_int: torch.Tensor,
                                    counts: torch.Tensor, *,
                                    rows_cap: int) -> torch.Tensor:
    """K2's grouped form with the int32 output kind: (E, C, K) x (E, K, N)
    int8 codes, expert by expert, the int32 sums (exact in float64) with
    no epilogue, rows outside each segment's ``min(counts, rows_cap)``
    (:func:`_grouped_live`) 0 (the kernel leaves them unwritten).  A
    data-cut hidden's partial: the ranks' sums added in int32, then
    :func:`int8_matmul_finish_ref` once."""
    acc = torch.bmm(x_int.to(torch.float64),
                    w_int.to(torch.float64)).to(torch.int32)
    live = _grouped_live(counts, x_int.shape[1], rows_cap)
    return torch.where(live[..., None], acc, 0)


def int8_matmul_grouped_ref(x_int: torch.Tensor, w_int: torch.Tensor,
                            counts: torch.Tensor, *, rows_cap: int,
                            shift: int, lo: int = -128, hi: int = 127,
                            out_dtype: torch.dtype = torch.int8,
                            n_o: Optional[int] = None) -> torch.Tensor:
    """K2's grouped form: (E, C, K) x (E, K, N) int8 codes, expert by
    expert, the int32 product (exact in float64) through the epilogue
    (no bias, no ReLU), codes or, with a float ``out_dtype``, their
    values ``code * 2^-n_o``.  ``counts`` (E,) or (E, D) segments as
    :func:`_grouped_live` reads them; rows outside each segment's
    ``min(counts, rows_cap)`` are 0 (the kernel leaves them unwritten)."""
    acc = int8_matmul_grouped_partial_ref(x_int, w_int, counts,
                                          rows_cap=rows_cap)
    codes = _int8_epilogue(acc, None, shift=shift, bias_shift=0, relu=False,
                           lo=lo, hi=hi, out_dtype=torch.int32)
    live = _grouped_live(counts, x_int.shape[1], rows_cap)
    codes = torch.where(live[..., None], codes, 0)
    if not out_dtype.is_floating_point:
        return codes.to(out_dtype)
    if n_o is None:
        raise ValueError("a float output takes its grid n_o")
    return (codes.to(torch.float32) * (2.0 ** -int(n_o))).to(out_dtype)


def _int8_epilogue(acc: torch.Tensor, b_int: Optional[torch.Tensor], *,
                   shift: int, bias_shift: int, relu: bool, lo: int, hi: int,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """K2's epilogue on the int32 sum: bias aligned onto the accumulator
    grid (left shift, or round-half-away right shift), ReLU, requant with
    a saturating negative shift, clip, cast."""
    if b_int is not None:
        b = b_int.to(torch.int32)
        b = (b << bias_shift) if bias_shift >= 0 else _requant(
            b, -bias_shift, _I32_MIN, _I32_MAX)
        acc = acc + b
    if relu:
        acc = torch.clamp(acc, min=0)
    return _requant(acc, shift, lo, hi).to(out_dtype)


def int_conv2d_ref(x_int: torch.Tensor, w_int: torch.Tensor,
                   b_int: Optional[torch.Tensor], spec: LinearQuantSpec, *,
                   stride: int = 1, relu: bool = False,
                   residual: Optional[tuple] = None) -> torch.Tensor:
    """The convolution kernel's plain version: NHWC codes x HWIO int8
    weights with XLA's "SAME" padding as the im2col gather and K2's plain
    version, (B, H', W', Cout) codes as ``int8_matmul_ref`` gives them;
    with ``residual = (shortcut, n_a, n_b, n_o)``, those codes (on grid
    ``n_a``) and the shortcut's (``n_b``) through K7's plain version in
    its saturating form with ReLU: 8-bit uint8 codes on ``n_o`` whatever
    ``spec.bits``, as the reference's add."""
    kh, kw, cin, cout = w_int.shape
    cols, (bsz, ho, wo) = im2col_same(x_int, kh, kw, stride)
    unsigned = relu and spec.out_unsigned
    lo, hi = int_bounds(spec.bits, unsigned)
    y = int8_matmul_ref(cols, w_int.reshape(kh * kw * cin, cout), b_int,
                        shift=spec.requant_shift, bias_shift=spec.bias_shift,
                        relu=relu, lo=lo, hi=hi,
                        out_dtype=torch.uint8 if unsigned else torch.int8
                        ).reshape(bsz, ho, wo, cout)
    if residual is None:
        return y
    shortcut, n_a, n_b, n_o = residual
    return residual_requant_ref(y, shortcut, n_a=n_a, n_b=n_b, n_o=n_o,
                                relu=True, saturate=True)


def quantize_ref(x: torch.Tensor, *, n: int, bits: int = 8,
                 unsigned: bool = False) -> torch.Tensor:
    """Eq. 1: ``clip(trunc(x * 2^n +- 0.5))`` in fp32 (ties away from
    zero), as int8 / uint8 codes, or int32 when ``bits > 8``."""
    lo, hi = int_bounds(bits, unsigned)
    s = x.to(torch.float32) * (2.0 ** int(n))
    r = torch.trunc(s + torch.where(s >= 0, 0.5, -0.5))
    out_dtype = ((torch.uint8 if unsigned else torch.int8) if bits <= 8
                 else torch.int32)
    return torch.clamp(r, lo, hi).to(out_dtype)


def quantize_multi_ref(x: torch.Tensor, ns, *,
                       bits: int = 8) -> tuple[torch.Tensor, ...]:
    """K3's multi-grid form: ``quantize_ref(x, n)`` for each ``n`` in
    ``ns``, one codes tensor a distinct grid; equal grids share one tensor
    (the result has one entry per ``ns`` entry)."""
    codes = {}
    for n in ns:
        if int(n) not in codes:
            codes[int(n)] = quantize_ref(x, n=int(n), bits=bits)
    return tuple(codes[int(n)] for n in ns)


def quantize_scatter_ref(k: torch.Tensor, v: torch.Tensor,
                         index: torch.Tensor, k_rows: torch.Tensor,
                         v_rows: torch.Tensor, *, n: int) -> None:
    """K3's quantize-and-scatter form: K and V (R, W) quantized to int8 on
    the grid ``n`` and copied IN PLACE to rows ``index`` (R,) of the
    (P, W) int8 pools (``index_copy_``: of rows that share an index, one's
    codes land)."""
    idx = index.long()
    k_rows.index_copy_(0, idx, quantize_ref(k, n=n))
    v_rows.index_copy_(0, idx, quantize_ref(v, n=n))


def residual_requant_ref(a_int: torch.Tensor, b_int: torch.Tensor, *,
                         n_a: int, n_b: int, n_o: int, bits: int = 8,
                         relu: bool = False,
                         saturate: bool = False) -> torch.Tensor:
    """Fig. 1(c)/(d): codes ``a`` (grid n_a) and ``b`` (grid n_b) are
    left-shifted onto ``max(n_a, n_b)`` in int32 (wrapping), added,
    optionally ReLU'd, then requantized once to ``n_o`` and clipped:
    uint8 with ``relu``, else int8.  A negative requant shift wraps unless
    ``saturate``."""
    n_hi = max(n_a, n_b)
    acc = (a_int.to(torch.int32) << (n_hi - n_a)) + \
        (b_int.to(torch.int32) << (n_hi - n_b))
    if relu:
        acc = torch.clamp(acc, min=0)
    lo, hi = int_bounds(bits, relu)
    return _requant(acc, n_hi - n_o, lo, hi, saturate=saturate).to(
        torch.uint8 if relu else torch.int8)


def ragged_token_meta(q_start: torch.Tensor, q_len: torch.Tensor,
                      kv_len: torch.Tensor, t: int):
    """Per-TOKEN view of the ragged descriptors: (sid, valid, pos) for each
    of the ``t`` stream rows.  ``q_start`` must be nondecreasing (padding
    descriptors carry ``q_start >= t``); rows no sequence covers are
    padding (``valid`` False, ``pos`` -1)."""
    s = q_start.shape[0]
    tok = torch.arange(t, dtype=torch.int32, device=q_start.device)
    sid = torch.clamp(torch.searchsorted(q_start, tok, right=True) - 1,
                      0, s - 1)
    local = tok - q_start[sid]
    valid = (local >= 0) & (local < q_len[sid])
    pos = torch.where(valid, kv_len[sid] - q_len[sid] + local,
                      torch.full_like(local, -1))
    return sid, valid, pos


def ragged_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                         v_pool: torch.Tensor, block_tables: torch.Tensor,
                         q_start: torch.Tensor, q_len: torch.Tensor,
                         kv_len: torch.Tensor, *,
                         kv_frac_bits: Optional[int] = None) -> torch.Tensor:
    """Gather-based ragged paged attention: every token gathers its own
    sequence's table from the pool, dequantizes to q's type, and attends
    under the causal mask ``kv_pos <= kv_len - q_len + local`` with an
    fp32 softmax scaled by 1/sqrt(Dk); P is cast to V's type before P.V,
    accumulation is fp32.  Rows covered by no descriptor return exactly
    zero."""
    t, h, dk = q.shape
    bs, kvh = k_pool.shape[1], k_pool.shape[2]
    dv = v_pool.shape[-1]
    g = h // kvh
    scale = 1.0 / math.sqrt(dk)
    nkv = kv_frac_bits_of(k_pool, kv_frac_bits)
    sid, valid, pos = ragged_token_meta(q_start, q_len, kv_len, t)
    bt_tok = block_tables.long()[sid]                       # (T, NBmax)
    s_len = block_tables.shape[1] * bs
    k = k_pool[bt_tok].reshape(t, s_len, kvh, dk)
    v = v_pool[bt_tok].reshape(t, s_len, kvh, dv)
    if k.dtype == torch.int8:
        k = dequant(k, nkv, out_dtype=q.dtype)
        v = dequant(v, nkv, out_dtype=q.dtype)
    else:
        k, v = k.to(q.dtype), v.to(q.dtype)
    qg = q.reshape(t, kvh, g, dk).float()
    s = torch.einsum("tkgd,tskd->tkgs", qg, k.float()) * scale
    kv_pos = torch.arange(s_len, device=q.device)
    mask = kv_pos[None, :] <= pos[:, None]                  # (T, S)
    s = torch.where(mask[:, None, None], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("tkgs,tskd->tkgd", p.to(v.dtype).float(), v.float())
    out = out.reshape(t, h, dv).to(q.dtype)
    # fully-masked padding rows came out of the softmax as NaN — they are
    # no sequence's output, pin them to zero
    return torch.where(valid[:, None, None], out, torch.zeros_like(out))


def ragged_attention_split_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor,
                               block_tables: torch.Tensor,
                               q_start: torch.Tensor, q_len: torch.Tensor,
                               kv_len: torch.Tensor, *, work,
                               kv_frac_bits: Optional[int] = None
                               ) -> torch.Tensor:
    """K1's work-list arithmetic, for the tests: ``work`` (a
    ``ragged_flash.RaggedWork`` with a host table) lists items (sequence,
    first token, tokens, kv begin, kv end, partial slot).  Each item
    gathers its kv range through the block table, casts K / V to q's type,
    scores its tokens' rows in fp32 at 2^-n / sqrt(Dk) under the causal
    rule, and forms (m, l, acc) — its own max, the unrounded sum of P, and
    P rounded to q's type times V; an unsplit item writes acc / l * 2^-n,
    a split one keeps its partials, and each combine entry merges its
    slots: m = max m_i, l = sum l_i e^(m_i - m), out = sum acc_i e^(m_i -
    m) / l * 2^-n.  Padding entries (``ragged_flash.pad_work``: no
    token, no slot) are skipped, as the kernel skips them.  Same function
    as ``ragged_attention_ref`` up to the order of the fp32 sums; rows no
    item covers are exactly 0."""
    t, h, dk = q.shape
    bs, kvh = k_pool.shape[1], k_pool.shape[2]
    dv = v_pool.shape[-1]
    g = h // kvh
    nkv = kv_frac_bits_of(k_pool, kv_frac_bits)
    scale = 2.0 ** (-nkv) / math.sqrt(dk)
    table = torch.as_tensor(work.table).cpu().tolist()
    qs, ql, kl = (a.cpu().tolist() for a in (q_start, q_len, kv_len))
    out = torch.zeros((t, h, dv), dtype=torch.float32, device=q.device)
    parts = {}
    for s, t0, nt, c0, c1, part, _, _ in table[:work.n_items]:
        if nt == 0:
            continue                    # a padding item (``pad_work``)
        rows = slice(qs[s] + t0, qs[s] + t0 + nt)
        qg = q[rows].reshape(nt, kvh, g, dk).float()
        pos = torch.arange(c0, c1, device=q.device)
        blk = block_tables[s].long()[pos // bs]
        k = k_pool[blk, pos % bs].to(q.dtype).float()        # (n, KVH, Dk)
        v = v_pool[blk, pos % bs].to(q.dtype).float()
        sc = torch.einsum("tkgd,nkd->tkgn", qg, k) * scale
        lim = kl[s] - ql[s] + t0 + torch.arange(nt, device=q.device)
        mask = pos[None, :] <= lim[:, None]                 # (nt, n)
        sc = torch.where(mask[:, None, None], sc, float("-inf"))
        m = sc.amax(dim=-1)
        p = torch.where(mask[:, None, None], torch.exp(sc - m[..., None]),
                        torch.zeros_like(sc))
        l = p.sum(dim=-1)
        acc = torch.einsum("tkgn,nkd->tkgd", p.to(q.dtype).float(), v)
        if part < 0:
            out[rows] = (acc / l[..., None] * 2.0 ** (-nkv)).reshape(nt, h, dv)
        else:
            parts[part] = (m, l, acc)
    for s, t0, nt, first, n, _, _, _ in table[work.n_items:]:
        if n == 0:
            continue                    # a padding combine entry
        ms = torch.stack([parts[first + i][0] for i in range(n)])
        m = ms.amax(dim=0)
        w = torch.where(ms == float("-inf"), torch.zeros_like(ms),
                        torch.exp(ms - m))
        l = sum(parts[first + i][1] * w[i] for i in range(n))
        acc = sum(parts[first + i][2] * w[i][..., None] for i in range(n))
        out[qs[s] + t0:qs[s] + t0 + nt] = (
            acc / l[..., None] * 2.0 ** (-nkv)).reshape(nt, h, dv)
    return out.to(q.dtype)


def paged_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, block_tables: torch.Tensor,
                        q_positions: torch.Tensor, *,
                        kv_frac_bits: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """K4's function by gathering: every slot gathers all ``W`` blocks
    its table (B, W) names from the pool (NB, bs, KVH, D), dequantizes
    them to q's type (int8 codes on the 2^-``kv_frac_bits`` grid), and q
    (B, C, H, Dk) attends with fp32 scores times ``scale`` (default
    1/sqrt(Dk)) under the per-(slot, query) mask ``kv_pos <=
    q_positions[b, c]`` (-inf); the fp32 softmax is cast to V's type
    before an fp32 P.V; (B, C, H, Dv) in q's dtype.  Any table width is
    taken: the speculative step's has a trailing trash column."""
    b, c, h, dk = q.shape
    bs, kvh = k_pool.shape[1], k_pool.shape[2]
    dv = v_pool.shape[-1]
    g = h // kvh
    scale = 1.0 / math.sqrt(dk) if scale is None else scale
    nkv = kv_frac_bits_of(k_pool, kv_frac_bits)
    bt = block_tables.long()
    s_len = bt.shape[1] * bs
    k = k_pool[bt].reshape(b, s_len, kvh, dk)
    v = v_pool[bt].reshape(b, s_len, kvh, dv)
    if k.dtype == torch.int8:
        k = dequant(k, nkv, out_dtype=q.dtype)
        v = dequant(v, nkv, out_dtype=q.dtype)
    else:
        k, v = k.to(q.dtype), v.to(q.dtype)
    qg = q.reshape(b, c, kvh, g, dk).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    kv_pos = torch.arange(s_len, device=q.device)
    mask = kv_pos[None, None, :] <= q_positions.long()[:, :, None]  # (B,C,S)
    s = torch.where(mask[:, None, None], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, c, h, dv).to(q.dtype)


def paged_attention_split_ref(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor,
                              block_tables: torch.Tensor,
                              q_positions: torch.Tensor, *, work,
                              kv_frac_bits: Optional[int] = None,
                              scale: Optional[float] = None) -> torch.Tensor:
    """K4's work-list arithmetic, for the tests: ``work`` (a
    ``ragged_flash.RaggedWork`` with a host table, from
    ``flash_attention.plan_paged_work``) lists items (slot, first token,
    tokens, kv begin, kv end, partial slot).  Each item gathers its kv
    range through its slot's block table, casts K / V to q's type, scores
    its tokens' rows in fp32 at ``scale`` (default 1/sqrt(Dk)) times 2^-n
    under each row's own ``q_positions`` entry, and forms (m, l, acc) —
    its own max, the unrounded sum of P, and P rounded to q's type times
    V; an unsplit item writes acc / l * 2^-n, a split one keeps its
    partials, and each combine entry merges its slots: m = max m_i, l =
    sum l_i e^(m_i - m), out = sum acc_i e^(m_i - m) / l * 2^-n.  Padding
    entries (``ragged_flash.pad_work``) are skipped.  Same function as
    ``paged_attention_ref`` up to the order of the fp32 sums; a row no
    item covers, or whose l is 0, is 0."""
    b, c, h, dk = q.shape
    bs, kvh = k_pool.shape[1], k_pool.shape[2]
    dv = v_pool.shape[-1]
    g = h // kvh
    nkv = kv_frac_bits_of(k_pool, kv_frac_bits)
    scale = (1.0 / math.sqrt(dk) if scale is None else scale) * 2.0 ** (-nkv)
    table = torch.as_tensor(work.table).cpu().tolist()
    qpos = q_positions.long()
    out = torch.zeros((b, c, h, dv), dtype=torch.float32, device=q.device)

    def finish(acc, l):
        l = torch.where(l == 0, torch.ones_like(l), l)
        return (acc / l[..., None] * 2.0 ** (-nkv)).reshape(-1, h, dv)

    parts = {}
    for slot, t0, nt, c0, c1, part, _, _ in table[:work.n_items]:
        if nt == 0:
            continue                    # a padding item (``pad_work``)
        qg = q[slot, t0:t0 + nt].reshape(nt, kvh, g, dk).float()
        pos = torch.arange(c0, c1, device=q.device)
        blk = block_tables[slot].long()[pos // bs]
        k = k_pool[blk, pos % bs].to(q.dtype).float()        # (n, KVH, Dk)
        v = v_pool[blk, pos % bs].to(q.dtype).float()
        sc = torch.einsum("tkgd,nkd->tkgn", qg, k) * scale
        mask = pos[None, :] <= qpos[slot, t0:t0 + nt, None]  # (nt, n)
        sc = torch.where(mask[:, None, None], sc, float("-inf"))
        m = sc.amax(dim=-1)
        p = torch.where(mask[:, None, None], torch.exp(sc - m[..., None]),
                        torch.zeros_like(sc))
        l = p.sum(dim=-1)
        acc = torch.einsum("tkgn,nkd->tkgd", p.to(q.dtype).float(), v)
        if part < 0:
            out[slot, t0:t0 + nt] = finish(acc, l)
        else:
            parts[part] = (m, l, acc)
    for slot, t0, nt, first, n, _, _, _ in table[work.n_items:]:
        if n == 0:
            continue                    # a padding combine entry
        ms = torch.stack([parts[first + i][0] for i in range(n)])
        m = ms.amax(dim=0)
        w = torch.where(ms == float("-inf"), torch.zeros_like(ms),
                        torch.exp(ms - m))
        l = sum(parts[first + i][1] * w[i] for i in range(n))
        acc = sum(parts[first + i][2] * w[i][..., None] for i in range(n))
        out[slot, t0:t0 + nt] = finish(acc, l)
    return out.to(q.dtype)


def _dense_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_pos: torch.Tensor,
                         kv_frac_bits: Optional[int]) -> torch.Tensor:
    """K5 / K6's function over a dense cache, whole rows at once: q
    (B, Sq, H, Dk) at absolute positions ``q_pos`` (Sq,) attends to the kv
    rows at positions <= its own.  K/V (B, Skv, KVH, D) are cast to q's
    dtype (int8 codes exactly); scores are fp32, scaled by
    2^-n / sqrt(Dk); a masked score is ``DEFAULT_MASK_VALUE``; P is cast to
    q's dtype before P.V; the result is ``acc * (1 / l) * 2^-n``.  l is 0
    only when there is no kv row, and such rows are 0.  The kernels' tiled online softmax computes
    the same function up to the order of the fp32 sums (and, in bf16, of
    where P is rounded)."""
    b, sq, h, dk = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // kvh
    nkv = kv_frac_bits_of(k, kv_frac_bits)
    if skv == 0:                 # no kv row: l == 0 on every row
        return q.new_zeros((b, sq, h, dv))
    kc, vc = k.to(q.dtype).float(), v.to(q.dtype).float()
    qg = q.reshape(b, sq, kvh, g, dk).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, kc) \
        * (2.0 ** (-nkv) / math.sqrt(dk))
    kv_pos = torch.arange(skv, device=q.device)
    mask = kv_pos[None, :] <= q_pos[:, None]                 # (Sq, Skv)
    s = torch.where(mask, s, torch.full_like(s, DEFAULT_MASK_VALUE))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)                                        # (B, KVH, G, Sq)
    acc = torch.einsum("bkgqs,bskd->bkgqd", p.to(q.dtype).float(), vc)
    out = acc * (1.0 / l)[..., None] * (2.0 ** (-nkv))
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, kv_frac_bits: Optional[int] = None,
                        causal: bool = True) -> torch.Tensor:
    """K5's function: causal attention of q (B, Sq, H, Dk) at positions
    0..Sq-1 over K/V (B, Skv, KVH, D), or with ``causal=False`` every
    query over every kv row (each query placed at the last kv position,
    so the mask keeps every row and the arithmetic is the causal
    function's); (B, Sq, H, Dv) in q's dtype."""
    if causal:
        q_pos = torch.arange(q.shape[1], device=q.device)
    else:
        q_pos = torch.full((q.shape[1],), k.shape[1] - 1, device=q.device)
    return _dense_attention_ref(q, k, v, q_pos, kv_frac_bits)


def _decode_pos(pos, device) -> torch.Tensor:
    """The decode position as a (1,) int64 tensor on ``device``: from a
    host int, or from a 0-d integer tensor without reading it back."""
    if isinstance(pos, torch.Tensor):
        if pos.numel() != 1 or pos.dtype.is_floating_point:
            raise ValueError(f"pos must be one integer, got a {pos.dtype} "
                             f"tensor of shape {tuple(pos.shape)}")
        return pos.reshape(1).to(device=device, dtype=torch.int64)
    return torch.full((1,), int(pos), dtype=torch.int64, device=device)


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     pos, kv_frac_bits: Optional[int] = None
                     ) -> torch.Tensor:
    """K6's function: q (B, 1, H, Dk) at absolute position ``pos`` (a host
    int or a 0-d integer tensor) over the cache (B, S_max, KVH, D), kv
    rows <= ``pos`` visible.  The whole cache is scored and the rows past
    ``pos`` masked by comparing their indices with it (they contribute
    exactly 0), so a tensor ``pos`` is never read on the host."""
    return _dense_attention_ref(q, k, v, _decode_pos(pos, q.device),
                                kv_frac_bits)


def flash_decode_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, pos, chunk: int,
                           kv_frac_bits: Optional[int] = None
                           ) -> torch.Tensor:
    """K6's split-KV arithmetic, for the tests: the cache's S_max rows are
    cut into chunks of ``chunk`` rows, as the kernel's splits are planned
    for the cache length.  Chunk i gives the partials (m_i, l_i, acc_i)
    one block of the kernel writes over its rows ``<= pos`` (its own max,
    the unrounded sum of P, and P rounded to q's dtype times V); a chunk
    that starts past ``pos`` is empty and writes l_i = 0 with m_i at the
    mask value.  The combine merges them, weighing an empty chunk by 0:
    m = max m_i, l = sum l_i e^(m_i - m), out = sum acc_i e^(m_i - m) / l
    * 2^-n.  Same function as ``flash_decode_ref`` up to the order of the
    fp32 sums."""
    b, _, h, dk = q.shape
    s_max, kvh, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = h // kvh
    nkv = kv_frac_bits_of(k, kv_frac_bits)
    p_last = _decode_pos(pos, q.device)
    qg = q.reshape(b, kvh, g, dk).float()
    ms, ls, accs = [], [], []
    for lo in range(0, s_max, chunk):
        hi = min(lo + chunk, s_max)
        live = torch.arange(lo, hi, device=q.device) <= p_last     # (rows,)
        kc = k[:, lo:hi].to(q.dtype).float()
        vc = v[:, lo:hi].to(q.dtype).float()
        s = torch.einsum("bkgd,bskd->bkgs", qg, kc) \
            * (2.0 ** (-nkv) / math.sqrt(dk))
        s = torch.where(live, s, torch.full_like(s, DEFAULT_MASK_VALUE))
        m = s.amax(dim=-1)
        p = torch.where(live, torch.exp(s - m[..., None]),
                        torch.zeros_like(s))
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bkgs,bskd->bkgd", p.to(q.dtype).float(),
                                 vc))
    m_all, l_all = torch.stack(ms), torch.stack(ls)         # (n, B, KVH, G)
    m = m_all.amax(dim=0)
    w = torch.where(l_all > 0, torch.exp(m_all - m), torch.zeros_like(m_all))
    l = (l_all * w).sum(dim=0)
    acc = (torch.stack(accs) * w[..., None]).sum(dim=0)
    out = acc * (1.0 / l)[..., None] * (2.0 ** (-nkv))
    return out.reshape(b, 1, h, dv).to(q.dtype)
