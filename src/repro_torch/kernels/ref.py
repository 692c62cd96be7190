"""Plain PyTorch versions of the hand-written kernels.

The CPU path of every kernel wrapper in ``ops`` and the yardstick the
CUDA kernels are held to on the card.  Kept independent of the kernel
sources (no shared helper) so a bug cannot cancel itself out; semantics
mirror ``repro.kernels.ref`` with one deliberate difference: a negative
requant shift SATURATES before the left shift, as the TPU kernel and
``int_linear`` do (the JAX ``ref._requant`` does not).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.qscheme import dequant

__all__ = ["int8_matmul_ref", "ragged_token_meta", "ragged_attention_ref"]

_I32_MIN, _I32_MAX = -(2**31), 2**31 - 1


def _requant(acc: torch.Tensor, shift: int, lo: int, hi: int) -> torch.Tensor:
    acc = acc.to(torch.int32)
    if shift > 0:
        half = 1 << (shift - 1)
        acc = torch.where(acc >= 0, (acc + half) >> shift,
                          -(((-acc) + half) >> shift))
    elif shift < 0:
        bound = _I32_MAX >> (-shift)
        acc = torch.clamp(acc, -bound, bound) << (-shift)
    return torch.clamp(acc, lo, hi)


def int8_matmul_ref(x_int: torch.Tensor, w_int: torch.Tensor,
                    b_int: Optional[torch.Tensor], *, shift: int,
                    bias_shift: int = 0, relu: bool = False,
                    lo: int = -128, hi: int = 127,
                    out_dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """(..., K) x (K, N) int8 codes -> (..., N) requantized codes.

    The int32 accumulator is computed in float64 (exact below 2^53) and
    cast, since PyTorch has no int32 matmul on CUDA and no BLAS behind its
    int64 one on the CPU."""
    acc = torch.matmul(x_int.to(torch.float64),
                       w_int.to(torch.float64)).to(torch.int32)
    if b_int is not None:
        b = b_int.to(torch.int32)
        b = (b << bias_shift) if bias_shift >= 0 else _requant(
            b, -bias_shift, _I32_MIN, _I32_MAX)
        acc = acc + b
    if relu:
        acc = torch.clamp(acc, min=0)
    return _requant(acc, shift, lo, hi).to(out_dtype)


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
    if k_pool.dtype == torch.int8 and kv_frac_bits is None:
        raise ValueError("int8 KV codes require kv_frac_bits (the cache's "
                         "static Eq.-1 fractional bit)")
    sid, valid, pos = ragged_token_meta(q_start, q_len, kv_len, t)
    bt_tok = block_tables.long()[sid]                       # (T, NBmax)
    s_len = block_tables.shape[1] * bs
    k = k_pool[bt_tok].reshape(t, s_len, kvh, dk)
    v = v_pool[bt_tok].reshape(t, s_len, kvh, dv)
    if k.dtype == torch.int8:
        k = dequant(k, int(kv_frac_bits), out_dtype=q.dtype)
        v = dequant(v, int(kv_frac_bits), out_dtype=q.dtype)
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
