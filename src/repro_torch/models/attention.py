"""GQA attention (PyTorch counterpart of ``repro.models.attention``:
``KVCache``, ``PagedKVCache``, ``RaggedBatch``, ``init_gqa`` and the GQA
branches of ``gqa_attention``).

All projections run through ``qlinear`` (the paper's unified modules);
softmax, rope and norms stay in float.  Three families of paths:

* ragged serving: the whole mixed step is one flattened stream, K and V
  are quantized ONCE to Eq.-1 int8 codes, scattered to their
  host-precomputed pool rows, and attention runs in one
  ``ops.ragged_attention`` launch (K1).  ``cfg.attn_kernel`` is ignored,
  as in the reference;
* paged serving (the legacy per-shape engine): a (B, C) batch at per-token
  positions, its codes written into the pool rows its block tables name,
  then one ``ops.paged_attention`` launch (K4);
* dense cache (classic prefill / decode, and the no-cache forward that
  calibration runs): ``cfg.attn_kernel == 'flash'`` goes to
  ``ops.flash_attention`` (K5) / ``ops.flash_decode`` (K6), ``'chunked'``
  to their plain versions on any device (the reference computes that path
  as jnp outside any kernel).

The MLA path is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.qmodel import QuantContext
from repro_torch.core.qscheme import quant
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.ragged_flash import RaggedWork
from repro_torch.models.common import linear, rmsnorm, rotate

__all__ = ["KVCache", "PagedKVCache", "RaggedBatch", "init_gqa",
           "gqa_attention"]


class KVCache(NamedTuple):
    """Dense per-layer KV cache of the classic serving path: int8 Eq.-1
    codes (``cfg.kv_cache_bits == 8``) or the model dtype."""
    k: torch.Tensor     # (B, S_max, KVH, D)
    v: torch.Tensor     # (B, S_max, KVH, D)


class PagedKVCache(NamedTuple):
    """Serving-engine KV block pool: ALL slots' KV in one pool of fixed-
    size blocks; block 0 is the trash block padding rows write to.  int8
    Eq.-1 codes are written once at their token's step."""
    k: torch.Tensor     # (NB, BS, KVH, D) — int8 codes or model dtype
    v: torch.Tensor     # (NB, BS, KVH, D)


class RaggedBatch(NamedTuple):
    """One MIXED serving step as a flattened token stream.

    Sequence ``s`` owns stream rows ``[q_start[s], q_start[s] + q_len[s])``
    and sees ``kv_len[s]`` KV rows; ``dest`` is each token's flattened
    pool row (``block * block_size + pos % block_size``), padding rows
    point at the trash block.  All int32 tensors on the model's device.
    ``work`` is K1's work list for these descriptors
    (``kernels.ragged_flash.plan_ragged_work``, planned once per step and
    shared by every layer); without it K1 plans from the descriptors.
    """
    dest: torch.Tensor          # (T,)
    block_tables: torch.Tensor  # (S, NBmax)
    q_start: torch.Tensor       # (S,)
    q_len: torch.Tensor         # (S,)
    kv_len: torch.Tensor        # (S,)
    work: Optional[RaggedWork] = None


def init_gqa(init, cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = {
        "wq": init.dense((d, cfg.n_heads * hd)),
        "wk": init.dense((d, cfg.n_kv_heads * hd)),
        "wv": init.dense((d, cfg.n_kv_heads * hd)),
        "wo": init.dense((cfg.n_heads * hd, d)),
    }
    if cfg.attn_bias:
        p["bq"] = init.zeros((cfg.n_heads * hd,))
        p["bk"] = init.zeros((cfg.n_kv_heads * hd,))
        p["bv"] = init.zeros((cfg.n_kv_heads * hd,))
    if cfg.qk_norm:
        p["q_norm"] = init.ones((hd,))
        p["k_norm"] = init.ones((hd,))
    return p


def gqa_attention(ctx: QuantContext, p: dict, x: torch.Tensor,
                  cfg: ModelConfig, *, rope: tuple[torch.Tensor, torch.Tensor],
                  cache=None, cache_pos=None,
                  ragged: Optional[RaggedBatch] = None,
                  block_tables: Optional[torch.Tensor] = None,
                  paged_work: Optional[RaggedWork] = None,
                  name: str = "attn"):
    """GQA with qk_norm and rope; ``rope`` is the (cos, sin) table of the
    tokens' absolute positions (``common.rope_tables``).  Returns
    (output, cache).

    * ``ragged`` given: x (T, d) is the whole mixed step and ``cache`` the
      :class:`PagedKVCache`; each token's codes are written IN PLACE
      (``index_copy_`` into its ``dest`` row) where the JAX engine donates
      the pool.
    * ``cache`` a :class:`PagedKVCache` with ``block_tables`` (B, W):
      x (B, S, d) at the per-token positions ``cache_pos`` (B, S); each
      token's codes go IN PLACE to pool row ``block_tables[b, pos // bs]
      * bs + pos % bs``, then K4 attends over the tables, on
      ``paged_work`` (``kernels.flash_attention.plan_paged_work`` of these
      positions, planned once per step) where given.
    * ``cache`` a :class:`KVCache`: x (B, S, d); the new K/V (Eq.-1 codes
      when the cache is int8, quantized once) are written IN PLACE at
      ``cache_pos`` (an int; the reference's ``dynamic_update_slice``
      returns a new array).  ``S == 1`` is a decode step at position
      ``cache_pos`` over the cache up to it; otherwise a prefill, which
      starts at ``cache_pos == 0`` and attends causally over the cache.
    * no cache: causal attention over x's own (B, S) sequence (the
      forward that calibration captures).

    The returned cache holds the same tensors as the given one."""
    hd = cfg.resolved_head_dim
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    lead = x.shape[:-1]                    # (T,) ragged, (B, S) dense

    q = linear(ctx, f"{name}/wq", x, p["wq"], p.get("bq")).reshape(*lead, h, hd)
    k = linear(ctx, f"{name}/wk", x, p["wk"], p.get("bk")).reshape(*lead, kvh, hd)
    # wo's input grid is threaded from wv's output grid: attention rows
    # are softmax-convex combinations of V rows
    v = linear(ctx, f"{name}/wv", x, p["wv"], p.get("bv")).reshape(*lead, kvh, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q, k = rotate(q, *rope), rotate(k, *rope)

    kv_frac_bits = None
    if cache is not None:
        if cache.k.dtype == torch.int8:
            kv_frac_bits = cfg.kv_cache_frac_bits
            k, v = quant(k, kv_frac_bits, 8), quant(v, kv_frac_bits, 8)
        else:
            k, v = k.to(cache.k.dtype), v.to(cache.v.dtype)

    if ragged is not None:
        nb_pool, bs_blk = cache.k.shape[0], cache.k.shape[1]
        dest = ragged.dest.long()
        cache.k.view(nb_pool * bs_blk, kvh, hd).index_copy_(0, dest, k)
        cache.v.view(nb_pool * bs_blk, kvh, hd).index_copy_(0, dest, v)
        out = kops.ragged_attention(
            q, cache.k, cache.v, ragged.block_tables, ragged.q_start,
            ragged.q_len, ragged.kv_len, kv_frac_bits=kv_frac_bits,
            work=ragged.work)
    elif isinstance(cache, PagedKVCache):
        if block_tables is None or cache_pos is None:
            raise ValueError("the paged path takes block_tables and (B, S) "
                             "per-token positions as cache_pos")
        nb_pool, bs_blk = cache.k.shape[0], cache.k.shape[1]
        pos = cache_pos.long()
        blk = block_tables.long().gather(1, pos // bs_blk)
        idx = (blk * bs_blk + pos % bs_blk).reshape(-1)          # (B*S,)
        cache.k.view(nb_pool * bs_blk, kvh, hd).index_copy_(
            0, idx, k.reshape(-1, kvh, hd))
        cache.v.view(nb_pool * bs_blk, kvh, hd).index_copy_(
            0, idx, v.reshape(-1, kvh, hd))
        out = kops.paged_attention(q, cache.k, cache.v, block_tables,
                                   cache_pos, kv_frac_bits=kv_frac_bits,
                                   work=paged_work)
    else:
        flash = cfg.attn_kernel == "flash"
        if cfg.attn_kernel not in ("flash", "chunked"):
            raise ValueError(f"unknown attn_kernel={cfg.attn_kernel!r}; "
                             "expected 'chunked' or 'flash'")
        s = x.shape[1]
        if cache is not None:
            cache.k[:, cache_pos:cache_pos + s] = k
            cache.v[:, cache_pos:cache_pos + s] = v
            k, v = cache.k, cache.v
        if cache is not None and s == 1:
            decode = kops.flash_decode if flash else kref.flash_decode_ref
            out = decode(q, k, v, pos=cache_pos, kv_frac_bits=kv_frac_bits)
        else:
            if cache is not None and cache_pos != 0:
                raise NotImplementedError(
                    "a multi-token step into a filled dense cache (a "
                    "chunked prefill) has no caller yet; prefill starts at "
                    "position 0")
            prefill = kops.flash_attention if flash \
                else kref.flash_attention_ref
            out = prefill(q, k, v, kv_frac_bits=kv_frac_bits)
    return (linear(ctx, f"{name}/wo", out.reshape(*lead, h * hd), p["wo"]),
            cache)
