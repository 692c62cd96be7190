"""GQA attention (PyTorch counterpart of ``repro.models.attention``:
``KVCache``, ``PagedKVCache``, ``RaggedBatch``, ``init_gqa`` and the GQA
branches of ``gqa_attention``).

All projections run through ``qlinear`` (the paper's unified modules;
``wq`` / ``wk`` / ``wv`` through ``qlinears``, which in INT mode quantizes
their shared input once); softmax, rope and norms stay in float.  Three
families of paths:

* ragged serving: the whole mixed step is one flattened stream, K and V
  are quantized ONCE to Eq.-1 int8 codes and stored straight to their
  host-precomputed pool rows (``ops.quantize_scatter``, one K3 launch for
  both), and attention runs in one ``ops.ragged_attention`` launch (K1).
  ``cfg.attn_kernel`` is ignored, as in the reference;
* paged serving (the legacy per-shape engine): a (B, C) batch at per-token
  positions, its codes written by the same K3 launch into the pool rows
  its block tables name, then one ``ops.paged_attention`` launch (K4);
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
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.ragged_flash import RaggedWork
from repro_torch.models import common
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
      :class:`PagedKVCache`; each token's codes are written IN PLACE to
      its ``dest`` row (``ops.quantize_scatter``; ``index_copy_`` into a
      float pool) where the JAX engine donates the pool.
    * ``cache`` a :class:`PagedKVCache` with ``block_tables`` (B, W):
      x (B, S, d) at the per-token positions ``cache_pos`` (B, S); each
      token's codes go IN PLACE to pool row ``block_tables[b, pos // bs]
      * bs + pos % bs``, then K4 attends over the tables, on
      ``paged_work`` (``kernels.flash_attention.plan_paged_work`` of these
      positions, planned once per step) where given.
    * ``cache`` a :class:`KVCache`: x (B, S, d); the new K/V (Eq.-1 codes
      when the cache is int8, quantized on the way by one K3 launch) are
      written IN PLACE at ``cache_pos`` (the reference's
      ``dynamic_update_slice`` returns a new array).  ``S == 1`` is a
      decode step at position ``cache_pos``, a host int or a 0-d integer
      tensor on x's device that is never read on the host (the rows are
      written by ``index_copy_`` or K3 from indices built on the device,
      and K6 reads the position there), over the cache up to it; otherwise
      a prefill, which starts at ``cache_pos == 0`` and attends causally
      over the cache.
    * no cache: causal attention over x's own (B, S) sequence (the
      forward that calibration captures).

    The returned cache holds the same tensors as the given one."""
    hd = cfg.resolved_head_dim
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    lead = x.shape[:-1]                    # (T,) ragged, (B, S) dense

    # one quant point for the three (qlinears); wo's input grid is threaded
    # from wv's output grid: attention rows are softmax-convex combinations
    # of V rows
    q, k, v = common.linears(
        ctx, [f"{name}/wq", f"{name}/wk", f"{name}/wv"], x,
        [p["wq"], p["wk"], p["wv"]], [p.get("bq"), p.get("bk"), p.get("bv")])
    q, k, v = (q.reshape(*lead, h, hd), k.reshape(*lead, kvh, hd),
               v.reshape(*lead, kvh, hd))
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q, k = rotate(q, *rope), rotate(k, *rope)

    kv_frac_bits = None
    if cache is not None:
        if cache.k.dtype == torch.int8:
            kv_frac_bits = cfg.kv_cache_frac_bits
        else:
            k, v = k.to(cache.k.dtype), v.to(cache.v.dtype)

    def write_rows(index: torch.Tensor) -> None:
        """The new K/V rows to rows ``index`` of the cache viewed as (rows,
        KVH * D): int8 codes quantized on the way (one K3 launch), or
        floats by ``index_copy_``."""
        pool_rows = cache.k.numel() // (kvh * hd)
        k_rows = cache.k.view(pool_rows, kvh * hd)
        v_rows = cache.v.view(pool_rows, kvh * hd)
        kk, vv = k.reshape(-1, kvh * hd), v.reshape(-1, kvh * hd)
        if kv_frac_bits is not None:
            kops.quantize_scatter(kk, vv, index, k_rows, v_rows,
                                  n=kv_frac_bits)
        else:
            index = index.long()
            k_rows.index_copy_(0, index, kk)
            v_rows.index_copy_(0, index, vv)

    if ragged is not None:
        write_rows(ragged.dest)
        out = kops.ragged_attention(
            q, cache.k, cache.v, ragged.block_tables, ragged.q_start,
            ragged.q_len, ragged.kv_len, kv_frac_bits=kv_frac_bits,
            work=ragged.work)
    elif isinstance(cache, PagedKVCache):
        if block_tables is None or cache_pos is None:
            raise ValueError("the paged path takes block_tables and (B, S) "
                             "per-token positions as cache_pos")
        bs_blk = cache.k.shape[1]
        pos = cache_pos.long()
        blk = block_tables.long().gather(1, pos // bs_blk)
        write_rows((blk * bs_blk + pos % bs_blk).reshape(-1))    # (B*S,)
        out = kops.paged_attention(q, cache.k, cache.v, block_tables,
                                   cache_pos, kv_frac_bits=kv_frac_bits,
                                   work=paged_work)
    else:
        flash = cfg.attn_kernel == "flash"
        if cfg.attn_kernel not in ("flash", "chunked"):
            raise ValueError(f"unknown attn_kernel={cfg.attn_kernel!r}; "
                             "expected 'chunked' or 'flash'")
        bsz, s = x.shape[0], x.shape[1]
        on_card = isinstance(cache_pos, torch.Tensor)
        if cache is not None:
            # rows cache_pos + i, the offset read on the card when it is
            # a tensor there
            rows = (cache_pos.to(device=x.device, dtype=torch.int64)
                    + torch.arange(s, device=x.device) if on_card else
                    torch.arange(cache_pos, cache_pos + s, device=x.device))
            if kv_frac_bits is None:
                cache.k.index_copy_(1, rows, k)
                cache.v.index_copy_(1, rows, v)
            else:       # row b * S_max + cache_pos + i of the cache's rows
                write_rows((torch.arange(bsz, device=x.device)[:, None]
                            * cache.k.shape[1] + rows).reshape(-1))
            k, v = cache.k, cache.v
        if cache is not None and s == 1:
            decode = kops.flash_decode if flash else kref.flash_decode_ref
            out = decode(q, k, v, pos=cache_pos, kv_frac_bits=kv_frac_bits)
        else:
            if cache is not None and (on_card or cache_pos != 0):
                raise NotImplementedError(
                    "a multi-token step into a filled dense cache (a "
                    "chunked prefill) has no caller yet; prefill starts at "
                    "position 0")
            prefill = kops.flash_attention if flash \
                else kref.flash_attention_ref
            out = prefill(q, k, v, kv_frac_bits=kv_frac_bits)
    return (linear(ctx, f"{name}/wo", out.reshape(*lead, h * hd), p["wo"]),
            cache)
