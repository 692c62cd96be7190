"""GQA attention on the unified ragged serving path (PyTorch counterpart
of ``repro.models.attention``: ``PagedKVCache``, ``RaggedBatch``,
``init_gqa`` and the ragged branch of ``gqa_attention``).

All projections run through ``qlinear`` (the paper's unified modules);
softmax, rope and norms stay in float.  K and V are quantized ONCE to
Eq.-1 int8 codes, scattered to their host-precomputed pool rows, and
attention runs in one ``ops.ragged_attention`` launch for the whole
mixed step.  The dense-cache, legacy paged and MLA paths are not ported
yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.qmodel import QuantContext
from repro_torch.core.qscheme import quant
from repro_torch.kernels import ops as kops
from repro_torch.models.common import linear, rmsnorm, rotate

__all__ = ["PagedKVCache", "RaggedBatch", "init_gqa", "gqa_attention"]


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
    """
    dest: torch.Tensor          # (T,)
    block_tables: torch.Tensor  # (S, NBmax)
    q_start: torch.Tensor       # (S,)
    q_len: torch.Tensor         # (S,)
    kv_len: torch.Tensor        # (S,)


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
                  cache: PagedKVCache, ragged: RaggedBatch,
                  name: str = "attn") -> tuple[torch.Tensor, PagedKVCache]:
    """Ragged GQA over the paged pool: x (T, d) is the whole mixed step,
    ``rope`` the (cos, sin) tables of its tokens' absolute positions
    (``common.rope_tables``).

    The pool is updated IN PLACE (``index_copy_`` of each token's codes
    into its ``dest`` row) where the JAX engine donates the buffer; the
    returned cache holds the same tensors."""
    t = x.shape[0]
    hd = cfg.resolved_head_dim
    h, kvh = cfg.n_heads, cfg.n_kv_heads

    q = linear(ctx, f"{name}/wq", x, p["wq"], p.get("bq")).reshape(t, h, hd)
    k = linear(ctx, f"{name}/wk", x, p["wk"], p.get("bk")).reshape(t, kvh, hd)
    # wo's input grid is threaded from wv's output grid: attention rows
    # are softmax-convex combinations of V rows
    v = linear(ctx, f"{name}/wv", x, p["wv"], p.get("bv")).reshape(t, kvh, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q, k = rotate(q, *rope), rotate(k, *rope)

    nb_pool, bs_blk = cache.k.shape[0], cache.k.shape[1]
    kv_frac_bits = None
    if cache.k.dtype == torch.int8:
        kv_frac_bits = cfg.kv_cache_frac_bits
        k_c, v_c = quant(k, kv_frac_bits, 8), quant(v, kv_frac_bits, 8)
    else:
        k_c, v_c = k.to(cache.k.dtype), v.to(cache.v.dtype)
    dest = ragged.dest.long()
    cache.k.view(nb_pool * bs_blk, kvh, hd).index_copy_(0, dest, k_c)
    cache.v.view(nb_pool * bs_blk, kvh, hd).index_copy_(0, dest, v_c)
    out = kops.ragged_attention(
        q, cache.k, cache.v, ragged.block_tables, ragged.q_start,
        ragged.q_len, ragged.kv_len, kv_frac_bits=kv_frac_bits)
    return linear(ctx, f"{name}/wo", out.reshape(t, h * hd), p["wo"]), cache
