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
  as jnp outside any kernel).  Without a cache the attention may be
  non-causal (whisper's encoder) or cross-attention over a memory
  (``kv_x``: whisper's decoder), which reads K and V from the memory and
  takes K5 in its non-causal form, or, for one query (a decode step),
  K6 at the memory's last row, where every row is visible.

DeepSeek's multi-head latent attention (``init_mla``, ``mla_attention``,
``MLACache``): without a cache (the forward that calibration captures)
its expanded form, K built from ``k_nope`` and the shared rope key and
attended through K5 when ``cfg.attn_kernel == 'flash'``; with a cache
(prefill and decode) its absorbed form over the compressed latent.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.core.qmodel import QuantContext
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.collectives import copy_to_model
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.cost import uncounted
from repro_torch.kernels.ragged_flash import RaggedWork
from repro_torch.models import common
from repro_torch.models.common import linear, rmsnorm, rotate

__all__ = ["KVCache", "MLACache", "PagedKVCache", "RaggedBatch", "init_gqa",
           "gqa_attention", "last_row", "init_mla", "mla_attention"]


class KVCache(NamedTuple):
    """Dense per-layer KV cache of the classic serving path: int8 Eq.-1
    codes (``cfg.kv_cache_bits == 8``) or the model dtype."""
    k: torch.Tensor     # (B, S_max, KVH, D)
    v: torch.Tensor     # (B, S_max, KVH, D)


class MLACache(NamedTuple):
    """MLA's per-layer cache of the classic path, in the model dtype: the
    compressed latent and the shared rope key."""
    c_kv: torch.Tensor  # (B, S_max, kv_lora)
    k_pe: torch.Tensor  # (B, S_max, rope_dim)


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


@functools.lru_cache(maxsize=None)
def last_row(n_rows: int, device: torch.device) -> torch.Tensor:
    """The 0-d int32 ``n_rows - 1`` on ``device``, made once per (rows,
    device): the position at which K6 attends one query over all of a
    cross-attention's ``n_rows`` memory rows.  The audio family's
    ``init_cache`` makes it, outside any captured decode step, which then
    reads this one tensor at every replay.  A constant: not counted."""
    with uncounted():
        return torch.full((), n_rows - 1, dtype=torch.int32, device=device)


def _whole_on_heads(t: torch.Tensor) -> torch.Tensor:
    """A tensor whole on every rank that acts on the rank's own heads (a
    gain the rules leave whole, MLA's rope key): on a tensor-parallel mesh
    its gradient is summed over the model axis (``distributed.
    collectives.copy_to_model``), so every rank holds the whole gradient;
    the value is ``t`` itself."""
    mesh = shd.tp_mesh()
    return t if mesh is None else copy_to_model(t, mesh)


def gqa_attention(ctx: QuantContext, p: dict, x: torch.Tensor,
                  cfg: ModelConfig, *,
                  rope: Optional[tuple[torch.Tensor, torch.Tensor]],
                  cache=None, cache_pos=None,
                  ragged: Optional[RaggedBatch] = None,
                  block_tables: Optional[torch.Tensor] = None,
                  paged_work: Optional[RaggedWork] = None,
                  causal: bool = True, kv_x: Optional[torch.Tensor] = None,
                  name: str = "attn"):
    """GQA with qk_norm and rope; ``rope`` is the (cos, sin) table of the
    tokens' absolute positions (``common.rope_tables``), or None for no
    rotation (the audio family's encoder and cross-attention).  Returns
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
    * no cache: attention over x's own (B, S) sequence (the forward that
      calibration captures), causal unless ``causal=False``; or, with
      ``kv_x`` (B, S_kv, d), cross-attention of x's queries over the
      memory's S_kv rows, every row visible: K and V are ``wk`` / ``wv``
      of the memory (their own quant point, ``wq``'s x another), and one
      query (a decode step) goes to K6 at position S_kv - 1
      (:func:`last_row`), more to K5's non-causal form.

    The returned cache holds the same tensors as the given one."""
    hd = cfg.resolved_head_dim
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    lead = x.shape[:-1]                    # (T,) ragged, (B, S) dense
    if (kv_x is not None or not causal) and (
            cache is not None or ragged is not None):
        raise ValueError("non-causal and cross-attention run without a "
                         "cache, as in the reference")
    if kv_x is not None and rope is not None:
        raise ValueError("cross-attention takes no rope (its memory rows "
                         "have no rope positions here)")

    # wo's input grid is threaded from wv's output grid: attention rows
    # are softmax-convex combinations of V rows
    biases = [p.get("bq"), p.get("bk"), p.get("bv")]
    if kv_x is None:
        # one quant point for the three (qlinears)
        q, k, v = common.linears(
            ctx, [f"{name}/wq", f"{name}/wk", f"{name}/wv"], x,
            [p["wq"], p["wk"], p["wv"]], biases)
        kv_lead = lead
    else:
        # wq reads x, wk and wv the memory: two quant points
        q = linear(ctx, f"{name}/wq", x, p["wq"], biases[0])
        k, v = common.linears(ctx, [f"{name}/wk", f"{name}/wv"], kv_x,
                              [p["wk"], p["wv"]], biases[1:])
        kv_lead = kv_x.shape[:-1]
    q, k, v = (q.reshape(*lead, h, hd), k.reshape(*kv_lead, kvh, hd),
               v.reshape(*kv_lead, kvh, hd))
    if cfg.qk_norm:
        # whole gains over the rank's own heads on a mesh: each rank's
        # gradient is partial, summed over the model axis
        q = rmsnorm(q, _whole_on_heads(p["q_norm"]), cfg.norm_eps)
        k = rmsnorm(k, _whole_on_heads(p["k_norm"]), cfg.norm_eps)
    if rope is not None:
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

    mesh = shd.current_mesh()
    if ragged is not None:
        write_rows(ragged.dest)
        out = kops.ragged_attention(
            q, cache.k, cache.v, ragged.block_tables, ragged.q_start,
            ragged.q_len, ragged.kv_len, kv_frac_bits=kv_frac_bits,
            work=ragged.work, mesh=mesh)
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
                                   work=paged_work, mesh=mesh)
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
        # the kernels take the mesh (this rank's heads; K6 plans its
        # splits for the whole mesh's); their plain versions need nothing
        on_mesh = dict(mesh=mesh) if flash else {}
        decode = functools.partial(
            kops.flash_decode, **on_mesh,
            batch_shards=shd.batch_shards()) if flash \
            else kref.flash_decode_ref
        if cache is not None and s == 1:
            out = decode(q, k, v, pos=cache_pos, kv_frac_bits=kv_frac_bits)
        elif kv_x is not None and s == 1:
            out = decode(q, k, v, pos=last_row(k.shape[1], x.device))
        else:
            if cache is not None and (on_card or cache_pos != 0):
                raise NotImplementedError(
                    "a multi-token step into a filled dense cache (a "
                    "chunked prefill) has no caller yet; prefill starts at "
                    "position 0")
            prefill = kops.flash_attention if flash \
                else kref.flash_attention_ref
            out = prefill(q, k, v, kv_frac_bits=kv_frac_bits,
                          causal=causal and kv_x is None, **on_mesh)
    # wo is row-cut on a mesh: its ranks' partial products are summed
    return (linear(ctx, f"{name}/wo", out.reshape(*lead, h * hd), p["wo"],
                   reduce=True), cache)


# ---------------------------------------------------------------------------
# MLA: DeepSeek-V3 multi-head latent attention with absorbed decode
# ---------------------------------------------------------------------------

def init_mla(init, cfg: ModelConfig) -> dict:
    m: MLAConfig = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": init.dense((d, m.q_lora_rank)),
        "q_norm": init.ones((m.q_lora_rank,)),
        "wq_b": init.dense((m.q_lora_rank, h * qk_head)),
        "wkv_a": init.dense((d, m.kv_lora_rank + m.qk_rope_head_dim)),
        "kv_norm": init.ones((m.kv_lora_rank,)),
        "wkv_b": init.dense((m.kv_lora_rank,
                             h * (m.qk_nope_head_dim + m.v_head_dim))),
        "wo": init.dense((h * m.v_head_dim, d)),
    }


def mla_attention(ctx: QuantContext, p: dict, x: torch.Tensor,
                  cfg: ModelConfig, *,
                  rope: tuple[torch.Tensor, torch.Tensor],
                  cache: Optional[MLACache] = None, cache_pos=0,
                  name: str = "mla"):
    """MLA over x (B, S, d); ``rope`` is the (cos, sin) table of the
    tokens' positions at ``qk_rope_head_dim`` (``common.rope_tables``).
    Returns (output, cache).

    * No cache: the expanded form.  K is ``k_nope`` with the rope key
      broadcast to every head (Dk = nope + rope, Dv = v_head_dim, KVH =
      H), causal from position 0, through K5 when ``cfg.attn_kernel ==
      'flash'`` (its 1/sqrt(Dk) is the reference's scale), else its plain
      version.
    * A cache (prefill from ``cache_pos == 0``, or a decode step at
      ``cache_pos``, a host int or a 0-d integer tensor read only on the
      device): the latent ``c_kv`` and the rope key are written IN PLACE
      at ``cache_pos`` and attention runs absorbed: ``W_uk`` folded into
      q, ``W_uv`` into the output, over the float ``wkv_b`` (never
      pre-quantized, ``models.model.qlinear_weight``), key rows ``t <=``
      each query's position.  These products stay outside any kernel, as
      in the reference; they run in float64 and round once to fp32, so
      the CPU and the card give the same values.

    On a tensor-parallel mesh ``cfg`` is the rank's view: ``wq_a`` and
    ``wkv_a`` whole, ``wq_b`` and ``wkv_b`` column-cut by head (the rank's
    ``n_heads``), both forms over the rank's heads, ``wo`` row-cut (its
    ranks' partials summed: K2's rank-split form in INT); the latent
    cache is whole on every rank (``sharding.cache_sharding_rules``).  In
    training the latents' gradients come whole to every rank (``wq_b``'s
    and ``wkv_b``'s inputs summed over the model axis, as the rope key's,
    which the rank's heads share), so ``wq_a``'s and ``wkv_a``'s are
    every rank's own, not summed."""
    m: MLAConfig = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    nope, rope_d, vdim = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim

    # the latent down-projections are whole on every rank
    cq = rmsnorm(linear(ctx, f"{name}/wq_a", x, p["wq_a"], whole=True),
                 p["q_norm"], cfg.norm_eps)
    q = linear(ctx, f"{name}/wq_b", cq, p["wq_b"]).reshape(
        b, s, h, nope + rope_d)
    q_nope, q_pe = q[..., :nope], rotate(q[..., nope:], *rope)

    kv_a = linear(ctx, f"{name}/wkv_a", x, p["wkv_a"], whole=True)
    c_kv = rmsnorm(kv_a[..., :m.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    k_pe = rotate(kv_a[..., m.kv_lora_rank:][:, :, None, :], *rope)[:, :, 0]
    if cache is None:
        # the rope key goes to the rank's own heads: its gradient, each
        # rank's partial, summed over the model axis
        k_pe = _whole_on_heads(k_pe)

    if cache is None:
        kv = linear(ctx, f"{name}/wkv_b", c_kv, p["wkv_b"]).reshape(
            b, s, h, nope + vdim)
        k = torch.cat([kv[..., :nope],
                       k_pe[:, :, None, :].expand(b, s, h, rope_d)], dim=-1)
        qq = torch.cat([q_nope, q_pe], dim=-1)
        if cfg.attn_kernel not in ("flash", "chunked"):
            raise ValueError(f"unknown attn_kernel={cfg.attn_kernel!r}; "
                             "expected 'chunked' or 'flash'")
        prefill = kops.flash_attention if cfg.attn_kernel == "flash" \
            else kref.flash_attention_ref
        out = prefill(qq, k, kv[..., nope:])
        return (linear(ctx, f"{name}/wo", out.reshape(b, s, h * vdim),
                       p["wo"], reduce=True), None)

    # absorbed path: the cache holds (c_kv, k_pe) only
    if isinstance(cache_pos, torch.Tensor):
        pos0 = cache_pos.to(device=x.device, dtype=torch.int64).reshape(())
    else:
        pos0 = torch.tensor(int(cache_pos), dtype=torch.int64,
                            device=x.device)
    q_pos = pos0 + torch.arange(s, device=x.device)            # (S,)
    cache.c_kv.index_copy_(1, q_pos, c_kv.to(cache.c_kv.dtype))
    cache.k_pe.index_copy_(1, q_pos, k_pe.to(cache.k_pe.dtype))

    f64 = torch.float64
    w_kv_b = p["wkv_b"].to(f64).reshape(m.kv_lora_rank, h, nope + vdim)
    c_full, pe_full = cache.c_kv.to(f64), cache.k_pe.to(f64)
    q_lat = torch.einsum("bshd,lhd->bshl", q_nope.to(f64),
                         w_kv_b[..., :nope])
    scores = (torch.einsum("bshl,btl->bhst", q_lat, c_full)
              + torch.einsum("bshd,btd->bhst", q_pe.to(f64), pe_full)) \
        / math.sqrt(nope + rope_d)
    t_pos = torch.arange(c_full.shape[1], device=x.device)
    scores = scores.masked_fill(t_pos[None, None, None, :]
                                > q_pos[None, None, :, None], -math.inf)
    probs = torch.softmax(scores, dim=-1)
    ctx_lat = torch.einsum("bhst,btl->bshl", probs, c_full)
    out = torch.einsum("bshl,lhv->bshv", ctx_lat, w_kv_b[..., nope:])
    out = out.to(torch.float32).reshape(b, s, h * vdim).to(x.dtype)
    # wo is row-cut on a mesh: its ranks' partial products are summed
    return linear(ctx, f"{name}/wo", out, p["wo"], reduce=True), cache
