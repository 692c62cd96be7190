"""Top-level model API (PyTorch counterpart of ``repro.models.model`` for
the dense family: ``init_params``, the classic dense-cache path
``init_cache`` / ``forward`` / ``prefill`` / ``decode_step``, the serving
engine's ``init_paged_cache`` / ``ragged_step`` / ``paged_step``) and the
weight bridge from the JAX package's param tree.

Parameters are a plain dict of tensors: ``embed`` (Vp, d), ``ln_f`` (d,),
``lm_head`` (d, Vp) and ``blocks``, a list with one dict per layer —
where the JAX package stacks the layers on a leading axis and scans.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.qmodel import QuantContext
from repro_torch.models import attention as att
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (Initializer, embed, rmsnorm,
                                       rope_tables, unembed)

__all__ = ["init_params", "init_cache", "forward", "prefill", "decode_step",
           "init_paged_cache", "ragged_step", "paged_step",
           "from_jax_params", "model_dtype"]

Device = Optional[Union[str, torch.device]]


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _check_family(cfg: ModelConfig, what: str) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{what} covers the dense GQA family; got family="
            f"{cfg.family!r} (other families: ROADMAP Queue 1 items 9-10)")


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device: Device = None) -> dict:
    """Random weights from a seeded ``torch.Generator`` on ``device``
    (default ``cuda``).  Not the JAX package's numbers — its PRNG cannot
    be reproduced; tests carry JAX weights over with
    :func:`from_jax_params`."""
    _check_family(cfg, "init_params")
    dev = resolve_device(device)
    dt = model_dtype(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    init = Initializer(gen, dt, dev)
    params: dict[str, Any] = {
        "embed": init.dense((cfg.vocab_padded, cfg.d_model)),
        "ln_f": init.ones((cfg.d_model,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init.dense((cfg.d_model, cfg.vocab_padded))
    params["blocks"] = [tfm.init_dense_block(init, cfg)
                        for _ in range(cfg.n_layers)]
    return params


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               device: Device = None) -> dict:
    """Dense KV cache of the classic serving path: one (L, B, S_max, KVH,
    D) pair, int8 Eq.-1 codes when ``cfg.kv_cache_bits == 8``."""
    _check_family(cfg, "init_cache")
    dev = resolve_device(device)
    kv_dt = torch.int8 if cfg.kv_cache_bits == 8 else model_dtype(cfg)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"kv": att.KVCache(k=torch.zeros(shape, dtype=kv_dt, device=dev),
                              v=torch.zeros(shape, dtype=kv_dt, device=dev))}


def _dense_layers(params, x, positions, cfg, ctx, cache, cache_pos):
    dt = model_dtype(cfg)
    rope = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta, dt)
    for layer, p_l in enumerate(params["blocks"]):
        c_l = None if cache is None else att.KVCache(
            cache["kv"].k[layer], cache["kv"].v[layer])
        x, _ = tfm.dense_block(ctx, p_l, x, cfg, rope=rope, cache=c_l,
                               cache_pos=cache_pos)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return unembed(ctx, x, head)


def forward(params: dict, batch: dict, cfg: ModelConfig, ctx: QuantContext,
            *, cache: Optional[dict] = None) -> tuple[torch.Tensor, Any]:
    """Full-sequence forward of ``batch["tokens"]`` (B, S) from position 0.
    With ``cache`` (prefill), every layer's K/V are written into it at
    position 0 (in place).  Returns (logits (B, S, V) in the activation
    dtype, cache).  ``params`` may be a ``QuantizedParams.tree`` when
    ``ctx`` is the matching INT-mode context."""
    _check_family(cfg, "forward")
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = embed(params["embed"], tokens, model_dtype(cfg))
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    logits = _dense_layers(params, x, positions, cfg, ctx, cache, 0)
    return logits, cache


def prefill(params: dict, batch: dict, cfg: ModelConfig, ctx: QuantContext,
            max_seq: Optional[int] = None) -> tuple[torch.Tensor, dict]:
    """Prompt pass: a fresh cache of ``max_seq`` positions (default the
    prompt length) filled by :func:`forward`; returns (last position's
    logits (B, V), cache)."""
    b, s = batch["tokens"].shape
    cache = init_cache(cfg, b, max_seq or s, device=batch["tokens"].device)
    logits, cache = forward(params, batch, cfg, ctx, cache=cache)
    return logits[:, -1], cache


def decode_step(params: dict, tokens: torch.Tensor, cache: dict, pos: int,
                cfg: ModelConfig, ctx: QuantContext
                ) -> tuple[torch.Tensor, dict]:
    """One serving step: tokens (B, 1) at absolute position ``pos`` (a
    host int), the cache from :func:`prefill`, written at ``pos`` in
    place.  Returns (logits (B, V), cache)."""
    _check_family(cfg, "decode_step")
    b = tokens.shape[0]
    x = embed(params["embed"], tokens, model_dtype(cfg))
    positions = torch.full((b, 1), int(pos), dtype=torch.int64,
                           device=tokens.device)
    logits = _dense_layers(params, x, positions, cfg, ctx, cache, int(pos))
    return logits[:, 0], cache


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int, *,
                     device: Device = None) -> dict:
    """KV BLOCK POOL for the serving engine: one (L, NB, BS, KVH, D) arena
    shared by every in-flight request (int8 Eq.-1 codes when
    ``cfg.kv_cache_bits == 8``).  Block 0 is the trash block, so
    ``num_blocks`` must be >= 2."""
    _check_family(cfg, "paged serving")
    if num_blocks < 2:
        raise ValueError("pool needs >= 2 blocks (block 0 is the trash "
                         "block inactive slots write to)")
    dev = resolve_device(device)
    kv_dt = torch.int8 if cfg.kv_cache_bits == 8 else model_dtype(cfg)
    shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"paged_kv": att.PagedKVCache(
        k=torch.zeros(shape, dtype=kv_dt, device=dev),
        v=torch.zeros(shape, dtype=kv_dt, device=dev))}


def ragged_step(params: dict, tokens: torch.Tensor, cache: dict,
                positions: torch.Tensor, ragged: att.RaggedBatch,
                cfg: ModelConfig, ctx: QuantContext
                ) -> tuple[torch.Tensor, dict]:
    """One UNIFIED serving step over a flattened mixed token stream.

    ``tokens``/``positions`` are (T,): every live token of the step packed
    back to back; ``ragged`` carries the per-sequence descriptors and
    the pool destinations.  Returns (logits (T, V) in the activation
    dtype, cache); the pool tensors are updated in place.  Padding rows
    produce logits that no descriptor samples."""
    _check_family(cfg, "ragged_step")
    dt = model_dtype(cfg)
    x = embed(params["embed"], tokens, dt)
    # positions are the same in every layer: one rope table per step
    rope = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta, dt)
    kv = cache["paged_kv"]
    for layer, p_l in enumerate(params["blocks"]):
        x, _ = tfm.dense_block(
            ctx, p_l, x, cfg, rope=rope,
            cache=att.PagedKVCache(kv.k[layer], kv.v[layer]), ragged=ragged)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return unembed(ctx, x, head), cache


def paged_step(params: dict, tokens: torch.Tensor, cache: dict,
               positions: torch.Tensor, block_tables: torch.Tensor,
               cfg: ModelConfig, ctx: QuantContext, work=None
               ) -> tuple[torch.Tensor, dict]:
    """One step of the legacy per-shape engine over the paged KV block
    pool: tokens (B, C) at per-token absolute ``positions`` (B, C), with
    ``block_tables`` (B, W) mapping each slot's logical blocks to pool
    blocks.  Serves the continuous-batching decode (B = n_slots, C = 1),
    a chunked-prefill chunk (B = 1, C = chunk bucket) and a speculative
    verify chunk (B = n_slots, C = K + 1, one extra trash column in the
    table).  ``work`` is K4's work list for these positions
    (``kernels.flash_attention.plan_paged_work``, on the device), shared
    by every layer; without it each layer's K4 plans from the positions.
    Returns (logits (B, C, V) in the activation dtype, cache); the pool
    tensors are updated in place."""
    _check_family(cfg, "paged_step")
    dt = model_dtype(cfg)
    x = embed(params["embed"], tokens, dt)
    rope = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta, dt)
    kv = cache["paged_kv"]
    for layer, p_l in enumerate(params["blocks"]):
        x, _ = tfm.dense_block(
            ctx, p_l, x, cfg, rope=rope,
            cache=att.PagedKVCache(kv.k[layer], kv.v[layer]),
            cache_pos=positions, block_tables=block_tables,
            paged_work=work)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return unembed(ctx, x, head), cache


# ---------------------------------------------------------------------------
# weight bridge from the JAX package
# ---------------------------------------------------------------------------

def _to_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")   # writable, contiguous
    if a.dtype.name == "bfloat16":          # ml_dtypes' numpy bfloat16
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _tree(node, fn):
    if isinstance(node, dict):
        return {k: _tree(v, fn) for k, v in node.items()}
    return fn(node)


def from_jax_params(np_tree: dict, cfg: ModelConfig, *,
                    device: Device = None) -> dict:
    """The JAX param tree (as numpy arrays: ``jax.tree.map(np.asarray,
    params)``, or a ``QuantizedParams.tree``) as the port's params.

    Scanned ``(L, ...)`` block leaves are unstacked into one dict per
    layer; dtypes are kept (bf16 stays bf16, int8 codes stay int8).
    Nothing here imports JAX."""
    _check_family(cfg, "from_jax_params")
    dev = resolve_device(device)
    out = {k: _tree(v, lambda a: _to_tensor(a, dev))
           for k, v in np_tree.items() if k != "blocks"}
    blocks = np_tree["blocks"]
    out["blocks"] = [_tree(blocks, lambda a, i=i: _to_tensor(a[i], dev))
                     for i in range(cfg.n_layers)]
    return out
