"""Top-level model API (PyTorch counterpart of ``repro.models.model``):
``init_params``; the classic path ``init_cache`` / ``forward`` /
``prefill`` / ``decode_step`` for the dense GQA families (``dense``, and
``vlm``, whose early-fusion image tokens share the text vocabulary and
run the same blocks) over a dense KV cache, for the mixture-of-experts
family (``moe``: leading dense layers, then MoE layers, attention GQA
over a dense KV cache or DeepSeek's MLA over its latent cache), for the
audio encoder-decoder (``audio``: whisper; a non-causal encoder over stub
frame embeddings, then a causal decoder with cross-attention over the
encoder's memory, which the cache keeps), and for the recurrent
(``ssm``: RWKV6) and hybrid (zamba2) families over their carried states
(and the hybrid's dense KV cache for its shared attention block), the
decode step O(1) in the recurrences; the dense families' serving-engine
steps ``init_paged_cache`` / ``ragged_step`` / ``paged_step``; the
recurrent families' fixed-slab serving substrate ``init_paged_state`` /
``paged_recurrent_step``; and the weight bridge from the JAX package's
param tree.

Parameters are a plain dict of tensors: ``embed`` (Vp, d), ``ln_f`` (d,),
``lm_head`` (d, Vp) and ``blocks``, a list with one dict per layer —
where the JAX package stacks the layers on a leading axis and scans (the
hybrid's Mamba blocks on two axes, group and block; here group ``i``
holds ``blocks[i * attn_every:(i + 1) * attn_every]``) — and, for the
hybrid, ``shared``, the one shared attention block; for ``moe``,
``dense_blocks`` (the leading dense layers, when the config has any) and
``blocks`` (the MoE layers); for ``audio``, ``enc_blocks`` (the encoder
layers), ``ln_enc`` and ``blocks`` (the decoder layers).
"""
from __future__ import annotations

import functools
from typing import Any, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.qmodel import QuantContext
from repro_torch.core.qscheme import round_half_away
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.collectives import sum_over_data
from repro_torch.kernels.cost import uncounted
from repro_torch.models import attention as att
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (Initializer, embed, rmsnorm,
                                       rope_tables, unembed)

__all__ = ["init_params", "init_cache", "forward", "loss_fn", "prefill",
           "decode_step",
           "init_paged_cache", "ragged_step", "paged_step",
           "init_paged_state", "paged_recurrent_step", "qlinear_weight",
           "from_jax_params", "from_jax_opt_state", "model_dtype"]

Device = Optional[Union[str, torch.device]]


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


_DENSE = ("dense", "vlm")
_RECURRENT = ("ssm", "hybrid")
_MOE = "moe"
_AUDIO = "audio"


def _check_family(cfg: ModelConfig, what: str,
                  families: tuple = _DENSE + (_MOE, _AUDIO) + _RECURRENT
                  ) -> None:
    if cfg.family in families:
        # the mesh's refusals
        shd.local_config(cfg, shd.current_mesh(), train=shd.training())
        return
    if cfg.family in (_MOE, _AUDIO):
        raise NotImplementedError(
            f"{what} does not serve the {cfg.family!r} family; it is served "
            f"by the classic path (prefill, decode_step), as in the "
            f"reference, whose engines refuse it")
    if families == _RECURRENT:
        raise NotImplementedError(
            f"{what} covers the recurrent families (ssm, hybrid); got "
            f"family={cfg.family!r}")
    if cfg.family in _RECURRENT:
        raise NotImplementedError(
            f"{what} covers the dense GQA families; the {cfg.family!r} "
            f"family is served by the classic path (prefill, decode_step) "
            f"and the fixed-slab substrate (init_paged_state, "
            f"paged_recurrent_step)")
    raise NotImplementedError(
        f"{what} covers the dense GQA (dense, vlm), moe, audio, ssm and "
        f"hybrid families; got family={cfg.family!r}")


def _rank_view(cfg: ModelConfig, mesh=None) -> ModelConfig:
    """``cfg`` as one rank of the mesh (``mesh``, default the scope's)
    sees it: heads, KV heads and d_ff divided by the model axis
    (``distributed.sharding.local_config``, under training's rules in a
    training scope); ``cfg`` itself off a mesh."""
    return shd.local_config(cfg, shd.current_mesh() if mesh is None
                            else mesh, train=shd.training())


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device: Device = None) -> dict:
    """Random weights from a seeded ``torch.Generator`` on ``device``
    (default ``cuda``; ``"meta"`` gives the shapes and dtypes without
    storage).  Not the JAX package's numbers — its PRNG cannot be
    reproduced; tests carry JAX weights over with
    :func:`from_jax_params`."""
    _check_family(cfg, "init_params")
    meta = device is not None and torch.device(device).type == "meta"
    dev = torch.device("meta") if meta else resolve_device(device)
    dt = model_dtype(cfg)
    gen = torch.Generator(device="cpu" if meta else dev)
    gen.manual_seed(seed)
    init = Initializer(gen, dt, dev)
    params: dict[str, Any] = {
        "embed": init.dense((cfg.vocab_padded, cfg.d_model)),
        "ln_f": init.ones((cfg.d_model,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init.dense((cfg.d_model, cfg.vocab_padded))
    if cfg.family in _DENSE:
        params["blocks"] = [tfm.init_dense_block(init, cfg)
                            for _ in range(cfg.n_layers)]
    elif cfg.family == _MOE:
        nd = cfg.moe.n_dense_layers
        if nd:
            params["dense_blocks"] = [tfm.init_dense_block(init, cfg)
                                      for _ in range(nd)]
        params["blocks"] = [tfm.init_moe_block(init, cfg)
                            for _ in range(cfg.n_layers - nd)]
    elif cfg.family == _AUDIO:
        params["enc_blocks"] = [tfm.init_encoder_block(init, cfg)
                                for _ in range(cfg.encdec.n_encoder_layers)]
        params["ln_enc"] = init.ones((cfg.d_model,))
        params["blocks"] = [tfm.init_decoder_block(init, cfg)
                            for _ in range(cfg.n_layers)]
    elif cfg.family == "ssm":
        params["blocks"] = [tfm.init_rwkv_block(init, cfg)
                            for _ in range(cfg.n_layers)]
    else:
        params["blocks"] = [tfm.init_mamba_block(init, cfg)
                            for _ in range(_n_groups(cfg)
                                           * cfg.hybrid.attn_every)]
        params["shared"] = tfm.init_shared_attn(init, cfg)
    return params


def _n_groups(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.hybrid.attn_every


# leaves that reach ``qlinear`` (or, the MoE experts' stacks, the
# experts' integer product) as a weight (the other matrices of the
# recurrent blocks -- LoRA mixes, token-shift mixes, the bonus, the conv
# taps -- are float operands outside any unified module, and so is the
# MoE router); the RWKV channel mix's weights sit beside the time mix's
# under "rwkv", but its qlinear calls name the module "rwkv_ffn"
# (``rwkv.rwkv6_channel_mix``).  MLA's weights sit under "attn" but its
# calls name the module "mla"; its ``wkv_b`` stays float, since the
# absorbed path reads it as a float matrix.  whisper's encoder and decoder
# share the module names ``attn/*`` and ``mlp/*``; its cross-attention is
# ``cross/*``; its biases stay float (quantized per call on ``n_b``).
_QLINEAR_LEAVES = {"wq", "wk", "wv", "wo", "w1", "w2", "w3", "lm_head",
                   "wr", "wg", "wk_ffn", "wv_ffn", "wr_ffn", "w_in",
                   "w_out", "in_proj", "wq_a", "wq_b", "wkv_a"}
_CHANNEL_MIX = {"wk_ffn": "rwkv_ffn/wk", "wv_ffn": "rwkv_ffn/wv",
                "wr_ffn": "rwkv_ffn/wr"}


def qlinear_weight(path: str, leaf, cfg: Optional[ModelConfig] = None
                   ) -> Optional[str]:
    """The module name of the ``qlinear`` call that reads the params leaf
    at ``path`` as its weight, or None when the leaf is no such weight.

    The name is the path without its layer prefix (``blocks/3/attn/wq``
    -> ``attn/wq``, ``dense_blocks/0/mlp/w1`` -> ``mlp/w1``, whisper's
    ``enc_blocks/0/attn/wq`` -> ``attn/wq`` and ``blocks/3/cross/wq`` ->
    ``cross/wq``,
    ``blocks/3/ssm/w_in`` -> ``ssm/w_in``, ``shared/attn/wq``,
    ``lm_head``; the MoE expert stacks ``blocks/3/moe/w1`` -> ``moe/w1``
    and its shared expert ``moe/shared/w1``), except for the RWKV channel
    mix (``blocks/3/rwkv/wk_ffn`` -> ``rwkv_ffn/wk``) and for an MLA
    ``cfg``, whose attention calls name the module ``mla`` (``attn/wq_a``
    -> ``mla/wq_a``).  The router and MLA's ``wkv_b`` stay float (None).
    INT mode quantizes these leaves to int8 codes once, each on its
    module's grid (``quantize_weight_tree``'s ``name_fn``, with ``cfg``
    bound), the codes its call would give."""
    if not (isinstance(leaf, torch.Tensor) and leaf.ndim >= 2):
        return None
    parts = path.split("/")
    if parts[-1] not in _QLINEAR_LEAVES:
        return None
    if parts[-1] in _CHANNEL_MIX:
        return _CHANNEL_MIX[parts[-1]]
    if parts[0] in ("blocks", "dense_blocks", "enc_blocks"):
        parts = parts[2:]
    if parts[0] == "attn" and cfg is not None and cfg.mla is not None:
        parts[0] = "mla"
    return "/".join(parts)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               device: Device = None, mesh=None) -> dict:
    """Cache of the classic serving path, zeros.  Dense: one dense KV pair
    ``kv`` (L, B, S_max, KVH, D), int8 Eq.-1 codes when
    ``cfg.kv_cache_bits == 8``.  MoE: ``kv`` for the MoE layers and
    ``kv_dense`` for the leading dense layers (when there are any), each
    such a pair or, under MLA, an ``MLACache`` of (L, B, S_max, kv_lora)
    latents and (L, B, S_max, rope_dim) rope keys in the model dtype.
    RWKV6 (``ssm``): ``state``, an
    ``RWKVState`` of (L, B, 1, d) token-shift inputs in the model dtype
    and the (L, B, H, 64, 64) fp32 wkv.  Hybrid: ``ssm``, an ``SSMState``
    of (G, g, B, ...) arenas (G groups of g Mamba blocks; the conv window
    in the model dtype, the state fp32), and the shared block's dense KV
    pair ``kv`` (G, B, S_max, KVH, D).  Audio: the decoder's dense KV pair
    ``kv`` and ``memory``, the encoder's output (B, S_enc, d) in the model
    dtype, which prefill writes in place.  The reference's dtypes,
    component by component.  On a tensor-parallel mesh (``mesh``, default
    the scope's) the KV pairs hold this rank's KV heads, (L, B, S_max,
    KVH / M, D), ``batch`` being this rank's rows; the recurrent states
    and the audio family's memory are whole over the model axis."""
    _check_family(cfg, "init_cache")
    cfg = _rank_view(cfg, mesh)
    dev = resolve_device(device)
    dt = model_dtype(cfg)

    def stacked(lead: tuple, state):
        return type(state)(*(torch.zeros(lead + tuple(z.shape),
                                         dtype=z.dtype, device=dev)
                             for z in state))

    if cfg.family == "ssm":
        return {"state": stacked((cfg.n_layers,), rwkv_lib.zero_state(
            cfg, batch, dt, device="meta"))}
    kv_dt = torch.int8 if cfg.kv_cache_bits == 8 else dt

    def kv_pair(n_layers: int):
        if cfg.mla is not None:
            m = cfg.mla
            return att.MLACache(
                c_kv=torch.zeros((n_layers, batch, max_seq, m.kv_lora_rank),
                                 dtype=dt, device=dev),
                k_pe=torch.zeros((n_layers, batch, max_seq,
                                  m.qk_rope_head_dim), dtype=dt, device=dev))
        shape = (n_layers, batch, max_seq, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        return att.KVCache(k=torch.zeros(shape, dtype=kv_dt, device=dev),
                           v=torch.zeros(shape, dtype=kv_dt, device=dev))

    if cfg.family in _DENSE:
        return {"kv": kv_pair(cfg.n_layers)}
    if cfg.family == _AUDIO:
        s_enc = cfg.encdec.encoder_seq
        memory = torch.zeros((batch, s_enc, cfg.d_model), dtype=dt,
                             device=dev)
        # the cross decode's K6 position, made here, outside any capture
        att.last_row(s_enc, memory.device)
        return {"kv": kv_pair(cfg.n_layers), "memory": memory}
    if cfg.family == _MOE:
        nd = cfg.moe.n_dense_layers
        cache = {"kv": kv_pair(cfg.n_layers - nd)}
        if nd:
            cache["kv_dense"] = kv_pair(nd)
        return cache
    return {"ssm": stacked((_n_groups(cfg), cfg.hybrid.attn_every),
                           ssm_lib.zero_state(cfg, batch, dt,
                                              device="meta")),
            "kv": kv_pair(_n_groups(cfg))}


def _put(dst: torch.Tensor, src: torch.Tensor) -> None:
    """A block's new state component written IN PLACE into the cache
    tensor ``dst``.  The cache keeps the reference's dtypes, so a copy
    that would cast is a fault, and raises."""
    if src.dtype != dst.dtype or src.shape != dst.shape:
        raise TypeError(f"state component {tuple(src.shape)} {src.dtype} "
                        f"cannot be stored into {tuple(dst.shape)} "
                        f"{dst.dtype}")
    dst.copy_(src)


def _head(params: dict, x: torch.Tensor, cfg: ModelConfig,
          ctx: QuantContext) -> torch.Tensor:
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return unembed(ctx, x, head)


def _rope(positions, cfg: ModelConfig):
    """The step's rope tables: at the head dim, or MLA's rope dim."""
    width = cfg.mla.qk_rope_head_dim if cfg.mla is not None \
        else cfg.resolved_head_dim
    return rope_tables(positions, width, cfg.rope_theta, model_dtype(cfg))


def _layer_cache(cache: Optional[dict], name: str, layer: int):
    """Layer ``layer``'s slice of the cache part ``name`` (a KVCache or an
    MLACache of stacked tensors), or None without a cache."""
    if cache is None:
        return None
    part = cache[name]
    return type(part)(*(t[layer] for t in part))


def _dots_policy(ctx, op, *args, **kwargs):
    """``remat='dots'``: keep the plain 2-D products (what the
    reference's ``dots_with_no_batch_dims_saveable`` keeps), recompute
    the rest."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(block, remat):
    """``block(x) -> x`` as the forward's ``remat`` asks: as given
    (False), recomputed whole in the backward (True / 'full'), or
    recomputed but for its 2-D products ('dots'); the values do not
    change."""
    if not remat:
        return block
    from torch.utils import checkpoint as ckpt
    if remat in (True, "full"):
        return functools.partial(ckpt.checkpoint, block, use_reentrant=False)
    if remat != "dots":
        raise ValueError(f"unknown remat={remat!r}; expected False, True, "
                         "'full' or 'dots'")
    return functools.partial(
        ckpt.checkpoint, block, use_reentrant=False,
        context_fn=functools.partial(ckpt.create_selective_checkpoint_contexts,
                                     _dots_policy))


def _dense_layers(params, x, positions, cfg, ctx, cache, cache_pos,
                  remat=False):
    """The dense families' stack, and the MoE family's: its leading dense
    layers (``dense_blocks`` over ``kv_dense``), then its MoE layers."""
    rope = _rope(positions, cfg)
    stacks = (("kv_dense", tfm.dense_block, params.get("dense_blocks", ())),
              ("kv", tfm.moe_block if cfg.family == _MOE
               else tfm.dense_block, params["blocks"]))
    for name, block, blocks in stacks:
        for layer, p_l in enumerate(blocks):
            x = _remat(lambda x, p_l=p_l, layer=layer, block=block, name=name:
                       block(ctx, p_l, x, cfg, rope=rope,
                             cache=_layer_cache(cache, name, layer),
                             cache_pos=cache_pos)[0], remat)(x)
    return _head(params, x, cfg, ctx)


@functools.lru_cache(maxsize=8)
def _sinusoid(seq: int, d: int, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """The encoder's (1, seq, d) sinusoidal positions [sin | cos] of
    ``pos / 10000^(2i / d)``.  The angles are fp32, as the reference's
    (computed on the CPU, so every device starts from the same bits); sin
    and cos are evaluated in float64 from them and rounded once to fp32,
    then cast to ``dtype``, as ``common.rope_tables`` does: both devices
    agree, and the reference's XLA sin / cos differ from the table in the
    last fp32 bit now and then (ROADMAP Queue 3)."""
    with uncounted():       # a constant made once, no step's work
        pos = torch.arange(seq, dtype=torch.float32)[:, None]
        dim = torch.arange(d // 2, dtype=torch.float32)[None, :]
        ang = (pos / torch.pow(10000.0, 2 * dim / d)).to(torch.float64)
        table = torch.cat([torch.sin(ang), torch.cos(ang)], -1)
        return table.to(torch.float32).to(dtype)[None].to(device)


def _encode(params, batch: dict, cfg: ModelConfig, ctx,
            remat=False) -> torch.Tensor:
    """The whisper encoder over the stub frame embeddings
    ``batch["encoder_features"]`` (B, T, d): sinusoidal positions added in
    the model dtype, the encoder layers, then ``ln_enc``."""
    feats = batch["encoder_features"]
    dt = model_dtype(cfg)
    x = feats.to(dt) + _sinusoid(feats.shape[1], cfg.d_model, dt,
                                 feats.device)
    for p_l in params["enc_blocks"]:
        x = _remat(lambda x, p_l=p_l: tfm.encoder_block(ctx, p_l, x, cfg),
                   remat)(x)
    return rmsnorm(x, params["ln_enc"], cfg.norm_eps)


def _decoder_layers(params, x, memory, positions, cfg, ctx, cache,
                    cache_pos, remat=False):
    """whisper's decoder stack over the encoder's ``memory``."""
    rope = _rope(positions, cfg)
    for layer, p_l in enumerate(params["blocks"]):
        x = _remat(lambda x, p_l=p_l, layer=layer: tfm.decoder_block(
            ctx, p_l, x, memory, cfg, rope=rope,
            cache=_layer_cache(cache, "kv", layer),
            cache_pos=cache_pos)[0], remat)(x)
    return _head(params, x, cfg, ctx)


def _rwkv_layers(params, x, cfg, ctx, state: rwkv_lib.RWKVState,
                 decode: bool, store: bool, remat=False):
    """The RWKV6 stack over ``state`` ((L, ...) components): each layer's
    block from its state, its new state written back IN PLACE when
    ``store`` (``remat`` only without)."""
    block = tfm.rwkv_block_decode if decode else tfm.rwkv_block_fwd
    for layer, p_l in enumerate(params["blocks"]):
        st = rwkv_lib.RWKVState(*(c[layer] for c in state))
        if not store:
            x = _remat(lambda x, p_l=p_l, st=st: block(ctx, p_l, x, cfg,
                                                       st)[0], remat)(x)
            continue
        x, new = block(ctx, p_l, x, cfg, st)
        for c, n in zip(state, new):
            _put(c[layer], n)
    return _head(params, x, cfg, ctx)


def _hybrid_groups(params, x, positions, cfg, ctx, cache: Optional[dict],
                   cache_pos, decode: bool, remat=False):
    """zamba2's groups.  With ``cache`` (``init_cache``'s): each Mamba
    block from its state, its new state written back IN PLACE, the shared
    block's K/V written into the group's dense cache at ``cache_pos``.
    Without (a forward from position 0): each group from zero states over
    a fresh K/V buffer of the sequence's length (int8 codes when
    ``cfg.kv_cache_bits == 8``), the reference's fresh cache, both made
    inside the group's body and nothing written back, so that ``remat``
    recomputes the group on buffers of its own."""
    dt = model_dtype(cfg)
    rope = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta, dt)
    g = cfg.hybrid.attn_every
    x_embed = x
    for gi in range(_n_groups(cfg)):
        blocks = params["blocks"][gi * g:(gi + 1) * g]
        if cache is None:
            def body(x, blocks=blocks):
                b, s = x.shape[:2]
                kv = [torch.zeros((b, s, cfg.n_kv_heads,
                                   cfg.resolved_head_dim), device=x.device,
                                  dtype=torch.int8 if cfg.kv_cache_bits == 8
                                  else dt) for _ in range(2)]
                return tfm.hybrid_group_fwd(
                    ctx, blocks, params["shared"], x, x_embed, cfg,
                    states=[ssm_lib.zero_state(cfg, b, dt, device=x.device)
                            for _ in range(g)],
                    rope=rope, cache=att.KVCache(*kv), cache_pos=0)[0]
            x = _remat(body, remat)(x)
            continue
        st, kv = cache["ssm"], cache["kv"]
        states = [ssm_lib.SSMState(*(c[gi, j] for c in st))
                  for j in range(g)]
        x, new = tfm.hybrid_group_fwd(
            ctx, blocks, params["shared"], x, x_embed, cfg, states=states,
            rope=rope, cache=att.KVCache(kv.k[gi], kv.v[gi]),
            cache_pos=cache_pos, decode=decode)
        for old, ns in zip(states, new):
            for c, n in zip(old, ns):
                _put(c, n)
    return _head(params, x, cfg, ctx)


def forward(params: dict, batch: dict, cfg: ModelConfig, ctx: QuantContext,
            *, remat: Union[bool, str] = False,
            cache: Optional[dict] = None) -> tuple[torch.Tensor, Any]:
    """Full-sequence forward of ``batch["tokens"]`` (B, S) from position 0
    (the audio family first encodes ``batch["encoder_features"]``).
    With ``cache`` (prefill, ``init_cache``'s), every layer's K/V are
    written into it at position 0, the audio family's encoder output into
    its ``memory``, and the recurrent families' states after the sequence
    replace its states, all in place; the recurrent blocks start from the
    cache's states.  Without it the recurrent
    blocks start from zero states and the hybrid's shared block runs over
    a fresh cache of S positions (int8 codes when ``cfg.kv_cache_bits ==
    8``), as the reference's forward does.  Returns (logits (B, S, V) in
    the activation dtype, cache).  ``params`` may be a
    ``QuantizedParams.tree`` when ``ctx`` is the matching INT-mode
    context.

    ``remat`` (training, without a cache) sets what each block (the
    hybrid's: each group) keeps for the backward, as the reference's:
    everything (False), nothing, the block recomputed (True / 'full'), or
    its 2-D products ('dots'); no value changes.

    Under a tensor-parallel scope (``distributed.sharding.
    activation_sharding``) ``params`` and ``cache`` are one rank's slices (the recurrent
    states and whisper's memory whole, ``distributed.sharding.
    cache_sharding_rules``) and the blocks run on the rank's view of
    ``cfg``; the logits are every rank's, whole."""
    _check_family(cfg, "forward")
    cfg = _rank_view(cfg)
    if remat and cache is not None:
        raise NotImplementedError(
            "remat applies to a forward without a cache")
    tokens = batch["tokens"]
    b, s = tokens.shape
    dev = tokens.device
    x = embed(params["embed"], tokens, model_dtype(cfg))
    positions = torch.arange(s, device=dev).expand(b, s)
    if cfg.family in _DENSE + (_MOE,):
        logits = _dense_layers(params, x, positions, cfg, ctx, cache, 0,
                               remat)
    elif cfg.family == _AUDIO:
        memory = _encode(params, batch, cfg, ctx, remat)
        if cache is not None:
            _put(cache["memory"], memory)
            memory = cache["memory"]
        logits = _decoder_layers(params, x, memory, positions, cfg, ctx,
                                 cache, 0, remat)
    elif cfg.family == "ssm":
        state = cache["state"] if cache is not None else init_cache(
            cfg, b, s, device=dev)["state"]
        logits = _rwkv_layers(params, x, cfg, ctx, state, decode=False,
                              store=cache is not None, remat=remat)
    else:
        logits = _hybrid_groups(params, x, positions, cfg, ctx, cache, 0,
                                decode=False, remat=remat)
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


def loss_fn(params: dict, batch: dict, cfg: ModelConfig, ctx: QuantContext,
            *, remat: Union[bool, str] = "full"
            ) -> tuple[torch.Tensor, dict]:
    """Next-token cross entropy (fp32 logsumexp over the activation-dtype
    logits, the max held out of the gradient) of ``batch["labels"]``
    under ``batch["mask"]`` (when given), plus the ``1e-4 * mean(lse^2)``
    z-loss.  Returns (loss + z_loss, {"nll", "z_loss", "ppl_proxy"}).

    The gold logit is picked by ``gather``, where the reference sums
    ``logits * one_hot`` in fp32 (a vocab-dim gather re-shards the logits
    under GSPMD): the sum has one nonzero term, so value and gradient are
    the same, without a (B, S, V) one-hot.

    Under a scope whose data axis cuts the batch (training on a mesh,
    ``activation_sharding(mesh, batch_split=True, train=True)``) ``batch``
    is this rank's block of rows and the loss is the global one, as the
    reference's over its data-cut batch: the masked sum and the mask
    count (the z-loss's sum and count) summed over the data axis, then
    divided (``distributed.collectives.sum_over_data``), the same value
    on every rank."""
    logits, _ = forward(params, batch, cfg, ctx, remat=remat)
    logits = logits[:, :-1]
    targets = batch["labels"][:, 1:].long()
    m = logits.detach().amax(dim=-1, keepdim=True)
    sumexp = torch.exp(logits - m).sum(-1, dtype=torch.float32)
    lse = torch.log(sumexp) + m[..., 0].float()
    gold = logits.gather(-1, targets[..., None])[..., 0].float()
    nll = lse - gold
    mask = batch.get("mask")
    mesh = shd.current_mesh() if shd.batch_shards() > 1 else None
    if mesh is None:
        if mask is not None:
            mask = mask[:, 1:].to(nll.dtype)
            loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        else:
            loss = nll.mean()
        z_loss = 1e-4 * (lse * lse).mean()
    else:
        count = torch.tensor(float(nll.numel()), device=nll.device)
        mask = (torch.ones_like(nll) if mask is None
                else mask[:, 1:].to(nll.dtype))
        loss = sum_over_data((nll * mask).sum(), mesh) / torch.clamp(
            sum_over_data(mask.sum(), mesh), min=1.0)
        z_loss = 1e-4 * (sum_over_data((lse * lse).sum(), mesh)
                         / sum_over_data(count, mesh))
    metrics = {"nll": loss, "z_loss": z_loss,
               "ppl_proxy": torch.exp(torch.clamp(loss, max=20.0))}
    return loss + z_loss, metrics


def decode_step(params: dict, tokens: torch.Tensor, cache: dict, pos,
                cfg: ModelConfig, ctx: QuantContext
                ) -> tuple[torch.Tensor, dict]:
    """One serving step: tokens (B, 1) at absolute position ``pos``, the
    cache from :func:`prefill`: the K/V written at ``pos`` and the
    recurrent states replaced, all in place.  ``pos`` is a host int
    (checked against the KV cache here) or a 0-d integer tensor on the
    step's device, which nothing reads back to the host: the step's
    launches do not depend on it, so one CUDA graph of the step serves
    every position (``launch.steps.StepGraphs``).  RWKV6 keeps no KV and
    ignores it.  The audio family reads the encoder's memory from the
    cache and recomputes the cross-attention's K/V from it every step, as
    the reference does.  Returns (logits (B, V), cache), the cache the same
    tensors as given (a captured step's static memory is the cache
    prefill allocated)."""
    _check_family(cfg, "decode_step")
    cfg = _rank_view(cfg)
    b = tokens.shape[0]
    dev = tokens.device
    x = embed(params["embed"], tokens, model_dtype(cfg))
    if cfg.family == "ssm":
        logits = _rwkv_layers(params, x, cfg, ctx, cache["state"],
                              decode=True, store=True)
        return logits[:, 0], cache
    if not isinstance(pos, torch.Tensor):
        s_max = cache["kv"][0].shape[2]
        if not 0 <= int(pos) < s_max:
            raise ValueError(f"pos {pos} outside the cache [0, {s_max})")
        pos = torch.tensor(int(pos), dtype=torch.int32, device=dev)
    pos = pos.to(device=dev, dtype=torch.int32).reshape(())
    positions = pos.expand(b, 1)
    if cfg.family in _DENSE + (_MOE,):
        logits = _dense_layers(params, x, positions, cfg, ctx, cache, pos)
    elif cfg.family == _AUDIO:
        logits = _decoder_layers(params, x, cache["memory"], positions, cfg,
                                 ctx, cache, pos)
    else:
        logits = _hybrid_groups(params, x, positions, cfg, ctx, cache, pos,
                                decode=True)
    return logits[:, 0], cache


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int, *,
                     device: Device = None, mesh=None) -> dict:
    """KV BLOCK POOL for the serving engine: one (L, NB, BS, KVH, D) arena
    shared by every in-flight request (int8 Eq.-1 codes when
    ``cfg.kv_cache_bits == 8``).  Block 0 is the trash block, so
    ``num_blocks`` must be >= 2.  On a tensor-parallel mesh (``mesh``,
    default the scope's) it holds this rank's KV heads, (L, NB, BS,
    KVH / M, D): a sequence's blocks sit at the same indices in every
    rank's pool, so the block tables are every rank's."""
    _check_family(cfg, "paged serving", _DENSE)
    cfg = _rank_view(cfg, mesh)
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
    _check_family(cfg, "ragged_step", _DENSE)
    cfg = _rank_view(cfg)
    dt = model_dtype(cfg)
    x = embed(params["embed"], tokens, dt)
    # positions are the same in every layer: one rope table per step
    rope = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta, dt)
    kv = cache["paged_kv"]
    for layer, p_l in enumerate(params["blocks"]):
        x, _ = tfm.dense_block(
            ctx, p_l, x, cfg, rope=rope,
            cache=att.PagedKVCache(kv.k[layer], kv.v[layer]), ragged=ragged)
    return _head(params, x, cfg, ctx), cache


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
    _check_family(cfg, "paged_step", _DENSE)
    cfg = _rank_view(cfg)
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
    return _head(params, x, cfg, ctx), cache


# ---------------------------------------------------------------------------
# the fixed-slab recurrent substrate
# ---------------------------------------------------------------------------

def init_paged_state(cfg: ModelConfig, num_slabs: int, *,
                     num_blocks: Optional[int] = None,
                     block_size: Optional[int] = None,
                     device: Device = None, mesh=None) -> dict:
    """STATE SLAB arenas of the fixed-slab recurrent substrate: one
    (L, S, ...) arena per state component, S = ``num_slabs``, which the
    host-side ``serving.state_pool.StateSlabPool`` hands out one slab per
    live sequence.  Slab 0 is the trash slab idle lanes read and write
    (their q_len is 0, so the step passes it through bit for bit), so
    ``num_slabs`` >= 2.

    With ``cfg.state_bits == 8`` the slabs hold Eq.-1 int8 codes on a
    per-slab power-of-two grid (``exp``, (S,) int32); ``None`` keeps fp32
    slabs.  RWKV6 (``ssm``): ``state`` = {x_att, x_ffn (L, S, d), wkv (L,
    S, H, 64, 64)}.  Hybrid: ``ssm``, an ``SSMState`` of (G, g, S, ...)
    arenas (G groups of g Mamba blocks), and the shared attention block's
    KV pool ``paged_kv`` (G, NB, bs, KVH, D), sized by ``num_blocks`` /
    ``block_size`` as :func:`init_paged_cache` (int8 codes when
    ``cfg.kv_cache_bits == 8``).  On a tensor-parallel mesh (``mesh``,
    default the scope's) the slabs are whole (every rank runs the scans
    on the whole state) and the pool holds this rank's KV heads."""
    _check_family(cfg, "init_paged_state", _RECURRENT)
    cfg = _rank_view(cfg, mesh)
    if num_slabs < 2:
        raise ValueError("state pool needs >= 2 slabs (slab 0 is the trash "
                         "slab idle lanes read and write)")
    dev = resolve_device(device)
    st_dt = torch.int8 if cfg.state_bits == 8 else torch.float32
    exp = torch.full((num_slabs,),
                     cfg.state_frac_bits if cfg.state_bits == 8 else 0,
                     dtype=torch.int32, device=dev)

    def zeros(*shape, dtype=st_dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    if cfg.family == "ssm":
        h, hd = cfg.d_model // rwkv_lib.HEAD_DIM, rwkv_lib.HEAD_DIM
        ls = (cfg.n_layers, num_slabs)
        return {"state": {"x_att": zeros(*ls, cfg.d_model),
                          "x_ffn": zeros(*ls, cfg.d_model),
                          "wkv": zeros(*ls, h, hd, hd)},
                "exp": exp}
    if num_blocks is None or block_size is None:
        raise ValueError("hybrid slabs need num_blocks/block_size for the "
                         "shared attention block's KV pool")
    if num_blocks < 2:
        raise ValueError("pool needs >= 2 blocks (block 0 is the trash "
                         "block inactive slots write to)")
    g, n_groups = cfg.hybrid.attn_every, _n_groups(cfg)
    st = ssm_lib.zero_state(cfg, num_slabs)
    kv_dt = torch.int8 if cfg.kv_cache_bits == 8 else model_dtype(cfg)
    kv_shape = (n_groups, num_blocks, block_size, cfg.n_kv_heads,
                cfg.resolved_head_dim)
    return {"ssm": ssm_lib.SSMState(
                conv=zeros(n_groups, g, *st.conv.shape),
                ssm=zeros(n_groups, g, *st.ssm.shape)),
            "exp": exp,
            "paged_kv": att.PagedKVCache(k=zeros(*kv_shape, dtype=kv_dt),
                                         v=zeros(*kv_shape, dtype=kv_dt))}


def _pow2(n: torch.Tensor) -> torch.Tensor:
    """2^n for an integer tensor, exact, as fp32."""
    return torch.pow(2.0, n.to(torch.float64)).to(torch.float32)


def _slab_load(codes: torch.Tensor, n: Optional[torch.Tensor],
               dtype: torch.dtype) -> torch.Tensor:
    """Gathered slabs in the compute ``dtype``: int8 codes dequantized on
    their slabs' grids ``n`` (broadcast over the slab axis), fp32 slabs
    cast."""
    if n is None:
        return codes.to(dtype)
    return (codes.to(torch.float32) * _pow2(-n)).to(dtype)


def _slab_store(new: torch.Tensor, n: Optional[torch.Tensor],
                dtype: torch.dtype) -> torch.Tensor:
    """New state as slab contents: Eq.-1 int8 codes on the grids ``n``
    (``clip(round(x * 2^n))``), or cast to the fp32 slab."""
    if n is None:
        return new.to(dtype)
    scaled = new.to(torch.float32) * _pow2(n)
    return torch.clamp(round_half_away(scaled), -128, 127).to(torch.int8)


def paged_recurrent_step(params: dict, tokens: torch.Tensor, cache: dict,
                         slab_ids: torch.Tensor, q_len: torch.Tensor,
                         positions: Optional[torch.Tensor],
                         block_tables: Optional[torch.Tensor],
                         cfg: ModelConfig, ctx: QuantContext, work=None
                         ) -> tuple[torch.Tensor, dict]:
    """One serving step on the fixed-slab recurrent substrate.

    ``tokens`` (B, C) right-padded; ``q_len`` (B,) real tokens a row
    (a prefill chunk's c_real <= C, a decode row 1, an idle lane 0 on the
    trash slab); ``slab_ids`` (B,) each row's slab.  The gathered state is
    dequantized ONCE on its per-slab po2 grid (``cache['exp']``), the
    masked forward advances every row by its own q_len in one fixed
    shape, and the new state is requantized ONCE and scattered back IN
    PLACE (``index_copy_``, where the JAX engine donates the state).  So
    the requant count a token is independent of context length.  Idle
    lanes pass their slab through bit for bit, which keeps several lanes'
    writes to the trash slab deterministic (they carry identical values).

    For the hybrid family, per-token ``positions`` (B, C) (invalid entries
    pointed past the last real block) and ``block_tables`` (B, NBmax + 1,
    the last column the trash block) drive the shared attention block's
    KV pool as :func:`paged_step`'s do, on K4's ``work`` list for these
    positions (planned once a step, shared by every group) where given;
    the pure recurrent family ignores all three.  Returns (logits (B, V)
    in the activation dtype at each row's last real token, cache).

    Under a tensor-parallel scope ``params`` and the pool are one rank's
    slices (``init_paged_state(mesh=)``), the slabs whole; every rank
    advances the same rows and its logits are whole."""
    _check_family(cfg, "paged_recurrent_step", _RECURRENT)
    cfg = _rank_view(cfg)
    b, c = tokens.shape
    dt = model_dtype(cfg)
    dev = tokens.device
    x = embed(params["embed"], tokens, dt)
    valid = torch.arange(c, device=dev)[None, :] < q_len[:, None]
    ids = slab_ids.long()
    exps = cache["exp"].index_select(0, ids) if cfg.state_bits == 8 \
        else None

    def grid(lead: int, ndim: int):
        # the rows' exponents broadcast over (lead axes, B, state dims)
        if exps is None:
            return None
        return exps.reshape((1,) * lead + (b,) + (1,) * (ndim - lead - 1))

    if cfg.family == "ssm":
        st = cache["state"]
        gathered = {k: v.index_select(1, ids) for k, v in st.items()}
        loaded = {k: _slab_load(v, grid(1, v.ndim),
                                torch.float32 if k == "wkv" else dt)
                  for k, v in gathered.items()}
        new = {"x_att": [], "x_ffn": [], "wkv": []}
        for layer, p_l in enumerate(params["blocks"]):
            state = rwkv_lib.RWKVState(
                x_prev_att=loaded["x_att"][layer][:, None],
                x_prev_ffn=loaded["x_ffn"][layer][:, None],
                wkv=loaded["wkv"][layer])
            x, ns = tfm.rwkv_block_paged(ctx, p_l, x, cfg, state, valid)
            new["x_att"].append(ns.x_prev_att[:, 0])
            new["x_ffn"].append(ns.x_prev_ffn[:, 0])
            new["wkv"].append(ns.wkv)
        for k, arr in st.items():
            stacked = torch.stack(new[k])                   # (L, B, ...)
            arr.index_copy_(1, ids, _slab_store(
                stacked, grid(1, stacked.ndim), arr.dtype))
    else:
        st = cache["ssm"]
        g = cfg.hybrid.attn_every
        conv = _slab_load(st.conv.index_select(2, ids),
                          grid(2, st.conv.ndim), dt)
        ssm = _slab_load(st.ssm.index_select(2, ids),
                         grid(2, st.ssm.ndim), torch.float32)
        rope = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta,
                           dt)
        kv = cache["paged_kv"]
        x_embed = x
        new_conv, new_ssm = [], []
        for gi in range(_n_groups(cfg)):
            x, ns = tfm.hybrid_group_paged(
                ctx, params["blocks"][gi * g:(gi + 1) * g], params["shared"],
                x, x_embed, cfg,
                states=[ssm_lib.SSMState(conv[gi, j], ssm[gi, j])
                        for j in range(g)],
                rope=rope, cache=att.PagedKVCache(kv.k[gi], kv.v[gi]),
                positions=positions, block_tables=block_tables,
                valid=valid, paged_work=work)
            new_conv.append(torch.stack([s_.conv for s_ in ns]))
            new_ssm.append(torch.stack([s_.ssm for s_ in ns]))
        for arr, new in ((st.conv, torch.stack(new_conv)),
                         (st.ssm, torch.stack(new_ssm))):
            arr.index_copy_(2, ids, _slab_store(new, grid(2, new.ndim),
                                                arr.dtype))

    last = torch.clamp(q_len.long() - 1, min=0)
    xe = x[torch.arange(b, device=dev), last][:, None, :]   # (B, 1, d)
    return _head(params, xe, cfg, ctx)[:, 0], cache


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
    if isinstance(node, tuple):             # adafactor's (row, col)
        return tuple(fn(a) for a in node)
    return fn(node)


def from_jax_params(np_tree: dict, cfg: ModelConfig, *,
                    device: Device = None) -> dict:
    """The JAX param tree (as numpy arrays: ``jax.tree.map(np.asarray,
    params)``, or a ``QuantizedParams.tree``) as the port's params.

    Scanned ``(L, ...)`` block leaves (``blocks``, the MoE family's
    ``dense_blocks`` and the audio family's ``enc_blocks``) are unstacked
    into one dict per layer (the hybrid's
    ``blocks/mamba`` (G, g, ...) leaves into one dict per Mamba block,
    group-major); dtypes are kept (bf16 stays bf16, int8 codes stay int8).
    Nothing here imports JAX."""
    _check_family(cfg, "from_jax_params")
    dev = resolve_device(device)
    stacked = {"dense_blocks": cfg.moe.n_dense_layers if cfg.moe else 0,
               "enc_blocks": cfg.encdec.n_encoder_layers if cfg.encdec
               else 0}
    out = {k: _tree(v, lambda a: _to_tensor(a, dev))
           for k, v in np_tree.items() if k not in ("blocks", *stacked)}
    for key, n in stacked.items():
        if key in np_tree:
            out[key] = [_tree(np_tree[key],
                              lambda a, i=i: _to_tensor(a[i], dev))
                        for i in range(n)]
    blocks = np_tree["blocks"]
    if cfg.family == "hybrid":
        g = cfg.hybrid.attn_every
        out["blocks"] = [
            _tree(blocks["mamba"],
                  lambda a, i=i: _to_tensor(a[i // g][i % g], dev))
            for i in range(_n_groups(cfg) * g)]
    else:
        n = cfg.n_layers - (cfg.moe.n_dense_layers if cfg.moe else 0)
        out["blocks"] = [_tree(blocks, lambda a, i=i: _to_tensor(a[i], dev))
                         for i in range(n)]
    return out


def from_jax_opt_state(np_state, cfg: ModelConfig, *,
                       device: Device = None):
    """The JAX package's ``OptState`` (as numpy: ``jax.tree.map(
    np.asarray, state)``) as the port's ``optim.OptState``: the step a
    0-d int32 tensor, ``m`` and ``v`` laid out as :func:`from_jax_params`
    lays out the params (adafactor's factored ``(row, col)`` second
    moments split per layer alike; its ``m`` stays None)."""
    from repro_torch.optim.optimizers import OptState
    dev = resolve_device(device)

    def moments(tree):
        return None if tree is None else from_jax_params(tree, cfg,
                                                         device=dev)
    return OptState(step=torch.tensor(int(np.asarray(np_state.step)),
                                      dtype=torch.int32, device=dev),
                    m=moments(np_state.m), v=moments(np_state.v))
