"""Block assembly (PyTorch counterpart of ``repro.models.transformer``):
the dense family's pre-norm GQA + SwiGLU block, the MoE family's block
(attention, GQA or DeepSeek's MLA, then the routed experts; MLA configs
send the dense block's attention to MLA too), whisper's encoder block
(non-causal attention, gelu MLP) and decoder block (causal
self-attention, cross-attention over the encoder's memory, gelu MLP),
the RWKV6 block, and
zamba2's hybrid group (``attn_every`` Mamba2 blocks, then the one shared
attention block on concat(h, embedding)), the last two in the classic
forms (a full sequence over a carried state and a dense KV cache, and
the O(1) decode step) and in the batched paged form of the serving
engine.  Blocks are plain functions over one layer's dict of tensors;
the model loops over layers where the JAX package scans stacked
parameters."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.qmodel import QuantContext
from repro_torch.models import attention as att
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import Initializer, linear, rmsnorm

__all__ = ["init_dense_block", "dense_block", "init_moe_block",
           "moe_block", "init_encoder_block", "encoder_block",
           "init_decoder_block", "decoder_block", "init_rwkv_block",
           "rwkv_block_fwd", "rwkv_block_decode", "rwkv_block_paged",
           "init_mamba_block", "init_shared_attn", "hybrid_group_fwd",
           "hybrid_group_paged"]


def _init_attn(init: Initializer, cfg: ModelConfig) -> dict:
    return att.init_mla(init, cfg) if cfg.mla is not None \
        else att.init_gqa(init, cfg)


def init_dense_block(init: Initializer, cfg: ModelConfig) -> dict:
    return {
        "ln1": init.ones((cfg.d_model,)),
        "ln2": init.ones((cfg.d_model,)),
        "mlp": mlp_lib.init_mlp(init, cfg.d_model, cfg.d_ff, cfg.act),
        "attn": _init_attn(init, cfg),
    }


def _attn_dispatch(ctx: QuantContext, p: dict, x: torch.Tensor,
                   cfg: ModelConfig, *, rope, cache, cache_pos, ragged,
                   block_tables, paged_work):
    """The block's attention: MLA for MLA configs (the classic dense-cache
    paths only, as in the reference), else GQA."""
    if cfg.mla is not None:
        if ragged is not None or block_tables is not None:
            raise NotImplementedError(
                "paged serving covers GQA caches only; MLA's compressed "
                "latent cache has no block-pool layout (as in the "
                "reference)")
        return att.mla_attention(ctx, p["attn"], x, cfg, rope=rope,
                                 cache=cache, cache_pos=cache_pos)
    return att.gqa_attention(ctx, p["attn"], x, cfg, rope=rope, cache=cache,
                             cache_pos=cache_pos, ragged=ragged,
                             block_tables=block_tables,
                             paged_work=paged_work)


def dense_block(ctx: QuantContext, p: dict, x: torch.Tensor,
                cfg: ModelConfig, *, rope: tuple[torch.Tensor, torch.Tensor],
                cache=None, cache_pos=None, ragged=None, block_tables=None,
                paged_work=None):
    """One layer: x is the ragged stream (T, d) with ``ragged`` and the
    pool as ``cache``; a (B, S, d) batch over the pool with
    ``block_tables``, per-token positions ``cache_pos`` and K4's
    ``paged_work``; or a (B, S, d)
    batch with an optional dense ``cache`` written at ``cache_pos``
    (``attention.gqa_attention``).
    ``rope`` is the step's (cos, sin) tables.  All quantization lives
    inside the qlinear modules; residual adds and rmsnorms run in float
    between module grids."""
    h, new_cache = _attn_dispatch(
        ctx, p, rmsnorm(x, p["ln1"], cfg.norm_eps), cfg, rope=rope,
        cache=cache, cache_pos=cache_pos, ragged=ragged,
        block_tables=block_tables, paged_work=paged_work)
    x = x + h
    x = x + mlp_lib.mlp(ctx, p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps),
                        cfg.act)
    return x, new_cache


def init_moe_block(init: Initializer, cfg: ModelConfig) -> dict:
    return {
        "ln1": init.ones((cfg.d_model,)),
        "ln2": init.ones((cfg.d_model,)),
        "moe": mlp_lib.init_moe(init, cfg),
        "attn": _init_attn(init, cfg),
    }


def moe_block(ctx: QuantContext, p: dict, x: torch.Tensor, cfg: ModelConfig,
              *, rope: tuple[torch.Tensor, torch.Tensor], cache=None,
              cache_pos=None):
    """One MoE layer of the classic path: attention (GQA or MLA) over an
    optional dense cache written at ``cache_pos``, then the routed experts
    (``mlp.moe``) on x (B, S, d)."""
    h, new_cache = _attn_dispatch(
        ctx, p, rmsnorm(x, p["ln1"], cfg.norm_eps), cfg, rope=rope,
        cache=cache, cache_pos=cache_pos, ragged=None, block_tables=None,
        paged_work=None)
    x = x + h
    x = x + mlp_lib.moe(ctx, p["moe"], rmsnorm(x, p["ln2"], cfg.norm_eps),
                        cfg)
    return x, new_cache


# ---------------------------------------------------------------------------
# whisper's encoder and decoder blocks (no rope in the encoder and the
# cross-attention: the encoder's sinusoidal positions are added at embed
# time; the decoder's self-attention takes rope in lieu of whisper's
# learned positions, as in the reference)
# ---------------------------------------------------------------------------

def init_encoder_block(init: Initializer, cfg: ModelConfig) -> dict:
    return {
        "ln1": init.ones((cfg.d_model,)),
        "ln2": init.ones((cfg.d_model,)),
        "attn": att.init_gqa(init, cfg),
        "mlp": mlp_lib.init_mlp(init, cfg.d_model, cfg.d_ff, "gelu"),
    }


def encoder_block(ctx: QuantContext, p: dict, x: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """One encoder layer over the frames x (B, T, d): non-causal
    self-attention without rope, then the gelu MLP."""
    h, _ = att.gqa_attention(ctx, p["attn"],
                             rmsnorm(x, p["ln1"], cfg.norm_eps), cfg,
                             rope=None, causal=False)
    x = x + h
    return x + mlp_lib.mlp(ctx, p["mlp"],
                           rmsnorm(x, p["ln2"], cfg.norm_eps), "gelu")


def init_decoder_block(init: Initializer, cfg: ModelConfig) -> dict:
    return {
        "ln1": init.ones((cfg.d_model,)),
        "ln_cross": init.ones((cfg.d_model,)),
        "ln2": init.ones((cfg.d_model,)),
        "attn": att.init_gqa(init, cfg),
        "cross": att.init_gqa(init, cfg),
        "mlp": mlp_lib.init_mlp(init, cfg.d_model, cfg.d_ff, "gelu"),
    }


def decoder_block(ctx: QuantContext, p: dict, x: torch.Tensor,
                  memory: torch.Tensor, cfg: ModelConfig, *,
                  rope: tuple[torch.Tensor, torch.Tensor], cache=None,
                  cache_pos=None):
    """One decoder layer on x (B, S, d): causal self-attention with rope
    over an optional dense cache written at ``cache_pos``, then
    cross-attention (module ``cross``) over the encoder's ``memory``
    (B, T, d) with no rope and no cache (a decode step recomputes the
    memory's K / V, as the reference does), then the gelu MLP; each
    behind its rmsnorm (``ln1``, ``ln_cross``, ``ln2``)."""
    h, new_cache = att.gqa_attention(
        ctx, p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps), cfg, rope=rope,
        cache=cache, cache_pos=cache_pos)
    x = x + h
    h, _ = att.gqa_attention(
        ctx, p["cross"], rmsnorm(x, p["ln_cross"], cfg.norm_eps), cfg,
        rope=None, kv_x=memory, name="cross")
    x = x + h
    x = x + mlp_lib.mlp(ctx, p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps),
                        "gelu")
    return x, new_cache


# ---------------------------------------------------------------------------
# rwkv6 block
# ---------------------------------------------------------------------------

def init_rwkv_block(init: Initializer, cfg: ModelConfig) -> dict:
    return {
        "ln1": init.ones((cfg.d_model,)),
        "ln2": init.ones((cfg.d_model,)),
        "rwkv": rwkv_lib.init_rwkv6(init, cfg),
    }


def rwkv_block_fwd(ctx: QuantContext, p: dict, x: torch.Tensor,
                   cfg: ModelConfig, state: rwkv_lib.RWKVState):
    """One layer over a full sequence x (B, S, d) after ``state``.  The new
    state carries the NORMED inputs of the last position (``att_in``,
    ``ffn_in``), as the reference's, and the wkv."""
    att_in = rmsnorm(x, p["ln1"], cfg.norm_eps)
    att_out, _, st = rwkv_lib.rwkv6_block(ctx, p["rwkv"], att_in, cfg,
                                          state=state)
    x = x + att_out
    ffn_in = rmsnorm(x, p["ln2"], cfg.norm_eps)
    x = x + rwkv_lib.rwkv6_channel_mix(ctx, p["rwkv"], ffn_in, cfg,
                                       x_prev=state.x_prev_ffn)
    return x, rwkv_lib.RWKVState(x_prev_att=att_in[:, -1:],
                                 x_prev_ffn=ffn_in[:, -1:], wkv=st.wkv)


def rwkv_block_decode(ctx: QuantContext, p: dict, x: torch.Tensor,
                      cfg: ModelConfig, state: rwkv_lib.RWKVState):
    """One layer's decode step, x (B, 1, d), through the O(1) time-mix
    recurrence."""
    att_in = rmsnorm(x, p["ln1"], cfg.norm_eps)
    att_out, st = rwkv_lib.rwkv6_decode(ctx, p["rwkv"], att_in, cfg, state)
    x = x + att_out
    ffn_in = rmsnorm(x, p["ln2"], cfg.norm_eps)
    x = x + rwkv_lib.rwkv6_channel_mix(ctx, p["rwkv"], ffn_in, cfg,
                                       x_prev=state.x_prev_ffn)
    return x, rwkv_lib.RWKVState(x_prev_att=att_in, x_prev_ffn=ffn_in,
                                 wkv=st.wkv)


def rwkv_block_paged(ctx: QuantContext, p: dict, x: torch.Tensor,
                     cfg: ModelConfig, state: rwkv_lib.RWKVState,
                     valid: torch.Tensor):
    """Right-padded batched RWKV block of the serving engine.

    Every row advances by its own ``q_len = sum(valid)`` tokens in one
    fixed-shape call: invalid positions are inert inside the chunked WKV,
    and the token-shift streams are taken per row at the last VALID
    position.  Rows with ``q_len == 0`` (empty slots, trash-slab lanes)
    carry their state through bit for bit."""
    b = x.shape[0]
    att_in = rmsnorm(x, p["ln1"], cfg.norm_eps)
    att_out, _, st = rwkv_lib.rwkv6_block(ctx, p["rwkv"], att_in, cfg,
                                          state=state, valid=valid)
    x = x + att_out
    ffn_in = rmsnorm(x, p["ln2"], cfg.norm_eps)
    x = x + rwkv_lib.rwkv6_channel_mix(ctx, p["rwkv"], ffn_in, cfg,
                                       x_prev=state.x_prev_ffn)
    q_len = valid.to(torch.int64).sum(dim=1)
    last = torch.clamp(q_len - 1, min=0)
    rows = torch.arange(b, device=x.device)
    keep = (q_len > 0)[:, None, None]
    new_state = rwkv_lib.RWKVState(
        x_prev_att=torch.where(keep, att_in[rows, last][:, None],
                               state.x_prev_att.to(att_in.dtype)),
        x_prev_ffn=torch.where(keep, ffn_in[rows, last][:, None],
                               state.x_prev_ffn.to(ffn_in.dtype)),
        wkv=st.wkv)
    return x, new_state


# ---------------------------------------------------------------------------
# zamba2 hybrid group: ``attn_every`` mamba blocks + the shared GQA block
# ---------------------------------------------------------------------------

def init_mamba_block(init: Initializer, cfg: ModelConfig) -> dict:
    return {"ln": init.ones((cfg.d_model,)),
            "ssm": ssm_lib.init_mamba2(init, cfg)}


def init_shared_attn(init: Initializer, cfg: ModelConfig) -> dict:
    """The ONE shared transformer block (zamba2): sees concat(h, embed)."""
    d = cfg.d_model
    return {
        "in_proj": init.dense((2 * d, d), fan_in=2 * d),
        "ln1": init.ones((d,)),
        "ln2": init.ones((d,)),
        "attn": att.init_gqa(init, cfg),
        "mlp": mlp_lib.init_mlp(init, d, cfg.d_ff, cfg.act),
    }


def _shared_block(ctx: QuantContext, shared_p: dict, x: torch.Tensor,
                  x_embed: torch.Tensor, cfg: ModelConfig, *,
                  rope: tuple[torch.Tensor, torch.Tensor], **attn_kw
                  ) -> torch.Tensor:
    """The shared attention block on concat(h, embedding) (zamba2's
    dataflow), its cache and positions in ``attn_kw``
    (``attention.gqa_attention``'s); returns ``x + z``."""
    # column-cut on a mesh: z is read whole (its norm, the residual)
    z = linear(ctx, "shared/in_proj", torch.cat([x, x_embed], dim=-1),
               shared_p["in_proj"], gather=True)
    h, _ = att.gqa_attention(
        ctx, shared_p["attn"], rmsnorm(z, shared_p["ln1"], cfg.norm_eps),
        cfg, rope=rope, name="shared/attn", **attn_kw)
    z = z + h
    z = z + mlp_lib.mlp(ctx, shared_p["mlp"],
                        rmsnorm(z, shared_p["ln2"], cfg.norm_eps), cfg.act,
                        name="shared/mlp")
    return x + z


def hybrid_group_fwd(ctx: QuantContext, group_p: list, shared_p: dict,
                     x: torch.Tensor, x_embed: torch.Tensor,
                     cfg: ModelConfig, *, states: list,
                     rope: tuple[torch.Tensor, torch.Tensor],
                     cache: att.KVCache, cache_pos, decode: bool = False):
    """One group of the classic path: the group's Mamba blocks
    (``group_p``, one dict each, over their ``states``; with ``decode``
    the O(1) step on x (B, 1, d)), then the shared attention block over
    the group's dense ``cache``, its K/V written IN PLACE at
    ``cache_pos`` (0 for a prefill; a decode step's position, a host int
    or a 0-d tensor read on the device).  Returns (x, the Mamba blocks'
    new states)."""
    new_states = []
    for p_l, st_l in zip(group_p, states):
        h_in = rmsnorm(x, p_l["ln"], cfg.norm_eps)
        if decode:
            h, st = ssm_lib.mamba2_decode(ctx, p_l["ssm"], h_in, cfg, st_l)
        else:
            h, st = ssm_lib.mamba2(ctx, p_l["ssm"], h_in, cfg,
                                   init_state=st_l)
        x = x + h
        new_states.append(st)
    return _shared_block(ctx, shared_p, x, x_embed, cfg, rope=rope,
                         cache=cache, cache_pos=cache_pos), new_states


def hybrid_group_paged(ctx: QuantContext, group_p: list, shared_p: dict,
                       x: torch.Tensor, x_embed: torch.Tensor,
                       cfg: ModelConfig, *, states: list,
                       rope: tuple[torch.Tensor, torch.Tensor],
                       cache: att.PagedKVCache, positions: torch.Tensor,
                       block_tables: torch.Tensor, valid: torch.Tensor,
                       paged_work=None):
    """One group of the serving engine's batched step: the group's Mamba
    blocks (``group_p``, one dict each, with their ``states``) with
    ``valid`` (B, S) threaded in, then the shared attention block over
    the group's KV pool ``cache``, each token's codes written IN PLACE at
    its per-token ``positions`` through ``block_tables`` (K4 over
    ``paged_work``).  Returns (x, the Mamba blocks' new states)."""
    new_states = []
    for p_l, st_l in zip(group_p, states):
        h, st = ssm_lib.mamba2(ctx, p_l["ssm"],
                               rmsnorm(x, p_l["ln"], cfg.norm_eps), cfg,
                               init_state=st_l, valid=valid)
        x = x + h
        new_states.append(st)
    return _shared_block(ctx, shared_p, x, x_embed, cfg, rope=rope,
                         cache=cache, cache_pos=positions,
                         block_tables=block_tables,
                         paged_work=paged_work), new_states
