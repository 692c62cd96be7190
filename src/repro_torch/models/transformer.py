"""Block assembly (PyTorch counterpart of ``repro.models.transformer`` for
the dense family): pre-norm GQA + SwiGLU.  Blocks are plain functions
over one layer's dict of tensors; the model loops over layers where the
JAX package scans stacked parameters."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.qmodel import QuantContext
from repro_torch.models import attention as att
from repro_torch.models import mlp as mlp_lib
from repro_torch.models.common import Initializer, rmsnorm

__all__ = ["init_dense_block", "dense_block"]


def init_dense_block(init: Initializer, cfg: ModelConfig) -> dict:
    return {
        "ln1": init.ones((cfg.d_model,)),
        "ln2": init.ones((cfg.d_model,)),
        "mlp": mlp_lib.init_mlp(init, cfg.d_model, cfg.d_ff, cfg.act),
        "attn": att.init_gqa(init, cfg),
    }


def dense_block(ctx: QuantContext, p: dict, x: torch.Tensor,
                cfg: ModelConfig, *, rope: tuple[torch.Tensor, torch.Tensor],
                cache: att.PagedKVCache, ragged: att.RaggedBatch):
    """One layer over the ragged stream x (T, d), ``rope`` the step's
    (cos, sin) tables.  All quantization lives inside the qlinear modules;
    residual adds and rmsnorms run in float between module grids."""
    h, new_cache = att.gqa_attention(
        ctx, p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps), cfg,
        rope=rope, cache=cache, ragged=ragged)
    x = x + h
    x = x + mlp_lib.mlp(ctx, p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps),
                        cfg.act)
    return x, new_cache
