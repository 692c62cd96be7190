"""Step builders of the classic dense-cache serving path and of the legacy
per-shape engine (PyTorch counterpart of ``repro.launch.steps``:
``build_prefill_step``, ``build_serve_step``, ``build_paged_step`` and the
build-time W8A8 check).

The builders validate the configuration once and return plain closures:
PyTorch runs eagerly, so there is nothing to trace or compile.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.qmodel import QuantContext, QuantMode
from repro_torch.models import model as M

__all__ = ["check_matmul_kernel", "build_prefill_step", "build_serve_step",
           "build_paged_step"]


def check_matmul_kernel(cfg: ModelConfig, ctx: QuantContext) -> None:
    """Build-time validation of the W8A8 matmul path: int8 weight codes
    only mean something on the calibrated grids of an INT-mode context, so
    any other mode is refused before the first step, not at the first
    decoded token."""
    if cfg.matmul_kernel not in ("dense", "int8"):
        raise ValueError(f"unknown matmul_kernel={cfg.matmul_kernel!r}; "
                         "expected 'dense' or 'int8'")
    if cfg.matmul_kernel == "int8" and ctx.mode is not QuantMode.INT:
        raise NotImplementedError(
            "matmul_kernel='int8' is the W8A8 deploy path: it requires a "
            "calibrated QuantContext in INT mode (serve_engine(w8a8=True) "
            f"builds one); got mode={ctx.mode.value!r}")


def build_prefill_step(cfg: ModelConfig, ctx: QuantContext,
                       max_seq: Optional[int] = None):
    """``prefill_step(params, batch) -> (last logits (B, V), cache)`` with
    a cache of ``max_seq`` positions."""
    check_matmul_kernel(cfg, ctx)

    def prefill_step(params, batch):
        return M.prefill(params, batch, cfg, ctx, max_seq=max_seq)

    return prefill_step


def build_serve_step(cfg: ModelConfig, ctx: QuantContext):
    """One batched greedy decode step: ``serve_step(params, tokens (B, 1),
    cache, pos) -> (next tokens (B, 1) int32, cache)``; ties take the
    first index, as ``jnp.argmax`` does."""
    check_matmul_kernel(cfg, ctx)

    def serve_step(params, tokens, cache, pos):
        logits, cache = M.decode_step(params, tokens, cache, pos, cfg, ctx)
        return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], cache

    return serve_step


def build_paged_step(cfg: ModelConfig, ctx: QuantContext):
    """One step of the legacy per-shape engine over the paged KV block
    pool: ``paged_step(params, tokens (B, C), cache, positions (B, C),
    block_tables (B, W), work=None) -> (logits (B, C, V), cache)``, with
    ``work`` K4's work list for the positions (planned once per step).
    The same step serves the decode (n_slots, 1), prefill-chunk (1, C)
    and verify (n_slots, K + 1) shapes."""
    check_matmul_kernel(cfg, ctx)

    def paged_step(params, tokens, cache, positions, block_tables,
                   work=None):
        return M.paged_step(params, tokens, cache, positions, block_tables,
                            cfg, ctx, work=work)

    return paged_step
