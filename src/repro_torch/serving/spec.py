"""Device-side sampling of the unified ragged step (PyTorch counterpart of
``repro.serving.spec.apply_top_k`` / ``verify_tokens``).

Only the ``n_drafts == 0`` shape is ported: every sequence samples its
row 0 (greedy argmax, or a temperature / top-k draw).  Speculative draft
verification (K > 0) and the n-gram drafter are ROADMAP Queue 1 item 4's
remaining part.  Random draws come from a ``torch.Generator``: the same
distribution as the JAX sampler, not the same bits.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["apply_top_k", "verify_tokens"]


def apply_top_k(logits: torch.Tensor, top_k: torch.Tensor,
                k_cap: Optional[int] = None) -> torch.Tensor:
    """Mask logits outside each row's top-k (``top_k == 0`` keeps the
    row's full vocabulary).  Exactly-k: ties at the k-th value break
    lowest index first, so the candidate set never exceeds k.  ``k_cap``
    bounds every row's k (rows above it are capped)."""
    v = logits.shape[-1]
    cap = v if k_cap is None else max(min(int(k_cap), v), 1)
    flat = logits.reshape(-1, v)
    tk = torch.broadcast_to(torch.as_tensor(top_k, dtype=torch.int32,
                                            device=logits.device),
                            logits.shape[:-1]).reshape(-1)
    idx = torch.sort(flat, dim=-1, descending=True, stable=True).indices
    idx = idx[:, :cap]
    keep = torch.arange(cap, device=logits.device)[None, :] < tk[:, None]
    mask = torch.zeros(flat.shape, dtype=torch.bool, device=logits.device)
    mask.scatter_(1, idx, keep)
    out = torch.where(mask | (tk <= 0)[:, None], flat,
                      torch.full_like(flat, float("-inf")))
    return out.reshape(logits.shape)


def verify_tokens(logits: torch.Tensor, tokens: torch.Tensor,
                  n_drafts: torch.Tensor, generator: torch.Generator,
                  temperatures: torch.Tensor,
                  top_k: Optional[torch.Tensor] = None,
                  k_cap: Optional[int] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Resolve one verify chunk with no drafts: logits (B, 1, V) from
    feeding ``tokens`` (B, 1).  Row ``b`` emits ``out[b, 0]``: the greedy
    argmax when ``temperatures[b] == 0``, else a draw from the
    temperature-scaled (top-k masked) distribution.  Returns
    ``(out (B, 1) int32, n_accepted (B,) int32 zeros)``."""
    b, kp1, v = logits.shape
    if kp1 != 1:
        raise NotImplementedError(
            "speculative verification (K > 0 drafts) is not ported yet "
            "(ROADMAP Queue 1 item 4)")
    logits = logits.to(torch.float32)[:, 0]
    rep = torch.argmax(logits, dim=-1)
    sampled = temperatures > 0
    if bool(sampled.any()):
        proc = apply_top_k(logits, top_k, k_cap) if top_k is not None \
            else logits
        scaled = proc / torch.clamp(temperatures, min=1e-6)[:, None]
        probs = torch.softmax(scaled[sampled], dim=-1)
        draw = torch.multinomial(probs, 1, generator=generator)[:, 0]
        rep = rep.clone()
        rep[sampled] = draw
    n_acc = torch.zeros(b, dtype=torch.int32, device=logits.device)
    return rep.to(torch.int32)[:, None], n_acc
