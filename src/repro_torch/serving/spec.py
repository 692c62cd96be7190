"""Speculative decoding's drafters and the device-side verifier
(PyTorch counterpart of ``repro.serving.spec``).

* Drafters (host-side, numpy; copied from the JAX package apart from
  imports): :class:`NgramDrafter`, the deterministic prompt-lookup
  self-drafter, and :class:`CallableDrafter`, the small-draft-model hook.
* :func:`verify_tokens` resolves a (B, K+1) verify chunk on the device:
  greedy rows accept the longest draft prefix that matches the running
  argmax chain and emit the argmax at the first mismatch (token-identical
  to plain greedy decode); sampled rows run Leviathan/Chen rejection
  sampling (accept draft ``d_j`` with probability ``p_j(d_j)``, the
  self-drafter's q being a delta; on the first rejection resample from p
  with the rejected token masked out; if every draft survives, draw a
  bonus token from the last position).  With K = 0 it is plain sampling
  of row 0, the unified ragged step's spec-off shape.

Random draws come from a ``torch.Generator``: the same distribution as the
JAX verifier, not the same bits.  The verifier reads nothing back to the
host and gives every tensor a shape known from its inputs' shapes, so a
CUDA graph can capture it (the serving engine's compiled step).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["NgramDrafter", "CallableDrafter", "DrafterStats",
           "resolve_drafter", "apply_top_k", "verify_tokens"]


# ---------------------------------------------------------------------------
# drafters (host-side)
# ---------------------------------------------------------------------------

class DrafterStats:
    """Draft-efficacy accounting: how often the drafter was asked, how
    many tokens it proposed, and how often it came up empty (the request
    then pays the plain per-token decode rate for that step)."""

    __slots__ = ("calls", "proposed", "empty")

    def __init__(self):
        self.calls = 0
        self.proposed = 0
        self.empty = 0

    def reset(self) -> None:
        self.calls = 0
        self.proposed = 0
        self.empty = 0


class NgramDrafter:
    """Model-free n-gram / prompt-lookup self-drafter (deterministic).

    Proposes the ``k`` tokens that followed the most recent earlier
    occurrence of the longest matching suffix n-gram (``max_ngram`` down
    to ``min_ngram``) of the request's own history (prompt + generated).
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"[{min_ngram}, {max_ngram}]")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.stats = DrafterStats()

    def draft(self, history, k: int) -> np.ndarray:
        """Up to ``k`` proposed continuation tokens ([] when no n-gram of
        the history's suffix recurs earlier in the history)."""
        self.stats.calls += 1
        h = np.asarray(history, np.int32)
        n_hist = len(h)
        if k < 1 or n_hist < self.min_ngram + 1:
            self.stats.empty += 1
            return np.empty(0, np.int32)
        for n in range(min(self.max_ngram, n_hist - 1),
                       self.min_ngram - 1, -1):
            suffix = h[n_hist - n:]
            # windows over h[:-1]: candidate starts 0..n_hist-1-n, which
            # excludes the suffix itself and guarantees a continuation
            win = np.lib.stride_tricks.sliding_window_view(h[:-1], n)
            hits = np.flatnonzero((win == suffix).all(axis=1))
            if len(hits):
                i = int(hits[-1])              # most recent occurrence
                out = h[i + n:i + n + k].copy()
                self.stats.proposed += len(out)
                if not len(out):
                    self.stats.empty += 1
                return out
        self.stats.empty += 1
        return np.empty(0, np.int32)


class CallableDrafter:
    """Pluggable small-draft-model hook: wraps ``fn(history, k)`` -> token
    ids, truncated to ``k``; the target model verifies whatever it
    proposes."""

    def __init__(self, fn):
        self.fn = fn
        self.stats = DrafterStats()

    def draft(self, history, k: int) -> np.ndarray:
        self.stats.calls += 1
        out = np.asarray(self.fn(history, k), np.int32).reshape(-1)[:k]
        self.stats.proposed += len(out)
        if not len(out):
            self.stats.empty += 1
        return out


def resolve_drafter(spec) -> object:
    """'ngram' | any object with a ``draft(history, k)`` method."""
    if isinstance(spec, str):
        if spec == "ngram":
            return NgramDrafter()
        raise ValueError(
            f"unknown drafter {spec!r} (have 'ngram'; or pass an object "
            f"with a draft(history, k) method, e.g. CallableDrafter)")
    if not callable(getattr(spec, "draft", None)):
        raise TypeError(f"drafter {spec!r} has no draft(history, k) method")
    return spec


# ---------------------------------------------------------------------------
# device-side verification
# ---------------------------------------------------------------------------

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


def _draw(probs: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One index per row of ``probs`` (..., V) drawn from it, as
    ``torch.multinomial(probs, 1)`` draws it (argmax of p / E, E ~ Exp(1):
    the same stream of the generator), without multinomial's checks of
    the probabilities, which read them back to the host."""
    e = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return torch.argmax(probs / e, dim=-1)


def verify_tokens(logits: torch.Tensor, tokens: torch.Tensor,
                  n_drafts: torch.Tensor, generator: torch.Generator,
                  temperatures: torch.Tensor,
                  top_k: Optional[torch.Tensor] = None,
                  k_cap: Optional[int] = None,
                  any_sampled: Optional[bool] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Resolve one verify chunk on the device.

    logits (B, K+1, V) from feeding ``tokens`` (B, K+1), laid out
    ``[last committed token, d_1, ..., d_K]`` (positions past
    ``n_drafts[b]`` are padding and ignored); temperatures (B,), 0 for a
    greedy row; top_k (B,) with ``k_cap`` as in :func:`apply_top_k`.
    ``any_sampled`` says on the host whether some row has a temperature
    above 0 (None: read from ``temperatures``, a device sync); with it the
    generator is used, one uniform per draft and one draw per row.

    Returns ``(out (B, K+1) int32, n_accepted (B,) int32)``: row ``b``
    emits ``out[b, :n_accepted[b] + 1]``, the accepted draft prefix plus
    one correction (first rejection) or bonus (all accepted) token, and
    zeros after it."""
    b, kp1, v = logits.shape
    k = kp1 - 1
    dev = logits.device
    logits = logits.to(torch.float32)
    greedy = torch.argmax(logits, dim=-1)                   # (B, K+1)
    drafts = tokens[:, 1:].long()                           # (B, K)
    n_drafts = n_drafts.long()
    rows = torch.arange(b, device=dev)
    valid = torch.arange(k, device=dev)[None, :] < n_drafts[:, None]
    accept = drafts == greedy[:, :k]
    sampled = temperatures > 0
    if any_sampled is None:
        any_sampled = bool(sampled.any())
    if any_sampled:
        proc = apply_top_k(logits, top_k[:, None], k_cap) \
            if top_k is not None else logits
        scaled = proc / torch.clamp(temperatures, min=1e-6)[:, None, None]
        logp = torch.log_softmax(scaled, dim=-1)            # (B, K+1, V)
        p_draft = logp[:, :k].gather(-1, drafts[..., None])[..., 0].exp()
        u = torch.rand((b, k), generator=generator, device=dev)
        accept = torch.where(sampled[:, None], u < p_draft, accept)
    ok = (accept & valid).to(torch.int64)
    n_acc = torch.cumprod(ok, dim=1).sum(dim=1)             # (B,)
    rep = greedy[rows, n_acc]
    if any_sampled:
        # one draw per row, kept on the sampled rows: the residual (p
        # minus the rejected draft) at the first rejection, else the
        # bonus row n_acc
        dist = logp[rows, n_acc]                            # (B, V)
        if k:
            rejected = n_acc < n_drafts
            at = torch.clamp(n_acc, max=k - 1)
            res = logp[rows, at].scatter(
                -1, drafts[rows, at][:, None], float("-inf"))
            dist = torch.where(rejected[:, None], res, dist)
        draw = _draw(torch.softmax(dist, dim=-1), generator)
        rep = torch.where(sampled, draw, rep)
    j = torch.arange(kp1, device=dev)[None, :]
    d_pad = torch.cat([drafts, torch.zeros((b, 1), dtype=drafts.dtype,
                                           device=dev)], dim=1)
    out = torch.where(j < n_acc[:, None], d_pad,
                      torch.where(j == n_acc[:, None], rep[:, None],
                                  torch.zeros_like(d_pad)))
    return out.to(torch.int32), n_acc.to(torch.int32)
