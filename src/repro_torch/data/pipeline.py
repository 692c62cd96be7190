"""Deterministic synthetic token stream (numpy only).

A copy of the numpy part of the JAX package's ``repro.data.pipeline``:
``batch(step)`` is a pure function of ``(seed, step)`` and draws, number
for number, what the JAX package's stream draws, so calibration batches
and prompts are the same in both packages.  The labels and mask are not
kept.  With ``encoder_seq`` (the audio family) the batch also carries
``encoder_features``, (B, encoder_seq, d_model) fp32 stub frame
embeddings drawn after the tokens, so the tokens are the same with or
without them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["SyntheticLMStream", "make_calibration_batch"]


class SyntheticLMStream:
    """Zipf-ish synthetic token stream with n-gram structure (a token
    repeats its predecessor with probability 0.3), deterministic per
    step."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, encoder_seq: Optional[int] = None,
                 d_model: Optional[int] = None):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.encoder_seq = encoder_seq
        self.d_model = d_model

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        b, s = self.global_batch, self.seq_len
        base = rng.zipf(1.3, size=(b, s)).astype(np.int64)
        base = np.minimum(base - 1, self.vocab_size - 1)
        rep = rng.random((b, s)) < 0.3
        shifted = np.roll(base, 1, axis=1)
        out = {"tokens": np.where(rep, shifted, base).astype(np.int32)}
        if self.encoder_seq is not None:
            out["encoder_features"] = rng.standard_normal(
                (b, self.encoder_seq, self.d_model), dtype=np.float32)
        return out


def make_calibration_batch(vocab_size: int, seq_len: int, batch: int,
                           seed: int = 17) -> dict:
    """The paper calibrates on a single batch ("a single image", §2.1)."""
    return SyntheticLMStream(vocab_size, seq_len, batch, seed).batch(0)
