"""Substrate protocol: what kind of sequence state an architecture keeps
(DESIGN §16).

A *substrate* is the contract between a model family and the serving
stack: how per-sequence state is stored (growing KV block tables vs a
fixed-size state slab), which scheduler moves are legal on it
(extend / speculative grow / COW vs snapshot-preemption), and which
engine features it supports.  ``substrate_for(cfg)`` is the single
routing decision; pool, scheduler, and engine all consult the same spec
instead of re-deriving family checks.

Three substrates exist:

* ``attention`` — dense/MoE/VLM transformers: per-token KV rows on the
  growing block-table substrate (:class:`~repro_torch.serving.kv_pool.
  BlockPool`); supports speculative decoding, the content-addressed
  prefix cache, and the ragged unified step.
* ``recurrent`` — pure recurrent models (RWKV6): O(1) state on the
  fixed-slab substrate (:class:`~repro_torch.serving.state_pool.
  StateSlabPool`); no spec (state cannot retract rejected drafts), no
  prefix cache (state is a lossy summary, not content-addressable), no
  ragged step (the batched recurrent step is already shape-stable).
* ``hybrid`` — zamba2-style stacks: Mamba layers on slabs AND the shared
  attention block on block tables, in the same jitted step.  The
  fixed-state restrictions win wherever they conflict (no spec / prefix
  cache / ragged), and preemption must recompute (the KV half recomputes
  anyway, re-deriving the state for free).
"""
from __future__ import annotations

import dataclasses

__all__ = ["SubstrateSpec", "ATTENTION", "RECURRENT", "HYBRID",
           "substrate_for"]


@dataclasses.dataclass(frozen=True)
class SubstrateSpec:
    """Static capabilities of a sequence-state substrate."""

    kind: str                    # 'attention' | 'recurrent' | 'hybrid'
    grows: bool                  # per-token KV rows → block tables grow
    fixed_state: bool            # owns a fixed-size state slab
    supports_spec: bool          # speculative decode (needs retract)
    supports_prefix_cache: bool  # content-addressed block sharing
    supports_ragged: bool        # flattened unified dispatch (DESIGN §12)

    @property
    def snapshot_preempt(self) -> bool:
        """Preemption saves/restores the slab instead of recomputing —
        only sound when the slab IS the whole sequence state (pure
        recurrent).  Hybrid must recompute: its KV half is dropped on
        eviction and re-prefilling re-derives the Mamba state anyway."""
        return self.fixed_state and not self.grows


ATTENTION = SubstrateSpec(
    kind="attention", grows=True, fixed_state=False,
    supports_spec=True, supports_prefix_cache=True, supports_ragged=True)

RECURRENT = SubstrateSpec(
    kind="recurrent", grows=False, fixed_state=True,
    supports_spec=False, supports_prefix_cache=False, supports_ragged=False)

HYBRID = SubstrateSpec(
    kind="hybrid", grows=True, fixed_state=True,
    supports_spec=False, supports_prefix_cache=False, supports_ragged=False)


def substrate_for(cfg) -> SubstrateSpec:
    """The serving substrate for a model config (by family)."""
    if cfg.family == "ssm":
        return RECURRENT
    if cfg.family == "hybrid":
        return HYBRID
    return ATTENTION
