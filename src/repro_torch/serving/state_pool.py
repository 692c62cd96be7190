"""Fixed-size state-slab substrate for recurrent sequence state (§16).

Recurrent models (RWKV6, Mamba2, and the Mamba layers of zamba2's hybrid
stack) carry O(1) state per sequence — a ``(H, dk, dv)`` WKV matrix plus
token-shift streams, or a ``(H, P, N)`` SSD state plus a conv tail —
instead of a growing KV history.  The paper's dataflow thesis is at its
strongest here: the whole state is re-quantized ONCE per engine step on a
per-slab power-of-two grid (Eq. 1), versus one quantize per token per
layer for an attention KV append, and the requant count per token is
*independent of context length*.

:class:`StateSlabPool` is the allocator for that substrate: each live
sequence owns exactly ONE slab (a single-unit "table" on the shared
:class:`repro_torch.serving.arena.Arena` core), slab 0 is the trash slab that
masked batch lanes read and write harmlessly, and the slab's scale
exponent is fixed at admission.  Slabs never extend, never COW, never
publish into a prefix cache — recurrent state is a lossy summary of the
prefix, not content-addressable codes — so :meth:`extend`,
:meth:`retract`, and :meth:`cow` raise ``BlockPoolError`` outright; the
scheduler-level guards (``grow_for_spec`` / COW on a fixed-state
sequence) give the same error a step earlier with scheduling context.

The device arrays live in ``models.model.init_paged_state`` (one
(L, S, ...) arena per state component); this module owns the map, in
plain Python/numpy, so the slab property tests run without a model.
"""
from __future__ import annotations

from repro_torch.serving.arena import (Arena, BlockPoolError, PoolStats,
                                 TRASH_UNIT)

__all__ = ["StateSlabPool", "BlockPoolError", "PoolStats", "TRASH_SLAB"]

TRASH_SLAB = TRASH_UNIT


class StateSlabPool(Arena):
    """Fixed-capacity pool of whole-state slabs, one per live sequence.

    Invariants (checked by :meth:`check_invariants`):

    * slab 0 is the TRASH slab: never allocated, never freed.
    * free ∪ live partition the non-trash slabs (no cached tier —
      recurrent state is never shared or republished).
    * every live sequence owns exactly one slab; refcount is 0 or 1.
    * a slab's scale exponent is fixed from alloc to free: the state is
      requantized once per engine step onto the SAME po2 grid, so the
      exponent is per-sequence metadata, not per-write.
    """

    unit_noun = "slab"
    EVT_FREE = "pool.slab_free"
    EVT_EVICT = "pool.slab_evict"

    def __init__(self, num_slabs: int, *, scale_exp: int = 0):
        super().__init__(num_slabs, scale_exp=scale_exp)
        self.num_slabs = num_slabs

    # -- alloc / free -----------------------------------------------------

    def alloc_slab(self, seq_id: int, *, scale_exp: int | None = None) -> int:
        """Allocate the single state slab for a new sequence."""
        if seq_id in self._seqs:
            raise BlockPoolError(f"sequence {seq_id} already allocated")
        exp = self.default_scale_exp if scale_exp is None else scale_exp
        if not self._free:
            self.stats.alloc_failures += 1
            raise BlockPoolError(
                f"pool exhausted: need 1 slab, {self.n_free} allocatable")
        slab = self._take(exp)
        self._seqs[seq_id] = [slab]
        self._emit("pool.slab_alloc", {
            "seq": seq_id, "slab": slab, "free": self.n_free})
        return slab

    # -- views ------------------------------------------------------------

    def slab_of(self, seq_id: int) -> int:
        """The sequence's slab id (raises on unknown sequence)."""
        return self.seq_blocks(seq_id)[0]

    def slab_exp(self, seq_id: int) -> int:
        """The sequence's fixed Eq.-1 scale exponent."""
        return int(self.scale_exp[self.slab_of(seq_id)])

    # -- forbidden growing-substrate operations ---------------------------

    def extend(self, seq_id: int, n_tokens_total: int):
        raise BlockPoolError(
            f"state slabs are fixed-size: sequence {seq_id} cannot extend "
            f"(recurrent state does not grow with context)")

    def retract(self, seq_id: int, n_tokens_keep: int):
        raise BlockPoolError(
            f"state slabs are fixed-size: sequence {seq_id} cannot retract "
            f"(recurrent state cannot roll back rejected drafts)")

    def cow(self, seq_id: int, logical_idx: int):
        raise BlockPoolError(
            f"state slabs are never shared: COW of sequence {seq_id} is "
            f"meaningless (no prefix cache on the recurrent substrate)")

    # -- invariants -------------------------------------------------------

    def check_invariants(self) -> None:
        """Raises AssertionError on any broken slab-pool invariant."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate slabs on free list"
        assert TRASH_SLAB not in free, "trash slab on the free list"
        live: set[int] = set()
        for sid, slabs in self._seqs.items():
            assert len(slabs) == 1, f"seq {sid} owns {len(slabs)} slabs"
            slab = slabs[0]
            assert slab != TRASH_SLAB, f"seq {sid} owns the trash slab"
            assert slab not in live, f"slab {slab} owned by two sequences"
            assert self.refcount[slab] == 1, \
                f"slab {slab} refcount {self.refcount[slab]} != 1"
            live.add(slab)
        assert not (live & free), "live slab also free"
        assert live | free == set(range(1, self.num_slabs)), \
            "orphan slabs (neither free nor live)"
        assert (self.refcount <= 1).all(), "shared slab"
        assert self.stats.peak_live <= self.num_slabs - 1
