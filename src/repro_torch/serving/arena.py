"""Shared arena allocator underneath the serving substrates (DESIGN §16).

PR 10 lifts the "sequence state = growing KV blocks" assumption out of the
serving stack: :class:`Arena` owns the machinery common to every substrate
— a fixed set of numbered units with a LIFO free stack, per-unit reference
counts, per-unit power-of-two scale exponents (Eq. 1), lifecycle stats,
and the optional obs tracer hook — while the two substrates specialize it:

* :class:`repro_torch.serving.kv_pool.BlockPool` — the growing block-table
  substrate for attention KV (units are KV blocks; adds the
  content-addressed prefix cache, idle-LRU reclaim, COW, retract);
* :class:`repro_torch.serving.state_pool.StateSlabPool` — the fixed-size
  state-slab substrate for recurrent models (units are whole-state slabs;
  exactly one per sequence, never extended, never shared).

Everything here is plain Python/numpy — no jax — so the substrate property
tests run without a model.  Unit 0 is the TRASH unit in every arena:
never allocated, never freed; masked lanes read/write it harmlessly.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Arena", "BlockPoolError", "PoolStats", "TRASH_UNIT"]

TRASH_UNIT = 0


class BlockPoolError(RuntimeError):
    """Allocator misuse (double free, unknown sequence, exhausted pool)."""


@dataclasses.dataclass
class PoolStats:
    allocs: int = 0            # units handed out fresh (not cache hits)
    frees: int = 0             # unit references released
    evictions: int = 0         # UNITS released by preemption
    seq_evictions: int = 0     # sequences preempted
    cache_evictions: int = 0   # idle cached blocks reclaimed (LRU)
    retracts: int = 0          # speculative rollbacks that freed blocks
    retracted_blocks: int = 0  # blocks freed by rollback (rejected rows)
    peak_live: int = 0         # max simultaneously-live units
    alloc_failures: int = 0    # alloc/extend requests refused


class Arena:
    """Fixed-capacity pool of numbered units with per-sequence unit lists,
    per-unit reference counts, and per-unit po2 scale exponents.

    Subclass hooks keep the substrate semantics out of the shared core:

    * ``_on_release_zero(unit)`` — where a unit goes when its refcount
      drops to 0 (default: back on the LIFO free stack; the KV substrate
      parks published blocks on its idle-LRU instead);
    * ``_reclaim()`` — called by :meth:`_take` when the free stack is
      empty (default: raise; the KV substrate evicts its LRU idle cached
      block).
    """

    # noun used in error messages and the tracer event names
    unit_noun = "block"
    EVT_FREE = "pool.free"
    EVT_EVICT = "pool.evict"

    def __init__(self, num_units: int, *, scale_exp: int = 0):
        if num_units < 2:
            raise ValueError(
                f"pool needs >= 2 {self.unit_noun}s "
                f"({self.unit_noun} 0 is trash)")
        self.num_units = num_units
        self.default_scale_exp = scale_exp
        # LIFO free stack — recently freed units are re-used first (their
        # arena rows are hot).  Unit 0 (trash) is never on it.
        self._free: list[int] = list(range(num_units - 1, 0, -1))
        self._seqs: dict[int, list[int]] = {}       # seq id -> units, order
        # per-unit owner count; sharing happens only via cache hits
        self.refcount = np.zeros((num_units,), np.int32)
        # per-unit po2 scale exponent (Eq.-1 fractional bit) — written at
        # alloc.  One int per unit of metadata.
        self.scale_exp = np.full((num_units,), scale_exp, np.int32)
        self.stats = PoolStats()
        # optional obs hook (DESIGN §14): the engine attaches its Tracer
        # here; every emission is guarded on ``tracer is not None and
        # tracer.enabled`` so the standalone pool (property tests, no
        # engine) pays one attribute read per lifecycle transition.
        self.tracer = None

    # -- capacity ---------------------------------------------------------

    @property
    def n_free(self) -> int:
        """Allocatable units: truly free + reclaimable (substrate hook)."""
        return len(self._free) + self._n_reclaimable()

    @property
    def n_cached(self) -> int:
        """Resident refcount-0 units reclaimable under pressure."""
        return self._n_reclaimable()

    @property
    def n_live(self) -> int:
        """Units referenced by at least one sequence."""
        return (self.num_units - 1) - len(self._free) \
            - self._n_reclaimable()

    @property
    def utilization(self) -> float:
        return self.n_live / max(self.num_units - 1, 1)

    @property
    def residency(self) -> float:
        """Fraction of the arena holding useful codes (live + cached)."""
        return (self.n_live + self.n_cached) / max(self.num_units - 1, 1)

    def can_alloc(self, n_units: int) -> bool:
        return n_units <= self.n_free

    def _n_reclaimable(self) -> int:
        return 0

    def live_seqs(self) -> list[int]:
        return list(self._seqs)

    def seq_ids(self):
        return self._seqs.keys()

    def seq_blocks(self, seq_id: int) -> list[int]:
        """The sequence's units in logical order (read-only view)."""
        if seq_id not in self._seqs:
            raise BlockPoolError(f"unknown sequence {seq_id}")
        return self._seqs[seq_id]

    def n_blocks_of(self, seq_id: int) -> int:
        return len(self._seqs.get(seq_id, ()))

    # -- free / evict -----------------------------------------------------

    def free_seq(self, seq_id: int) -> int:
        """Release all of ``seq_id``'s unit references; raises on double
        free."""
        if seq_id not in self._seqs:
            raise BlockPoolError(f"double free: unknown sequence {seq_id}")
        n = self._release_seq(seq_id)
        self._emit(self.EVT_FREE, {
            "seq": seq_id, "blocks": n, "free": self.n_free})
        return n

    def evict(self, seq_id: int) -> int:
        """Preemption path: release references + count the eviction
        (unit-granular: ``stats.evictions`` counts units, the preempted
        sequence itself counts once in ``stats.seq_evictions``)."""
        if seq_id not in self._seqs:
            raise BlockPoolError(f"double free: unknown sequence {seq_id}")
        n = self._release_seq(seq_id)
        self.stats.evictions += n
        self.stats.seq_evictions += 1
        self._emit(self.EVT_EVICT, {
            "seq": seq_id, "blocks": n, "free": self.n_free})
        return n

    def _release_seq(self, seq_id: int) -> int:
        units = self._seqs.pop(seq_id)
        for u in units:
            self._release(u)
        self.stats.frees += len(units)
        return len(units)

    def _release(self, unit: int) -> None:
        self.refcount[unit] -= 1
        assert self.refcount[unit] >= 0, \
            f"refcount underflow on {self.unit_noun} {unit}"
        if self.refcount[unit] == 0:
            self._on_release_zero(unit)

    def _on_release_zero(self, unit: int) -> None:
        self._free.append(unit)

    def _take(self, scale_exp: int) -> int:
        """Hand out a fresh private unit, falling back to the substrate's
        reclaim hook when the free stack is empty."""
        if self._free:
            unit = self._free.pop()
        else:
            unit = self._reclaim()
        self.scale_exp[unit] = scale_exp
        self.refcount[unit] = 1
        self.stats.allocs += 1
        self.stats.peak_live = max(self.stats.peak_live, self.n_live)
        return unit

    def _reclaim(self) -> int:
        raise BlockPoolError(
            f"pool exhausted: no free or cached {self.unit_noun}s")

    # -- obs --------------------------------------------------------------

    def _emit(self, name: str, args: dict) -> None:
        tr = self.tracer
        if tr is not None and tr.enabled:
            tr.event(name, "pool", args=args)

    # -- replay determinism ----------------------------------------------

    def reset_free_order(self) -> None:
        """Restore the free stack to its pristine allocation order
        (lowest unit id pops first).  Free-list order is run history —
        an identical logical workload replayed after a reset would
        otherwise land on different PHYSICAL units, which the flight
        recorder's decision stream would flag as a spurious divergence.
        Requires no live sequences."""
        assert not self._seqs, "reset_free_order with live sequences"
        self._free.sort(reverse=True)
