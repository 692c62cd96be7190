"""Host-side allocator for the paged KV block pool (DESIGN §9, §10, §16).

The device arrays live in ``models.model.init_paged_cache`` (one
(L, NB, BS, KVH, D) arena per K and V); this module owns the *map*: which
pool blocks back which sequence, in which logical order, at which
power-of-two scale exponent, and — with the content-addressed prefix
cache enabled — which blocks are SHARED between sequences.  Everything
here is plain Python/numpy — no jax — so the scheduler property tests run
without a model.

Since PR 10 the allocator core (free stack, refcounts, per-unit scale
exponents, stats, tracer hook) lives in :class:`repro_torch.serving.arena.Arena`
and is shared with the fixed-size state-slab substrate
(:class:`repro_torch.serving.state_pool.StateSlabPool`); ``BlockPool`` is the
growing block-table substrate that layers the prefix cache, idle-LRU
reclaim, copy-on-write, and speculative retract on top.

Ownership model (DESIGN §10).  PR 3's one-owner rule is gone; every
non-trash block is in exactly one of three states:

* **free**    — refcount 0, no content key, on the LIFO free stack;
* **cached**  — refcount 0 but published under a content key: it stays
  resident (its int8 codes are reusable by any future sequence with the
  same prefix) on an idle-LRU and is reclaimed only under allocation
  pressure, oldest first;
* **live**    — refcount >= 1: referenced by that many sequences.  A
  block with refcount > 1 is necessarily published (sharing only ever
  happens through cache hits), and published blocks are IMMUTABLE — their
  key is their content — so writes must copy-on-write first
  (:meth:`BlockPool.cow`).

Invariants (checked by :meth:`BlockPool.check_invariants`, enforced by the
tier-1 property tests):

* block 0 is the TRASH block: never allocated, never freed, never cached.
* free ∪ cached ∪ live partition the non-trash blocks (no orphans).
* ``refcount[b]`` equals the number of sequences whose table contains b.
* refcount > 1 implies published; writable means refcount == 1 AND
  unpublished.
* releasing an unknown sequence (double free) raises — it never corrupts.
* a block's scale exponent never changes while live or cached: codes are
  written once on the Eq.-1 grid chosen at alloc time and never
  requantized while resident (the paper's fewer-requant-ops thesis).
* speculative rollback (:meth:`BlockPool.retract`, DESIGN §11) only ever
  frees private, unpublished tail blocks: commit never covers rejected
  drafts, so their rows can neither publish nor be shared — retracting
  a published/shared or committed-into block raises.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np

from repro_torch.serving.arena import (Arena, BlockPoolError, PoolStats,
                                 TRASH_UNIT)
from repro_torch.serving.prefix_cache import PrefixCache

__all__ = ["BlockPool", "BlockPoolError", "PoolStats", "AllocPlan",
           "TRASH_BLOCK"]

TRASH_BLOCK = TRASH_UNIT


@dataclasses.dataclass
class AllocPlan:
    """Admission-time allocation plan: what a sequence's feed would hit in
    the prefix cache and how many fresh blocks it still needs.  Planning
    is a pure query (no pinning, no stats) so the scheduler can re-plan a
    blocked head-of-line request every step without side effects."""
    n_tokens: int
    scale_exp: int
    hit_blocks: list
    hit_keys: list
    hit_tokens: int
    n_full_lookups: int
    need_new: int
    feasible: bool


class BlockPool(Arena):
    """Fixed-capacity pool of KV blocks with per-sequence block tables,
    per-block reference counts, and an optional content-addressed prefix
    cache (``prefix_cache=True``) for cross-sequence block sharing."""

    def __init__(self, num_blocks: int, block_size: int, *,
                 scale_exp: int = 0, prefix_cache: bool = False):
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        super().__init__(num_blocks, scale_exp=scale_exp)
        self.num_blocks = num_blocks
        self.block_size = block_size
        # refcount-0 published blocks, insertion order == LRU order
        self._idle: "OrderedDict[int, None]" = OrderedDict()
        self.cache: PrefixCache | None = \
            PrefixCache(block_size) if prefix_cache else None

    # -- capacity ---------------------------------------------------------

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` KV rows."""
        return -(-max(n_tokens, 0) // self.block_size)

    def _n_reclaimable(self) -> int:
        return len(self._idle)

    # -- planning ---------------------------------------------------------

    def plan_seq(self, n_tokens: int, *, token_ids=None,
                 scale_exp: int | None = None) -> AllocPlan:
        """Plan an allocation: cache-hit chain + fresh blocks needed.

        A fully-cached feed reserves ONE extra block: the engine must
        re-feed the last token to get logits to sample from, and that
        write lands in the last (shared, immutable) hit block — which
        copy-on-writes into a fresh private block.
        """
        exp = self.default_scale_exp if scale_exp is None else scale_exp
        hits: list[int] = []
        keys: list[int] = []
        n_full = 0
        if self.cache is not None and token_ids is not None:
            n_full = len(token_ids) // self.block_size
            hits, keys = self.cache.lookup(token_ids, exp)
        hit_tokens = len(hits) * self.block_size
        need = self.blocks_for(n_tokens) - len(hits)
        if hits and hit_tokens >= n_tokens:
            need += 1                       # COW of the last hit block
        # hit blocks get pinned before any fresh block is taken, so idle
        # hits are NOT available for LRU reclaim by this allocation
        avail = len(self._free) + len(self._idle) \
            - sum(1 for b in hits if self.refcount[b] == 0)
        return AllocPlan(n_tokens=n_tokens, scale_exp=exp, hit_blocks=hits,
                         hit_keys=keys, hit_tokens=hit_tokens,
                         n_full_lookups=n_full, need_new=need,
                         feasible=need <= avail)

    # -- alloc / extend / free -------------------------------------------

    def alloc_seq(self, seq_id: int, n_tokens: int, *, token_ids=None,
                  scale_exp: int | None = None,
                  plan: AllocPlan | None = None) -> list[int]:
        """Allocate the blocks for a new sequence of ``n_tokens`` rows.

        With the prefix cache enabled and ``token_ids`` (or a ``plan``)
        given, the longest cached full-block chain is ATTACHED (refcount
        bumped, zero quantization ops) and only the uncached tail is
        allocated fresh; ``plan.hit_tokens`` tells the scheduler where
        prefill may start.
        """
        if seq_id in self._seqs:
            raise BlockPoolError(f"sequence {seq_id} already allocated")
        if plan is None:
            plan = self.plan_seq(n_tokens, token_ids=token_ids,
                                 scale_exp=scale_exp)
        if not plan.feasible:
            self.stats.alloc_failures += 1
            raise BlockPoolError(
                f"pool exhausted: need {plan.need_new} blocks, "
                f"{self.n_free} allocatable")
        # pin hits FIRST so the fresh-block takes below cannot LRU-reclaim
        # the very blocks this sequence is attaching to
        for blk, key in zip(plan.hit_blocks, plan.hit_keys):
            if self.cache is None or self.cache.key_of(blk) != key:
                raise BlockPoolError(
                    f"stale plan: block {blk} no longer holds key {key:x}")
            self._acquire(blk)
        fresh_goal = self.blocks_for(n_tokens) - len(plan.hit_blocks)
        new = [self._take(plan.scale_exp) for _ in range(max(fresh_goal, 0))]
        blocks = list(plan.hit_blocks) + new
        self._seqs[seq_id] = blocks
        if self.cache is not None:
            self.cache.on_alloc(seq_id, plan.hit_keys, plan.n_full_lookups,
                                plan.scale_exp)
        self._emit("pool.alloc", {
            "seq": seq_id, "hit_blocks": len(plan.hit_blocks),
            "new_blocks": len(new), "free": self.n_free})
        return list(blocks)  # copy: callers must not mutate the pool's map

    def extend(self, seq_id: int, n_tokens_total: int) -> list[int]:
        """Grow ``seq_id`` to cover ``n_tokens_total`` rows; returns the
        newly allocated blocks ([] when already covered)."""
        if seq_id not in self._seqs:
            raise BlockPoolError(f"unknown sequence {seq_id}")
        blocks = self._seqs[seq_id]
        need = self.blocks_for(n_tokens_total) - len(blocks)
        if need <= 0:
            return []
        if not self.can_alloc(need):
            self.stats.alloc_failures += 1
            raise BlockPoolError(
                f"pool exhausted: extend needs {need}, {self.n_free} free")
        exp = int(self.scale_exp[blocks[0]]) if blocks \
            else self.default_scale_exp
        new = [self._take(exp) for _ in range(need)]
        blocks.extend(new)
        self._emit("pool.extend", {
            "seq": seq_id, "new_blocks": need, "free": self.n_free})
        return new

    def retract(self, seq_id: int, n_tokens_keep: int) -> int:
        """Speculative rollback (DESIGN §11): shrink ``seq_id``'s table to
        the blocks covering its first ``n_tokens_keep`` rows, freeing the
        tail blocks that held only retracted (rejected-draft) rows.
        Returns the number of blocks freed.

        The freed tail is by construction private and unpublished:
        ``commit`` never covers speculative rows, publishing happens only
        through commit, and sharing only through published keys — so a
        rollback can never pull a block out from under another reader.  A
        published or shared tail block means the caller committed rows it
        is now trying to retract, and raises instead of corrupting; with
        the prefix cache on, the sequence's committed chain position is
        cross-checked too (:meth:`PrefixCache.assert_retractable`).
        """
        blocks = self.seq_blocks(seq_id)
        keep = self.blocks_for(n_tokens_keep)
        if keep > len(blocks):
            raise BlockPoolError(
                f"retract of seq {seq_id} to {n_tokens_keep} rows needs "
                f"{keep} blocks but it holds {len(blocks)}")
        tail = blocks[keep:]
        if not tail:
            return 0
        for blk in tail:
            if self.refcount[blk] != 1 or (
                    self.cache is not None
                    and self.cache.is_published(blk)):
                raise BlockPoolError(
                    f"retract would free shared/published block {blk} "
                    f"(seq {seq_id}) — committed rows cannot be rolled "
                    f"back")
        if self.cache is not None:
            self.cache.assert_retractable(seq_id, n_tokens_keep)
        del blocks[keep:]
        for blk in tail:
            self._release(blk)
        self.stats.frees += len(tail)
        self.stats.retracts += 1
        self.stats.retracted_blocks += len(tail)
        self._emit("pool.retract", {
            "seq": seq_id, "freed_blocks": len(tail),
            "keep_tokens": n_tokens_keep})
        return len(tail)

    def _release_seq(self, seq_id: int) -> int:
        n = super()._release_seq(seq_id)
        if self.cache is not None:
            self.cache.release(seq_id)
        return n

    def _on_release_zero(self, blk: int) -> None:
        if self.cache is not None and self.cache.is_published(blk):
            self._idle[blk] = None          # most-recently released
        else:
            self._free.append(blk)

    def _acquire(self, blk: int) -> None:
        """Attach to a published block (cache hit)."""
        self.refcount[blk] += 1
        if self.refcount[blk] == 1:
            del self._idle[blk]                 # was idle-cached
        self.stats.peak_live = max(self.stats.peak_live, self.n_live)

    def _reclaim(self) -> int:
        """Reclaim the LRU idle cached block when the free stack is
        empty."""
        if self._idle:
            blk, _ = self._idle.popitem(last=False)     # oldest first
            self.cache.forget(blk)
            self.stats.cache_evictions += 1
            return blk
        return super()._reclaim()

    # -- copy-on-write ----------------------------------------------------

    def block_writable(self, seq_id: int, logical_idx: int) -> bool:
        """May ``seq_id`` write KV rows into its ``logical_idx``-th block?
        Only private, never-published blocks are writable: a published
        block's key IS its content, and refcount > 1 means another
        sequence is reading it."""
        blk = self.seq_blocks(seq_id)[logical_idx]
        if self.refcount[blk] != 1:
            return False
        return self.cache is None or not self.cache.is_published(blk)

    def cow(self, seq_id: int, logical_idx: int) -> tuple[int, int]:
        """Copy-on-write: replace the (shared/published) block at
        ``logical_idx`` in ``seq_id``'s table with a fresh private block.
        Returns (src, dst); the CALLER must copy the device rows src->dst
        (the pool only moves the map).  Raises BlockPoolError under
        allocation pressure — the scheduler preempts and retries."""
        blocks = self.seq_blocks(seq_id)
        src = blocks[logical_idx]
        if self.block_writable(seq_id, logical_idx):
            raise BlockPoolError(
                f"COW of a writable block {src} (seq {seq_id} idx "
                f"{logical_idx}) — caller should write in place")
        dst = self._take(int(self.scale_exp[src]))
        blocks[logical_idx] = dst
        self._release(src)
        if self.cache is not None:
            self.cache.stats.cow_copies += 1
        self._emit("pool.cow", {
            "seq": seq_id, "idx": logical_idx, "src": src, "dst": dst})
        return src, dst

    # -- cache plumbing ---------------------------------------------------

    def commit(self, seq_id: int, start: int, token_ids) -> None:
        """Record that KV rows for ``token_ids`` at absolute positions
        ``start..`` are now device-resident; full blocks this completes
        become content-addressable.  No-op without the prefix cache."""
        if self.cache is not None:
            self.cache.commit(self, seq_id, start, token_ids)

    def flush_cache(self) -> int:
        """Drop all cached (idle) blocks back to the free stack and every
        content key.  Requires no live sequences."""
        if self.cache is None:
            return 0
        assert not self._seqs, "flush_cache with live sequences"
        n = self.cache.flush()
        while self._idle:
            blk, _ = self._idle.popitem(last=True)
            self._free.append(blk)
        return n

    # -- views ------------------------------------------------------------

    def table_row(self, seq_id: int, width: int):
        """(width,) int32 block table for the engine: the sequence's blocks
        in logical order, tail-padded with the trash block (those entries
        are only ever touched by masked positions).  Unknown sequences
        raise — decoding a freed sequence against trash garbage must fail
        fast, never corrupt silently; INACTIVE slots get their all-trash
        rows from the engine's ``np.full(TRASH_BLOCK)`` default, not from
        here."""
        blocks = self.seq_blocks(seq_id)
        if len(blocks) > width:
            raise BlockPoolError(
                f"sequence {seq_id} has {len(blocks)} blocks > table "
                f"width {width}")
        row = np.full((width,), TRASH_BLOCK, np.int32)
        row[:len(blocks)] = blocks
        return row

    def seq_scale_exp(self, seq_id: int) -> int:
        """The (uniform) Eq.-1 exponent of a live sequence's blocks.
        Shared blocks necessarily share exponents — the exponent is part
        of the content key (and a per-shard kernel constant, DESIGN §8)."""
        blocks = self._seqs.get(seq_id)
        if not blocks:
            raise BlockPoolError(f"unknown sequence {seq_id}")
        exps = {int(self.scale_exp[b]) for b in blocks}
        if len(exps) != 1:
            raise BlockPoolError(
                f"sequence {seq_id} spans blocks with mixed scale "
                f"exponents {sorted(exps)} — a block was requantized")
        return exps.pop()

    # -- invariants -------------------------------------------------------

    def check_invariants(self) -> None:
        """Raises AssertionError on any broken pool invariant."""
        free = set(self._free)
        idle = set(self._idle)
        assert len(free) == len(self._free), "duplicate blocks on free list"
        assert TRASH_BLOCK not in free and TRASH_BLOCK not in idle, \
            "trash block free or cached"
        assert not (free & idle), "block both free and idle-cached"
        # refcount == number of owning sequences, per block
        counts = np.zeros_like(self.refcount)
        live: set[int] = set()
        for sid, blocks in self._seqs.items():
            bset = set(blocks)
            assert len(bset) == len(blocks), f"seq {sid} repeats a block"
            assert TRASH_BLOCK not in bset, f"seq {sid} owns the trash block"
            for blk in blocks:
                counts[blk] += 1
            live |= bset
        assert (counts == self.refcount).all(), \
            "refcount out of sync with sequence ownership"
        assert not (live & free) and not (live & idle), \
            "live block also free or idle-cached"
        assert live | free | idle == set(range(1, self.num_blocks)), \
            "orphan blocks (neither free, cached, nor live)"
        if self.cache is not None:
            self.cache.check_invariants(self)
            for blk in idle:
                assert self.cache.is_published(blk), \
                    f"idle block {blk} has no content key"
            for blk in free:
                assert not self.cache.is_published(blk), \
                    f"free block {blk} still published"
            shared = np.flatnonzero(self.refcount > 1)
            for blk in shared:
                assert self.cache.is_published(int(blk)), \
                    f"block {blk} shared (refcount {self.refcount[blk]}) " \
                    f"but never published"
        else:
            assert not idle, "idle-cached blocks without a prefix cache"
            assert (self.refcount <= 1).all(), \
                "shared block without a prefix cache"
        assert self.stats.peak_live <= self.num_blocks - 1
