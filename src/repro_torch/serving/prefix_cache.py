"""Content-addressed prefix cache over the paged int8-KV pool (DESIGN §10).

The paper's thesis — fewer quantization ops mean less information loss and
less energy (Eq. 1, Table 5) — made PR 3's KV blocks write-once with
immutable per-block power-of-two scale exponents.  Immutability is what
makes a block *content-addressable*: a full block's KV codes are a pure
function of (the prefix that preceded it, its own token ids, the Eq.-1
scale exponent), so a shared system prompt quantized once can serve every
request that reuses it with ZERO additional quantization ops.

Key derivation is a radix-style chained hash::

    key(block) = blake2b(key(parent) || scale_exp || block_token_ids)

so a block's identity encodes its WHOLE prefix — two blocks with the same
16 tokens but different histories never collide, and a lookup is a walk
down the chain that stops at the first miss (a broken chain can never hit
again later).  Only FULL blocks are addressable: a partial tail block's
content is still growing, so it stays private to its sequence.

This module is pure Python/numpy (no jax) and owns only the *naming*
layer: key<->block maps, per-sequence chain state for incremental
publishing, and hit/miss/COW accounting.  Reference counts, the idle-LRU
eviction set and the copy-on-write protocol live in
:class:`repro_torch.serving.kv_pool.BlockPool`, which drives this cache through
``lookup`` / ``on_alloc`` / ``commit`` / ``release`` / ``forget``.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

__all__ = ["PrefixCache", "CacheStats", "block_key", "ROOT_KEY"]

# chain anchor for blocks with no parent (prefix starts at position 0);
# an arbitrary odd 64-bit constant, NOT a reachable blake2b output
ROOT_KEY = 0x9E3779B97F4A7C15


def block_key(parent_key: int, token_ids, scale_exp: int) -> int:
    """Chained content hash of one FULL block.

    Deterministic across processes (blake2b, not PYTHONHASHSEED-dependent
    ``hash()``), so cache behavior is reproducible run to run.
    """
    h = hashlib.blake2b(digest_size=16)
    h.update(int(parent_key).to_bytes(16, "little", signed=False))
    h.update(int(np.int32(scale_exp)).to_bytes(4, "little", signed=True))
    h.update(np.ascontiguousarray(
        np.asarray(token_ids, np.int32)).tobytes())
    return int.from_bytes(h.digest(), "little")


@dataclasses.dataclass
class CacheStats:
    """Hit/miss accounting at FULL-BLOCK granularity (partial tails are
    never looked up — they are not addressable)."""
    hits: int = 0              # full-block lookups served from cache
    misses: int = 0            # full-block lookups that missed
    hit_tokens: int = 0        # block_size * hits
    lookup_tokens: int = 0     # block_size * (hits + misses)
    cow_copies: int = 0        # shared blocks copied before a write
    published: int = 0         # blocks registered under a content key
    evictions: int = 0         # idle cached blocks reclaimed (LRU)

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    @property
    def token_hit_rate(self) -> float:
        return self.hit_tokens / self.lookup_tokens \
            if self.lookup_tokens else 0.0


@dataclasses.dataclass
class _SeqChain:
    """Per-sequence incremental publishing state: the chain key reached so
    far and the token buffer of the block currently filling."""
    parent_key: int            # key of the last settled logical block
    scale_exp: int
    n_chained: int = 0         # logical blocks whose chain key is settled
    pos: int = 0               # absolute tokens recorded (committed)
    buf: list = dataclasses.field(default_factory=list)


class PrefixCache:
    """Key<->block naming layer; driven by :class:`BlockPool`."""

    def __init__(self, block_size: int):
        self.block_size = block_size
        self._by_key: dict[int, int] = {}      # content key -> pool block
        self._key_of: dict[int, int] = {}      # pool block -> content key
        self._seq: dict[int, _SeqChain] = {}
        self.stats = CacheStats()
        # optional obs hook (DESIGN §14): attached by the engine; every
        # emission is guarded on ``tracer is not None and tracer.enabled``
        self.tracer = None

    # -- queries ----------------------------------------------------------

    def __len__(self) -> int:
        return len(self._by_key)

    def key_of(self, block: int):
        """The content key a block is published under, or None."""
        return self._key_of.get(block)

    def is_published(self, block: int) -> bool:
        return block in self._key_of

    def lookup(self, token_ids, scale_exp: int
               ) -> tuple[list[int], list[int]]:
        """Longest cached chain of full blocks prefixing ``token_ids``.

        Returns (blocks, keys), both in logical order.  Pure query — no
        stats, no pinning; the pool counts hits/misses once, when a plan
        is actually consumed by an allocation (planning is retried every
        admission attempt while the head of the queue is blocked, and
        retries must not inflate the hit rate).
        """
        token_ids = np.asarray(token_ids, np.int32)
        blocks: list[int] = []
        keys: list[int] = []
        parent = ROOT_KEY
        bs = self.block_size
        for b in range(len(token_ids) // bs):
            key = block_key(parent, token_ids[b * bs:(b + 1) * bs],
                            scale_exp)
            blk = self._by_key.get(key)
            if blk is None:
                break
            blocks.append(blk)
            keys.append(key)
            parent = key
        return blocks, keys

    # -- lifecycle (called by BlockPool) ----------------------------------

    def on_alloc(self, seq_id: int, hit_keys: list[int], n_full_lookups: int,
                 scale_exp: int) -> None:
        """Record an allocation that attached ``hit_keys`` after looking up
        ``n_full_lookups`` full blocks, and start the sequence's chain."""
        bs = self.block_size
        self.stats.hits += len(hit_keys)
        self.stats.misses += n_full_lookups - len(hit_keys)
        self.stats.hit_tokens += len(hit_keys) * bs
        self.stats.lookup_tokens += n_full_lookups * bs
        tr = self.tracer
        if tr is not None and tr.enabled:
            # one summary event per CONSUMED lookup (planning retries are
            # side-effect free and never reach here, mirroring the stats)
            tr.event("cache.lookup", "cache", args={
                "seq": seq_id, "hit_blocks": len(hit_keys),
                "miss_blocks": n_full_lookups - len(hit_keys),
                "hit_tokens": len(hit_keys) * bs})
        self._seq[seq_id] = _SeqChain(
            parent_key=hit_keys[-1] if hit_keys else ROOT_KEY,
            scale_exp=scale_exp,
            n_chained=len(hit_keys),
            pos=len(hit_keys) * bs)

    def commit(self, pool, seq_id: int, start: int, token_ids) -> None:
        """Record that KV rows for ``token_ids`` at absolute positions
        ``start..start+len-1`` are now resident; publish every block this
        completes.  Re-commits of already-recorded positions (the COW
        re-feed of a fully-cached prompt's last token) are ignored — the
        rows are bit-identical by construction."""
        st = self._seq.get(seq_id)
        if st is None:
            return
        token_ids = np.asarray(token_ids, np.int32)
        if start > st.pos:
            raise AssertionError(
                f"seq {seq_id}: commit at {start} leaves a gap after "
                f"{st.pos} recorded tokens")
        if start + len(token_ids) <= st.pos:
            return
        st.buf.extend(int(t) for t in token_ids[st.pos - start:])
        st.pos += len(token_ids) - (st.pos - start)
        bs = self.block_size
        while len(st.buf) >= bs:
            blk_tokens = st.buf[:bs]
            del st.buf[:bs]
            key = block_key(st.parent_key, blk_tokens, st.scale_exp)
            blk = pool.seq_blocks(seq_id)[st.n_chained]
            # publish only private, never-published blocks; a concurrent
            # identical prompt may have published this key first, in which
            # case this sequence's physical copy simply stays anonymous
            if key not in self._by_key and blk not in self._key_of \
                    and pool.refcount[blk] == 1:
                self._by_key[key] = blk
                self._key_of[blk] = key
                self.stats.published += 1
                tr = self.tracer
                if tr is not None and tr.enabled:
                    tr.event("cache.publish", "cache", args={
                        "seq": seq_id, "block": blk,
                        "chain_idx": st.n_chained})
            st.parent_key = key
            st.n_chained += 1

    def assert_retractable(self, seq_id: int, n_tokens_keep: int) -> None:
        """Rollback safety (DESIGN §11): a sequence may only retract rows
        it never committed — the publish chain must not extend past the
        keep point, or a rejected speculative token could already have
        leaked into a content key."""
        st = self._seq.get(seq_id)
        if st is not None and st.pos > n_tokens_keep:
            raise AssertionError(
                f"seq {seq_id}: retract to {n_tokens_keep} rows but "
                f"{st.pos} tokens already committed")

    def release(self, seq_id: int) -> None:
        """Drop the sequence's chain state (its published blocks keep
        their keys — that is the whole point)."""
        self._seq.pop(seq_id, None)

    def forget(self, block: int) -> None:
        """Unregister an idle cached block being reclaimed (LRU evict)."""
        key = self._key_of.pop(block)
        del self._by_key[key]
        self.stats.evictions += 1
        tr = self.tracer
        if tr is not None and tr.enabled:
            tr.event("cache.forget", "cache", args={"block": block})

    def flush(self) -> int:
        """Drop every key (pool moves the idle blocks to the free stack);
        returns the number of keys dropped.  Chain state must be empty —
        flushing under live sequences would desync publishing."""
        assert not self._seq, "flush with live sequence chains"
        n = len(self._by_key)
        self._by_key.clear()
        self._key_of.clear()
        return n

    # -- invariants -------------------------------------------------------

    def check_invariants(self, pool) -> None:
        assert len(self._by_key) == len(self._key_of), \
            "key<->block maps out of sync"
        for key, blk in self._by_key.items():
            assert self._key_of.get(blk) == key, \
                f"block {blk} key mapping not bijective"
        for sid, st in self._seq.items():
            assert sid in pool.seq_ids(), f"chain for unknown seq {sid}"
            assert len(st.buf) < self.block_size
            assert st.pos == st.n_chained * self.block_size + len(st.buf)
