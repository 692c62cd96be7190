"""Request lifecycle + slot-based continuous batching (DESIGN §9).

Pure host-side bookkeeping — no jax imports — so the fairness and
no-starvation property tests drive it with a fake model.

Lifecycle::

    WAITING --admit (FCFS, slot + blocks available)--> PREFILL
    PREFILL --chunked prefill done, first token sampled--> DECODE
    DECODE  --stop token / max-new-tokens / model-len--> DONE
    PREFILL/DECODE --pool pressure (recompute preemption)--> WAITING

Scheduling policy:

* **FCFS with head-of-line blocking**: requests admit strictly in arrival
  order; if the head of the queue doesn't fit (no free slot or not enough
  pool blocks) nothing behind it admits either.  A later small request can
  therefore never starve an earlier large one.
* **Chunked prefill**: prompts are fed in ``chunk``-token pieces under a
  per-engine-step token budget, so admitting a long prompt never stalls
  the decode batch for more than one chunk.
* **Recompute preemption, youngest first**: when a decode step cannot get
  a block, the most recently *admitted* request is evicted (its block
  references released, its prompt+generated tokens re-queued for
  re-prefill).  The oldest running request is only ever preempted when it
  is the sole runner, so the oldest request always makes progress — no
  livelock, no starvation.  Generated tokens survive preemption: the
  re-prefill feed is ``prompt + generated`` and decoding resumes where it
  left off.
* **Prefix-cache admission** (DESIGN §10): with the pool's
  content-addressed cache enabled, admission plans the feed against the
  cache, ATTACHES the longest cached full-block chain (shared, read-only,
  zero quantization ops) and starts chunked prefill at the first uncached
  token.  A fully-cached feed still re-feeds its last token (logits are
  needed to sample), which copy-on-writes the last shared block; a
  preempted request releases references instead of freeing, so its
  published blocks survive for the resume to re-attach.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np

from repro_torch.serving.kv_pool import BlockPool, BlockPoolError
from repro_torch.serving.state_pool import StateSlabPool
from repro_torch.serving.substrate import ATTENTION, SubstrateSpec

__all__ = ["Request", "RequestState", "Scheduler", "chunk_bucket"]


class RequestState(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"


def chunk_bucket(n: int, chunk: int, *, floor: int = 4) -> int:
    """Shape bucket for a prefill piece of ``n`` real tokens: the full
    ``chunk`` when it fills one, else the smallest power of two >= n
    (floored) — so jit sees at most log2(chunk) distinct prefill widths."""
    if n >= chunk:
        return chunk
    b = floor
    while b < n:
        b <<= 1
    return min(b, chunk)


@dataclasses.dataclass
class Request:
    """One generation request plus its runtime bookkeeping."""

    rid: int
    prompt: np.ndarray                    # int32 token ids (immutable)
    max_new_tokens: int
    temperature: float = 0.0              # 0 -> greedy
    top_k: int = 0                        # 0 -> full vocab (engine hook)
    stop_token: Optional[int] = None
    arrival: float = 0.0                  # seconds on the engine clock

    # runtime (managed by the scheduler/engine)
    state: RequestState = RequestState.WAITING
    slot: Optional[int] = None
    generated: list = dataclasses.field(default_factory=list)
    feed: Optional[np.ndarray] = None     # tokens to (re-)prefill
    n_prefilled: int = 0                  # feed tokens whose KV is resident
    n_ctx: int = 0                        # KV rows live in the pool
    cached_tokens: int = 0                # prefill tokens skipped via cache
    # fixed-slab substrate (§16): host copy of the slab state captured at
    # preemption — resume restores it instead of recomputing the prefix
    snapshot: Optional[dict] = None
    preemptions: int = 0
    t_admit: Optional[float] = None
    t_first: Optional[float] = None       # first token sampled (TTFT)
    t_done: Optional[float] = None

    @property
    def n_generated(self) -> int:
        return len(self.generated)

    def finished_by(self, token: int, max_model_len: int) -> bool:
        """Would sampling ``token`` complete this request?"""
        if self.stop_token is not None and token == self.stop_token:
            return True
        if self.n_generated + 1 >= self.max_new_tokens:
            return True
        # +1: the next decode step would need to WRITE this token's KV row
        return len(self.prompt) + self.n_generated + 1 >= max_model_len


class Scheduler:
    """Slot-based continuous batching over the sequence-state substrates.

    ``substrate`` (DESIGN §16) selects which moves are legal: the growing
    attention substrate schedules over ``pool`` (a :class:`BlockPool`);
    fixed-state substrates additionally (hybrid) or exclusively
    (recurrent, ``pool=None``) admit against ``state_pool`` — one slab
    per live sequence, allocated at admission, never grown.  Preemption
    on the pure-recurrent substrate snapshots the slab (via the engine's
    ``snapshot_fn`` hook) so the resume restores O(1) state instead of
    recomputing the whole prefix."""

    def __init__(self, pool: Optional[BlockPool], *, n_slots: int,
                 chunk: int, max_model_len: int,
                 prefill_token_budget: Optional[int] = None,
                 state_pool: Optional[StateSlabPool] = None,
                 substrate: Optional[SubstrateSpec] = None):
        if n_slots < 1:
            raise ValueError("need at least one slot")
        substrate = ATTENTION if substrate is None else substrate
        if pool is not None and \
                max_model_len > (pool.num_blocks - 1) * pool.block_size:
            raise ValueError(
                f"max_model_len {max_model_len} exceeds pool capacity "
                f"{(pool.num_blocks - 1) * pool.block_size} tokens — a "
                f"lone max-length request could deadlock")
        if substrate.grows and pool is None:
            raise ValueError(
                f"{substrate.kind} substrate grows block tables — needs a "
                f"BlockPool")
        if substrate.fixed_state and state_pool is None:
            raise ValueError(
                f"{substrate.kind} substrate keeps fixed-size state — "
                f"needs a StateSlabPool")
        self.pool = pool
        self.state_pool = state_pool
        self.substrate = substrate
        self.n_slots = n_slots
        self.chunk = chunk
        self.max_model_len = max_model_len
        self.prefill_token_budget = prefill_token_budget or chunk
        self.nbmax = (-(-max_model_len // pool.block_size)
                      if pool is not None else 0)
        self.waiting: list[Request] = []      # kept sorted by (arrival, rid)
        self.slots: list[Optional[Request]] = [None] * n_slots
        self.done: list[Request] = []
        self.admission_log: list[int] = []    # rids in admission order
        # optional obs hook (DESIGN §14): the engine attaches its Tracer.
        # Request-timeline marks (admit / preempt / done) are always-on
        # when a tracer is attached — they are a few floats per request
        # and the source of the report's trace-derived latency section;
        # ring events additionally check ``tracer.enabled``.
        self.tracer = None
        # engine hook (§16): captures a host snapshot of a request's slab
        # at preemption on snapshot-preempt substrates (pure recurrent)
        self.snapshot_fn = None

    # -- queue ------------------------------------------------------------

    def submit(self, req: Request) -> None:
        if len(req.prompt) < 1:
            raise ValueError(f"request {req.rid}: empty prompt")
        if len(req.prompt) + req.max_new_tokens > self.max_model_len:
            raise ValueError(
                f"request {req.rid}: prompt {len(req.prompt)} + max_new "
                f"{req.max_new_tokens} exceeds max_model_len "
                f"{self.max_model_len}")
        req.state = RequestState.WAITING
        self._enqueue(req)

    def _enqueue(self, req: Request) -> None:
        key = (req.arrival, req.rid)
        i = 0
        while i < len(self.waiting) and \
                (self.waiting[i].arrival, self.waiting[i].rid) <= key:
            i += 1
        self.waiting.insert(i, req)

    @property
    def idle(self) -> bool:
        return not self.waiting and all(s is None for s in self.slots)

    def active(self) -> list[Request]:
        return [r for r in self.slots if r is not None]

    # -- admission (FCFS, head-of-line blocking) --------------------------

    def admit(self, now: float) -> list[Request]:
        admitted = []
        while self.waiting:
            try:
                slot = self.slots.index(None)
            except ValueError:
                break
            req = self.waiting[0]
            req.feed = np.concatenate(
                [req.prompt, np.asarray(req.generated, np.int32)]) \
                if req.generated else req.prompt
            if self.state_pool is not None and self.state_pool.n_free < 1:
                break                         # no slab: FCFS head blocks
            plan = None
            if self.pool is not None:
                plan = self.pool.plan_seq(len(req.feed), token_ids=req.feed)
                if not plan.feasible:
                    break                     # head blocks the line: FCFS
            self.waiting.pop(0)
            if self.pool is not None:
                self.pool.alloc_seq(req.rid, len(req.feed), plan=plan)
            if self.state_pool is not None:
                self.state_pool.alloc_slab(req.rid)
            req.state = RequestState.PREFILL
            req.slot = slot
            if req.snapshot is not None:
                # fixed-slab resume (§16): the engine restores the host
                # snapshot into the fresh slab; prefill resumes at the
                # snapshot's absorbed-token count (always len(feed) - 1:
                # the last token is re-fed so the engine gets a logits
                # row to sample from, exactly like a fully-cached feed)
                hit = min(int(req.snapshot["n_ctx"]), len(req.feed) - 1)
            else:
                # cached-prefix fast path (DESIGN §10): KV rows for the
                # hit chain are already resident — chunked prefill starts
                # at the first uncached token.  A fully-cached feed still
                # re-feeds its last token (the engine needs its logits
                # row to sample), COWing the last shared block before
                # the write.
                hit = min(plan.hit_tokens, len(req.feed) - 1) \
                    if plan is not None else 0
                req.cached_tokens += hit
            req.n_prefilled = hit
            req.n_ctx = hit
            req.t_admit = now if req.t_admit is None else req.t_admit
            self.slots[slot] = req
            self.admission_log.append(req.rid)
            admitted.append(req)
            tr = self.tracer
            if tr is not None:
                tr.req_mark(req.rid, "admit", now)
                if tr.enabled:
                    # "order" pins the global admission index into the
                    # flight recorder's decision stream: a replay that
                    # admits the same rids in a different order diffs
                    # even if the ring dropped earlier events
                    tr.event("sched.admit", "sched", ts=now, args={
                        "rid": req.rid, "slot": slot,
                        "order": len(self.admission_log) - 1,
                        "feed_tokens": len(req.feed),
                        "cached_tokens": hit,
                        "resume": req.preemptions > 0})
        return admitted

    # -- prefill ----------------------------------------------------------

    def prefill_jobs(self) -> list[Request]:
        """PREFILL-state requests in admission (slot-stable FCFS) order."""
        jobs = [r for r in self.slots
                if r is not None and r.state is RequestState.PREFILL]
        jobs.sort(key=lambda r: (r.t_admit, r.rid))
        return jobs

    # -- decode -----------------------------------------------------------

    def decode_reqs(self) -> list[Request]:
        return [r for r in self.slots
                if r is not None and r.state is RequestState.DECODE]

    def mixed_work(self) -> list[Request]:
        """One MIXED work-list for a unified ragged step (DESIGN §12):
        every live request exactly once — PREFILL jobs first (admission
        order, each contributing one chunk), then DECODE requests (each
        contributing its fed token plus any speculative tail).  Replaces
        the phase-ordered prefill-then-decode dispatch; a request is in
        exactly one state, so the list length never exceeds n_slots."""
        return self.prefill_jobs() + self.decode_reqs()

    def grow_for_decode(self, req: Request, now: float,
                        n_tokens: int = 1) -> bool:
        """Ensure ``req`` owns blocks for KV rows ``n_ctx .. n_ctx +
        n_tokens - 1`` (the incoming token's position, plus the
        speculative tail when ``n_tokens > 1``).  On pool pressure, evict
        the youngest-admitted running request and retry; returns False
        iff ``req`` itself was the youngest and got preempted (skip its
        decode this step).  Non-growing substrates (§16) are a no-op:
        the state slab already holds every future token."""
        if not self.substrate.grows:
            return True
        while True:
            try:
                self.pool.extend(req.rid, req.n_ctx + n_tokens)
                return True
            except BlockPoolError:
                victim = max(self.active(),
                             key=lambda r: (r.t_admit, r.rid))
                self.preempt(victim, now)
                if victim is req:
                    return False

    def grow_for_spec(self, req: Request, now: float,
                      n_draft: int) -> Optional[int]:
        """Variable tokens-per-step growth for a speculative verify step
        writing ``1 + n_draft`` KV rows (DESIGN §11).  The speculative
        tail is OPTIONAL: under pool pressure the draft count degrades
        (fewer tokens verified this step) before any peer is preempted —
        only the mandatory single-token growth falls back to the §9
        youngest-first preemption retry.  Returns the granted draft
        count, or None iff ``req`` itself ended up preempted."""
        if self.substrate.fixed_state:
            raise BlockPoolError(
                f"speculative growth on the {self.substrate.kind} "
                f"substrate: sequence {req.rid} keeps fixed-size recurrent "
                f"state, which cannot retract rejected draft tokens "
                f"(spec decode needs the growing attention substrate)")
        bs = self.pool.block_size
        have = self.pool.n_blocks_of(req.rid) * bs
        spare = have + self.pool.n_free * bs - (req.n_ctx + 1)
        k = max(min(n_draft, spare), 0)
        tr = self.tracer
        if k < n_draft and tr is not None and tr.enabled:
            # pool pressure degraded the speculative tail: fewer tokens
            # verified this step instead of preempting a peer
            tr.event("sched.spec_degrade", "sched", ts=now, args={
                "rid": req.rid, "requested": n_draft, "granted": k})
        if not self.grow_for_decode(req, now, n_tokens=1 + k):
            return None
        return k

    def cow_for_prefill(self, req: Request, logical_idx: int,
                        now: float):
        """Copy-on-write the shared block at ``logical_idx`` before the
        engine writes KV rows into it, with the same youngest-first
        preemption retry as decode growth.  Returns the (src, dst) block
        pair — the ENGINE must copy the device rows — or None iff ``req``
        itself was preempted (skip its prefill this step)."""
        if self.substrate.fixed_state:
            raise BlockPoolError(
                f"copy-on-write on the {self.substrate.kind} substrate: "
                f"sequence {req.rid} owns a private state slab, never a "
                f"shared block (fixed-state substrates have no prefix "
                f"cache to COW from)")
        while True:
            try:
                return self.pool.cow(req.rid, logical_idx)
            except BlockPoolError:
                victim = max(self.active(),
                             key=lambda r: (r.t_admit, r.rid))
                tr = self.tracer
                if tr is not None and tr.enabled:
                    tr.event("sched.cow_retry", "sched", ts=now, args={
                        "rid": req.rid, "idx": logical_idx,
                        "victim": victim.rid})
                self.preempt(victim, now)
                if victim is req:
                    return None

    def preempt(self, req: Request, now: float) -> None:
        """Recompute preemption: release block references (the request's
        PUBLISHED blocks stay cached for the resume to re-attach), requeue
        (arrival order keeps its place near the front), keep generated
        tokens for the resume feed.

        Snapshot-preempt substrates (§16, pure recurrent) capture a host
        copy of the slab through the engine's ``snapshot_fn`` first: the
        O(1) state IS the whole prefix summary, so the resume restores it
        instead of re-prefilling hundreds of tokens."""
        snap = (self.substrate.snapshot_preempt
                and self.snapshot_fn is not None)
        if snap:
            req.snapshot = self.snapshot_fn(req)
        tr = self.tracer
        if tr is not None:
            tr.req_preempt(req.rid)
            if tr.enabled:
                args = {"rid": req.rid, "slot": req.slot,
                        "n_ctx": req.n_ctx,
                        "preemptions": req.preemptions + 1}
                if snap:
                    args["snapshot"] = True
                tr.event("sched.preempt", "sched", ts=now, args=args)
        if self.pool is not None:
            self.pool.evict(req.rid)
        if self.state_pool is not None:
            self.state_pool.evict(req.rid)
        self.slots[req.slot] = None
        req.slot = None
        req.state = RequestState.WAITING
        req.n_prefilled = 0
        req.n_ctx = 0
        req.preemptions += 1
        self._enqueue(req)

    def finish(self, req: Request, now: float) -> None:
        if self.pool is not None:
            self.pool.free_seq(req.rid)
        if self.state_pool is not None:
            self.state_pool.free_seq(req.rid)
        req.snapshot = None
        self.slots[req.slot] = None
        req.slot = None
        req.state = RequestState.DONE
        req.t_done = now
        self.done.append(req)
        tr = self.tracer
        if tr is not None:
            # the timeline's done mark reuses the SAME clock value as
            # req.t_done, so trace-derived TPOT/e2e reproduce the legacy
            # report's request-timestamp math exactly
            tr.req_done(req.rid, now, req.n_generated)
            if tr.enabled:
                tr.event("sched.finish", "sched", ts=now, args={
                    "rid": req.rid, "n_generated": req.n_generated})
