"""Continuous-batching step loop over the paged int8-KV block pool
(PyTorch counterpart of ``repro.serving.engine`` for the attention
substrate).

By default (``ragged=True``) every engine step flattens the whole mixed
work-list — prefill chunks under the shared token budget, one decode row
per decoding request, and its speculative tail when drafting is on — into
a single (T,) token stream with per-sequence descriptors, and serves it
with one ``models.model.ragged_step`` (one ragged attention launch, K1,
per layer) followed by on-device sampling and draft verification; only
the sampled tokens cross to the host.  Padded stream lengths are powers
of two from 8 up to the step's worst case, so step shapes stay O(few).

``ragged=False`` keeps the legacy per-shape dispatch trio, each step a
``models.model.paged_step`` (one paged attention launch, K4, per layer):

* chunked prefill: (1, C) for C in the scheduler's bucket set;
* decode: (n_slots, 1), every live slot at its own position;
* speculative verify: (n_slots, K+1) when drafting is on and some slot
  drafted — only accepted tokens commit, the rejected tail retracts.

The host-side pool, prefix cache and scheduler are the JAX package's
numpy modules, copied unchanged.  The device pool is updated in place:
the scatter writes each token's codes into its row and copy-on-write
duplicates one block's rows, where the JAX engine donates the buffer.

Not ported yet, and raising ``NotImplementedError``: the recurrent /
hybrid substrates and the observability options (``trace``, ``record``,
``slo``); the report carries no requant or energy counters.
"""
from __future__ import annotations

import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.qmodel import QuantContext
from repro_torch.kernels import ops as kops
from repro_torch.kernels.flash_attention import plan_paged_work
from repro_torch.kernels.ragged_flash import plan_ragged_work
from repro_torch.launch.steps import build_paged_step, check_matmul_kernel
from repro_torch.models import model as M
from repro_torch.models.attention import RaggedBatch
from repro_torch.serving.kv_pool import TRASH_BLOCK, BlockPool
from repro_torch.serving.scheduler import (Request, RequestState, Scheduler,
                                           chunk_bucket)
from repro_torch.serving.spec import (apply_top_k, resolve_drafter,
                                      verify_tokens)
from repro_torch.serving.substrate import substrate_for

__all__ = ["ServingEngine", "sample_tokens", "summarize_step_times"]


def sample_tokens(logits: torch.Tensor, generator: torch.Generator,
                  temperatures: torch.Tensor,
                  top_k: Optional[torch.Tensor] = None,
                  k_cap: Optional[int] = None) -> torch.Tensor:
    """Greedy + temperature/top-k sampling of logits (B, V): a row with
    temperature 0 takes its argmax (first index among ties), others draw
    from the temperature-scaled, top-k masked distribution."""
    logits = logits.to(torch.float32)
    greedy = torch.argmax(logits, dim=-1)
    if top_k is not None:
        logits = apply_top_k(logits, top_k, k_cap)
    scaled = logits / torch.clamp(temperatures, min=1e-6)[:, None]
    sampled = torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                                generator=generator)[:, 0]
    return torch.where(temperatures > 0, sampled, greedy).to(torch.int32)


def _pct(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else None


def summarize_step_times(step_times: dict) -> dict:
    """Per-shape first-call vs steady step time, keyed by the dispatched
    shape: ragged work-lists ``("ragged", T_pad, S_pad)`` as
    ``ragged_{T}xS{S}`` at the top level, the legacy per-shape steps'
    ``(B, C)`` as ``BxC`` under ``legacy_shapes``.  ``p99_s`` needs at
    least two steady samples."""
    shapes: dict = {}
    legacy: dict = {}
    for shape, ts in sorted(step_times.items(), key=lambda kv: str(kv[0])):
        steady_ts = ts[1:]
        steady = float(np.median(steady_ts)) if steady_ts else None
        p99 = _pct(steady_ts, 99) if len(steady_ts) >= 2 else None
        entry = {"calls": len(ts),
                 "first_s": round(ts[0], 4) if ts else None,
                 "steady_s": round(steady, 4) if steady is not None else None,
                 "p99_s": round(p99, 4) if p99 is not None else None}
        if shape[0] == "ragged":
            shapes[f"ragged_{shape[1]}xS{shape[2]}"] = entry
        else:
            legacy["x".join(map(str, shape))] = entry
    if legacy:
        shapes["legacy_shapes"] = legacy
    return shapes


def _unported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported to repro_torch yet "
                              f"(ROADMAP Queue 1 item {item})")


class ServingEngine:
    """Continuous-batching serving engine: the unified ragged step, or the
    legacy per-shape trio with ``ragged=False``."""

    def __init__(self, cfg: ModelConfig, params: Any, ctx: QuantContext, *,
                 n_slots: int = 4, block_size: int = 16,
                 max_model_len: int = 128,
                 num_blocks: Optional[int] = None, chunk: int = 16,
                 prefill_token_budget: Optional[int] = None,
                 top_k: int = 0, seed: int = 0,
                 prefix_cache: Optional[bool] = None, spec_k: int = 0,
                 drafter="ngram", ragged: bool = True, trace: bool = False,
                 record: bool = False, slo=None, device=None):
        sub = substrate_for(cfg)
        if sub.kind != "attention":
            _unported(f"the {sub.kind} substrate", "9")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if trace or record or slo is not None:
            _unported("tracing, the flight recorder and SLO monitoring", "6")
        check_matmul_kernel(cfg, ctx)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.ctx = ctx
        self.n_slots = n_slots
        self.max_model_len = max_model_len
        if prefix_cache is None:
            prefix_cache = sub.supports_prefix_cache
        nbmax = -(-max_model_len // block_size)
        if num_blocks is None:
            # full residency; callers undersize this to force preemption
            num_blocks = 1 + n_slots * nbmax
        scale_exp = cfg.kv_cache_frac_bits if cfg.kv_cache_bits == 8 else 0
        self.pool = BlockPool(num_blocks, block_size, scale_exp=scale_exp,
                              prefix_cache=prefix_cache)
        self.sched = Scheduler(self.pool, n_slots=n_slots, chunk=chunk,
                               max_model_len=max_model_len,
                               prefill_token_budget=prefill_token_budget,
                               substrate=sub)
        self.cache = M.init_paged_cache(cfg, num_blocks, block_size,
                                        device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.default_top_k = top_k
        self.spec_k = spec_k
        self.drafter = resolve_drafter(drafter)
        self.ragged = ragged
        self._paged_fn = build_paged_step(cfg, ctx)
        budget = self.sched.prefill_token_budget
        # worst-case stream: the full prefill budget plus every slot
        # verifying a K-token tail
        self._t_max = max(8, -(-(budget + n_slots * (spec_k + 1)) // 8) * 8)
        self.ragged_steps = 0
        self.decode_steps = 0
        self.prefill_chunks = 0
        self.spec_steps = 0
        self.spec_slot_steps = 0    # (live slot, verify step) pairs
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_emitted = 0
        self.dispatched_tokens = 0
        self.padded_tokens = 0
        self.cache_hit_prefill_tokens = 0
        # the kernels this engine's steps launch: K2 per INT projection,
        # and per layer K1 (ragged step) or K4 (legacy per-shape steps)
        attn = "ragged_attention" if self.ragged else "paged_attention"
        self.launches = {"int8_matmul": 0, attn: 0}
        self._step_times: dict[tuple, list] = {}
        self._t0 = time.perf_counter()
        self._skip = 0.0
        self._wall_s = 0.0

    # -- clock ------------------------------------------------------------

    def _now(self) -> float:
        """Engine clock: monotonic seconds minus fast-forwarded idle gaps."""
        return time.perf_counter() - self._t0 + self._skip

    # -- public API -------------------------------------------------------

    def submit(self, req: Request) -> None:
        self.sched.submit(req)

    def run(self, requests: list[Request]) -> dict:
        """Serve ``requests`` (arrival-stamped) to completion; idle gaps
        between arrivals are fast-forwarded on the engine clock."""
        pending = sorted(requests, key=lambda r: (r.arrival, r.rid))
        start = dict(kops.LAUNCHES)
        self._t0, self._skip = time.perf_counter(), 0.0
        while pending or not self.sched.idle:
            now = self._now()
            if self.sched.idle and pending and pending[0].arrival > now:
                self._skip += pending[0].arrival - now
                now = self._now()
            while pending and pending[0].arrival <= now:
                self.submit(pending.pop(0))
            self.step()
        self._wall_s = self._now()
        for name in self.launches:
            self.launches[name] += kops.LAUNCHES[name] - start[name]
        return self.report()

    def step(self) -> None:
        """One engine iteration.  Ragged (default): admit, then ONE unified
        dispatch over the mixed work-list.  Legacy (``ragged=False``):
        admit, chunked prefill, then decode (a speculative verify step
        when drafting is on and produced drafts, else the plain (B, 1)
        decode)."""
        for req in self.sched.admit(self._now()):
            # cached-prefix hit: those tokens' KV is already resident
            self.cache_hit_prefill_tokens += req.n_prefilled
        if self.ragged:
            self._run_ragged_step()
        else:
            self._run_prefills()
            if not (self.spec_k and self._run_spec_decode()):
                self._run_decode()

    # -- unified ragged step ----------------------------------------------

    def _t_bucket(self, n: int) -> int:
        """Padded stream length: smallest power of two >= n (at least 8),
        capped at the step's worst case."""
        b = 8
        while b < n:
            b <<= 1
        return min(b, self._t_max)

    def _run_ragged_step(self) -> None:
        """Plan the mixed work-list, then serve it in ONE dispatch.

        Every PREFILL job contributes one chunk under the shared token
        budget (copy-on-write protected), every DECODE request its fed
        token plus a speculative tail when drafting is on (pool growth
        degrades the tail before preempting peers, as the legacy verify
        step does).  Growth/CoW for a later request may preempt an earlier
        one, so planned items are re-validated before the arrays are
        built."""
        now = self._now()
        budget = self.sched.prefill_token_budget
        prefill_items = []                  # (req, start, c_real)
        for req in self.sched.prefill_jobs():
            if budget <= 0:
                break
            start = req.n_prefilled
            c_real = min(self.sched.chunk, len(req.feed) - start, budget)
            if not self._cow_for_range(req, start, start + c_real):
                continue                    # req itself was preempted
            budget -= c_real
            prefill_items.append((req, start, c_real))

        proposals = self._draft_proposals() if self.spec_k else {}
        has_spec = any(len(d) for d in proposals.values())
        plans: dict[int, np.ndarray] = {}
        for req in list(self.sched.decode_reqs()):
            if req.slot is None or req.state is not RequestState.DECODE:
                continue
            drafts = proposals.get(req.rid, np.empty(0, np.int32))
            if has_spec:
                drafts = self._grant_spec(req, drafts, now)
                if drafts is None:
                    continue                # req itself was preempted
            elif not self.sched.grow_for_decode(req, now):
                continue                    # req itself was preempted
            plans[req.rid] = drafts

        prefill_items = [
            (r, s, c) for (r, s, c) in prefill_items
            if r.slot is not None and r.state is RequestState.PREFILL
            and r.n_prefilled == s]
        decode_items = [(r, plans[r.rid]) for r in self.sched.decode_reqs()
                        if r.rid in plans]
        if not prefill_items and not decode_items:
            return

        # -- build the flattened stream + descriptors ---------------------
        bs = self.pool.block_size
        nbmax = self.sched.nbmax
        s_pad = self.n_slots
        t_real = sum(c for (_, _, c) in prefill_items) \
            + sum(1 + len(d) for (_, d) in decode_items)
        t_pad = self._t_bucket(t_real)
        tokens = np.zeros(t_pad, np.int32)
        positions = np.zeros(t_pad, np.int32)
        dest = np.zeros(t_pad, np.int32)    # padding rows scatter to trash
        q_start = np.full(s_pad, t_pad, np.int32)
        q_len = np.zeros(s_pad, np.int32)
        kv_len = np.zeros(s_pad, np.int32)
        bt = np.full((s_pad, nbmax), TRASH_BLOCK, np.int32)
        temps = np.zeros(s_pad, np.float32)
        topks = np.zeros(s_pad, np.int32)
        sample_start = np.zeros(s_pad, np.int32)
        n_drafts = np.zeros(s_pad, np.int32)
        fed: list[np.ndarray] = []
        off = 0
        work = [(r, (s, c)) for (r, s, c) in prefill_items] \
            + [(r, d) for (r, d) in decode_items]
        for i, (req, item) in enumerate(work):
            if i < len(prefill_items):
                start, c_real = item
                toks_i = np.asarray(req.feed[start:start + c_real], np.int32)
                pos_i = start + np.arange(c_real, dtype=np.int32)
                sample_start[i] = off + c_real - 1     # last real row
            else:
                toks_i = np.concatenate(
                    [[req.generated[-1]], item]).astype(np.int32)
                pos_i = req.n_ctx + np.arange(len(toks_i), dtype=np.int32)
                sample_start[i] = off                  # fed-token row
                n_drafts[i] = len(item)
            n = len(toks_i)
            row = self.pool.table_row(req.rid, nbmax)
            tokens[off:off + n] = toks_i
            positions[off:off + n] = pos_i
            dest[off:off + n] = row[pos_i // bs] * bs + pos_i % bs
            q_start[i] = off
            q_len[i] = n
            kv_len[i] = int(pos_i[-1]) + 1
            bt[i] = row
            temps[i] = req.temperature
            topks[i] = self._req_top_k(req)
            fed.append(toks_i)
            off += n
        out, n_acc = self._dispatch_ragged(tokens, positions, dest, bt,
                                           q_start, q_len, kv_len, temps,
                                           topks, sample_start, n_drafts)
        self.ragged_steps += 1
        self.dispatched_tokens += t_pad
        self.padded_tokens += t_pad - t_real
        now = self._now()

        for i, (req, start, c_real) in enumerate(prefill_items):
            self._prefill_done(req, start, c_real, int(out[i, 0]), now)

        if decode_items:
            if has_spec:
                self.spec_steps += 1
                self.spec_slot_steps += len(decode_items)
            else:
                self.decode_steps += 1
        for j, (req, d) in enumerate(decode_items):
            i = len(prefill_items) + j
            if has_spec:
                self._commit_spec(req, int(fed[i][0]), d, out[i],
                                  int(n_acc[i]), now)
            else:
                self._commit_decode(req, int(fed[i][0]), int(out[i, 0]), now)

    def _dispatch_ragged(self, tokens, positions, dest, bt, q_start, q_len,
                         kv_len, temps, topks, sample_start, n_drafts):
        """One unified step + on-device sampling and draft verification +
        the host sync, timed under the work-list shape key
        ``("ragged", T_pad, S_pad)``.  Every sequence gathers K+1 logit
        rows from its ``sample_start``; a prefill or decode row rides with
        ``n_drafts == 0``, which is plain sampling of its row.  Returns
        (out (S, K+1), n_accepted (S,)) on the host."""
        t0 = time.perf_counter()
        put = self._put
        # K1's work list, planned once from the host descriptors for every
        # layer (the plain CPU path needs none)
        work = (plan_ragged_work(q_start, q_len, kv_len,
                                 groups=self.cfg.n_heads // self.cfg.n_kv_heads
                                 ).to(self.device)
                if self._plans_work() else None)
        rb = RaggedBatch(dest=put(dest), block_tables=put(bt),
                         q_start=put(q_start), q_len=put(q_len),
                         kv_len=put(kv_len), work=work)
        tok_t = put(tokens)
        logits, self.cache = M.ragged_step(self.params, tok_t, self.cache,
                                           put(positions), rb, self.cfg,
                                           self.ctx)
        t = logits.shape[0]
        kp1 = self.spec_k + 1
        idx = torch.clamp(put(sample_start).long()[:, None]
                          + torch.arange(kp1, device=self.device)[None, :],
                          0, t - 1)
        out, n_acc = self._verify(logits[idx], tok_t[idx], n_drafts, temps,
                                  topks)
        self._step_times.setdefault(("ragged", len(tokens), len(temps)),
                                    []).append(time.perf_counter() - t0)
        return out, n_acc

    def _verify(self, logits, tokens, n_drafts, temps, topks):
        """On-device sampling / draft verification of (B, K+1, V) logits
        fed by ``tokens`` (B, K+1), then the host sync."""
        put = self._put
        cap = int(topks.max()) if topks.any() else None
        topks_arg = put(topks) if topks.any() else None
        out, n_acc = verify_tokens(logits, tokens, put(n_drafts),
                                   self.generator, put(temps), topks_arg,
                                   k_cap=cap)
        return out.cpu().numpy(), n_acc.cpu().numpy()      # host sync

    def _put(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _plans_work(self) -> bool:
        """Whether a step plans its attention kernel's work list on the
        host: on the card; the plain CPU path takes none."""
        return self.device.type == "cuda"

    # -- legacy per-shape steps (ragged=False) ---------------------------

    def _dispatch(self, tokens, positions, bt, temps, topks, *,
                  last_idx: int = 0, n_drafts=None):
        """One legacy step: ``paged_step`` at (B, C), then on-device
        sampling and the host sync, timed under the shape key (B, C).
        Without ``n_drafts`` each slot samples its row ``last_idx`` (the
        decode and prefill steps); with them the whole (B, C) chunk is a
        speculative verify.  Returns (out (B, K+1), n_accepted (B,))."""
        t0 = time.perf_counter()
        # K4's work list, planned once from the host positions for every
        # layer
        work = (plan_paged_work(positions, table_width=bt.shape[1],
                                block_size=self.pool.block_size,
                                groups=self.cfg.n_heads // self.cfg.n_kv_heads
                                ).to(self.device)
                if self._plans_work() else None)
        tok_t = self._put(tokens)
        logits, self.cache = self._paged_fn(self.params, tok_t, self.cache,
                                            self._put(positions),
                                            self._put(bt), work=work)
        if n_drafts is None:
            logits = logits[:, last_idx:last_idx + 1]
            tok_t = tok_t[:, last_idx:last_idx + 1]
            n_drafts = np.zeros(len(tokens), np.int32)
        out, n_acc = self._verify(logits, tok_t, n_drafts, temps, topks)
        self._step_times.setdefault(tuple(tokens.shape), []).append(
            time.perf_counter() - t0)
        return out, n_acc

    def _run_prefills(self) -> None:
        # one shared token budget per engine step
        budget = self.sched.prefill_token_budget
        for req in self.sched.prefill_jobs():
            zero_streak = 0
            while budget > 0 and req.state is RequestState.PREFILL:
                fed = self._prefill_chunk(req, budget)
                budget -= fed
                # the only legitimate zero-token return is the CoW-failure
                # path, whose preemption flips req.state and ends the loop
                zero_streak = zero_streak + 1 if fed == 0 else 0
                if zero_streak >= 2:
                    raise RuntimeError(
                        f"prefill of request {req.rid} made no progress "
                        f"twice in a row (state {req.state}, "
                        f"{req.n_prefilled}/{len(req.feed)} fed, budget "
                        f"{budget}) — zero-progress CoW retry without "
                        f"preemption")

    def _prefill_chunk(self, req: Request, budget: int) -> int:
        start = req.n_prefilled
        c_real = min(self.sched.chunk, len(req.feed) - start, budget)
        if not self._cow_for_range(req, start, start + c_real):
            return 0                        # req itself was preempted
        c_pad = chunk_bucket(c_real, self.sched.chunk)
        cap = self.max_model_len - start
        if c_pad > cap:
            # near the end of the table the padded tail could land past
            # max_model_len: shrink to the largest power of two that fits
            c_pad = 1 << (cap.bit_length() - 1)
            c_real = min(c_real, c_pad)
        tokens = np.zeros((1, c_pad), np.int32)
        tokens[0, :c_real] = req.feed[start:start + c_real]
        positions = (start + np.arange(c_pad, dtype=np.int32))[None]
        bt = self.pool.table_row(req.rid, self.sched.nbmax)[None]
        out, _ = self._dispatch(tokens, positions, bt,
                                np.asarray([req.temperature], np.float32),
                                np.asarray([self._req_top_k(req)], np.int32),
                                last_idx=c_real - 1)
        self.dispatched_tokens += c_pad
        self.padded_tokens += c_pad - c_real
        self._prefill_done(req, start, c_real, int(out[0, 0]), self._now())
        return c_real

    def _run_decode(self) -> None:
        now = self._now()
        for req in list(self.sched.decode_reqs()):
            if req.slot is not None and req.state is RequestState.DECODE:
                self.sched.grow_for_decode(req, now)
        reqs = self.sched.decode_reqs()
        if not reqs:
            return
        tokens = np.zeros((self.n_slots, 1), np.int32)
        positions = np.zeros((self.n_slots, 1), np.int32)
        bt = np.full((self.n_slots, self.sched.nbmax), TRASH_BLOCK, np.int32)
        temps = np.zeros((self.n_slots,), np.float32)
        topks = np.zeros((self.n_slots,), np.int32)
        for req in reqs:
            s = req.slot
            tokens[s, 0] = req.generated[-1]
            positions[s, 0] = req.n_ctx
            bt[s] = self.pool.table_row(req.rid, self.sched.nbmax)
            temps[s] = req.temperature
            topks[s] = self._req_top_k(req)
        out, _ = self._dispatch(tokens, positions, bt, temps, topks)
        self.dispatched_tokens += self.n_slots
        self.padded_tokens += self.n_slots - len(reqs)
        self.decode_steps += 1
        now = self._now()
        for req in reqs:
            self._commit_decode(req, int(tokens[req.slot, 0]),
                                int(out[req.slot, 0]), now)

    # -- speculative decoding ---------------------------------------------

    def _spec_budget(self, req: Request) -> int:
        """Tokens worth drafting for ``req`` this step: a verify step
        emits at least one token, so drafting past the request's remaining
        generation (or the model length) only writes rows never kept."""
        return max(0, min(self.spec_k,
                          req.max_new_tokens - req.n_generated - 1,
                          self.max_model_len - 1 - req.n_ctx))

    def _draft_proposals(self) -> dict[int, np.ndarray]:
        proposals = {}
        for req in self.sched.decode_reqs():
            budget = self._spec_budget(req)
            if budget > 0:
                d = np.asarray(self.drafter.draft(
                    np.concatenate([req.prompt, np.asarray(
                        req.generated, np.int32)]), budget), np.int32)
                proposals[req.rid] = d[:budget]
        return proposals

    def _grant_spec(self, req: Request, drafts: np.ndarray,
                    now: float) -> Optional[np.ndarray]:
        """Grow the pool for the fed token plus ``drafts`` (the tail
        degrades under pool pressure before peers are preempted) and
        copy-on-write any shared block the tail would write.  Returns the
        granted drafts, or None when ``req`` itself was preempted."""
        granted = self.sched.grow_for_spec(req, now, len(drafts))
        if granted is None:
            return None
        drafts = drafts[:granted]
        if not self._cow_for_range(req, req.n_ctx,
                                   req.n_ctx + 1 + len(drafts)):
            return None
        return drafts

    def _run_spec_decode(self) -> bool:
        """One speculative verify step at (n_slots, K+1): draft, grow and
        COW for the tails, verify every slot in one dispatch, then commit
        only accepted tokens and retract the rejected tail.  Returns False
        when no slot drafted (the caller runs the plain decode)."""
        now = self._now()
        proposals = self._draft_proposals()
        if not any(len(d) for d in proposals.values()):
            return False
        plans: dict[int, np.ndarray] = {}
        for req in list(self.sched.decode_reqs()):
            if req.slot is None or req.state is not RequestState.DECODE:
                continue
            drafts = self._grant_spec(
                req, proposals.get(req.rid, np.empty(0, np.int32)), now)
            if drafts is not None:
                plans[req.rid] = drafts
        # growth/COW for a later slot may have preempted an earlier one
        reqs = [r for r in self.sched.decode_reqs() if r.rid in plans]
        if not reqs:
            return bool(plans)

        kp1 = self.spec_k + 1
        bs = self.pool.block_size
        nbmax = self.sched.nbmax
        # one guaranteed-TRASH table column past nbmax: padded draft
        # positions point there, so their writes land in the trash block
        # even for a full-length sequence
        pad_pos = nbmax * bs
        tokens = np.zeros((self.n_slots, kp1), np.int32)
        positions = np.full((self.n_slots, kp1), pad_pos, np.int32)
        bt = np.full((self.n_slots, nbmax + 1), TRASH_BLOCK, np.int32)
        temps = np.zeros((self.n_slots,), np.float32)
        topks = np.zeros((self.n_slots,), np.int32)
        n_drafts = np.zeros((self.n_slots,), np.int32)
        for req in reqs:
            s, d = req.slot, plans[req.rid]
            tokens[s, 0] = req.generated[-1]
            tokens[s, 1:1 + len(d)] = d
            positions[s, :1 + len(d)] = req.n_ctx + np.arange(
                1 + len(d), dtype=np.int32)
            bt[s, :nbmax] = self.pool.table_row(req.rid, nbmax)
            temps[s] = req.temperature
            topks[s] = self._req_top_k(req)
            n_drafts[s] = len(d)
        n_real = sum(1 + len(plans[r.rid]) for r in reqs)
        out, n_acc = self._dispatch(tokens, positions, bt, temps, topks,
                                    n_drafts=n_drafts)
        self.dispatched_tokens += self.n_slots * kp1
        self.padded_tokens += self.n_slots * kp1 - n_real
        self.spec_steps += 1
        self.spec_slot_steps += len(reqs)
        now = self._now()
        for req in reqs:
            s = req.slot
            self._commit_spec(req, int(tokens[s, 0]), plans[req.rid], out[s],
                              int(n_acc[s]), now)
        return True

    # -- commit points shared by both paths -------------------------------

    def _prefill_done(self, req: Request, start: int, c_real: int, tok: int,
                      now: float) -> None:
        """A prefill chunk's rows are resident: commit them, and when the
        prompt is complete the token sampled from its last row is the
        first generated token."""
        req.n_prefilled += c_real
        req.n_ctx = req.n_prefilled
        self.pool.commit(req.rid, start, req.feed[start:start + c_real])
        self.prefill_chunks += 1
        if req.n_prefilled == len(req.feed):
            if req.t_first is None:
                req.t_first = now
            done = req.finished_by(tok, self.max_model_len)
            req.generated.append(tok)
            if done:
                self.sched.finish(req, now)
            else:
                req.state = RequestState.DECODE

    def _commit_decode(self, req: Request, fed_tok: int, tok: int,
                       now: float) -> None:
        self.pool.commit(req.rid, req.n_ctx, [fed_tok])
        req.n_ctx += 1
        done = req.finished_by(tok, self.max_model_len)
        req.generated.append(tok)
        if done:
            self.sched.finish(req, now)

    def _commit_spec(self, req: Request, fed_tok: int, d: np.ndarray,
                     out_row: np.ndarray, acc: int, now: float) -> None:
        """Emit the accepted drafts and the correction / bonus token
        (stopping at a finishing token), commit ONLY the fed token and the
        kept draft prefix, and retract the rejected tail's blocks."""
        kept_drafts = 0
        done = False
        for k, tok in enumerate(out_row[:acc + 1].tolist()):
            done = req.finished_by(int(tok), self.max_model_len)
            req.generated.append(int(tok))
            self.spec_emitted += 1
            if k < acc:
                kept_drafts += 1        # this draft's KV row is resident
            if done:
                break
        self.pool.commit(req.rid, req.n_ctx,
                         [fed_tok] + d[:kept_drafts].tolist())
        self.spec_drafted += len(d)
        self.spec_accepted += acc
        req.n_ctx += 1 + kept_drafts
        if done:
            self.sched.finish(req, now)
        else:
            self.pool.retract(req.rid, req.n_ctx)

    # -- shared step plumbing --------------------------------------------

    def _cow_for_range(self, req: Request, start: int, end: int) -> bool:
        """Copy-on-write every SHARED block overlapping feed positions
        [start, end) so the chunk's KV scatter only touches private
        blocks: the pool moves the map, and block ``src``'s rows (all
        layers, K and V) are copied into ``dst`` in place on the device.
        Returns False iff ``req`` itself was preempted."""
        bs = self.pool.block_size
        for idx in range(start // bs, -(-end // bs)):
            if idx >= self.pool.n_blocks_of(req.rid):
                break                       # rows beyond the table: extend
            if self.pool.block_writable(req.rid, idx):
                continue
            pair = self.sched.cow_for_prefill(req, idx, self._now())
            if pair is None:
                return False
            src, dst = pair
            for arr in self.cache["paged_kv"]:
                arr[:, dst] = arr[:, src]
        return True

    def _req_top_k(self, req: Request) -> int:
        return req.top_k if req.top_k > 0 else self.default_top_k

    # -- report -----------------------------------------------------------

    def outputs(self) -> dict[int, np.ndarray]:
        return {r.rid: np.asarray(r.generated, np.int32)
                for r in self.sched.done}

    def report(self) -> dict:
        done = self.sched.done
        wall = self._wall_s or self._now()
        gen = sum(r.n_generated for r in done)
        ttft = [r.t_first - r.arrival for r in done if r.t_first is not None]
        e2e = [r.t_done - r.arrival for r in done if r.t_done is not None]
        tpot = [(r.t_done - r.t_first) / (r.n_generated - 1)
                for r in done if r.n_generated > 1]
        lat = {}
        for name, xs in (("ttft_s", ttft), ("tpot_s", tpot), ("e2e_s", e2e)):
            lat[name] = {"p50": _pct(xs, 50), "p99": _pct(xs, 99)}
        cs = self.pool.cache.stats if self.pool.cache is not None else None
        return {
            "device": str(self.device),
            "completed": len(done),
            "gen_tokens": gen,
            "prompt_tokens": sum(len(r.prompt) for r in done),
            "preemptions": sum(r.preemptions for r in done),
            "wall_s": round(wall, 4),
            "tokens_per_s": round(gen / wall, 2) if wall else None,
            **lat,
            "ragged": self.ragged,
            "ragged_steps": self.ragged_steps,
            "decode_steps": self.decode_steps,
            "spec_steps": self.spec_steps,
            "prefill_chunks": self.prefill_chunks,
            "dispatched_tokens": self.dispatched_tokens,
            "padded_tokens": self.padded_tokens,
            "padding_frac": (round(self.padded_tokens
                                   / self.dispatched_tokens, 4)
                             if self.dispatched_tokens else None),
            "speculative": self._spec_report() if self.spec_k else None,
            "step_shapes": summarize_step_times(self._step_times),
            "kernel_launches": dict(self.launches),
            "prefix_cache": None if cs is None else {
                "hits": cs.hits, "misses": cs.misses,
                "cached_prefill_tokens": self.cache_hit_prefill_tokens,
                "cow_copies": cs.cow_copies},
        }

    def _spec_report(self) -> dict:
        return {
            "spec_k": self.spec_k,
            "drafter": type(self.drafter).__name__,
            "verify_steps": self.spec_steps,
            "fallback_decode_steps": self.decode_steps,
            "drafted_tokens": self.spec_drafted,
            "accepted_tokens": self.spec_accepted,
            "acceptance_rate": (round(self.spec_accepted / self.spec_drafted,
                                      4) if self.spec_drafted else None),
            "emitted_tokens": self.spec_emitted,
            "tokens_per_step": (round(self.spec_emitted
                                      / self.spec_slot_steps, 4)
                                if self.spec_slot_steps else None),
            "retracts": self.pool.stats.retracts,
            "retracted_blocks": self.pool.stats.retracted_blocks,
        }
