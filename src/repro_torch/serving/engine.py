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

Observability (``repro_torch.obs``) is the reference's: one tracer
threaded through the pool, the prefix cache and the scheduler (ring
events with ``trace=True``; per-request timelines always), one dispatch
span per dispatch closed where the step already waits for its sampled
tokens, the flight recorder's virtual clock (``record=True``), an SLO
monitor (``slo``), ``torch.profiler`` capture (``profile_dir``), and the
paper's Table-5 requant and energy counters charged at the reference's
commit points.  ``report()`` is the nested view of the metrics registry
and passes the reference's golden schema (``obs.schema``), plus the
port's ``device`` and ``kernel_launches``.  None of it changes a token,
a launch or a scheduling decision.

Not ported yet, and raising ``NotImplementedError``: the recurrent /
hybrid substrates, and ``profile_cost`` (XLA's cost analysis).
"""
from __future__ import annotations

import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import hwcost
from repro_torch.core.device import resolve_device
from repro_torch.core.qmodel import QuantContext
from repro_torch.kernels import ops as kops
from repro_torch.kernels.flash_attention import plan_paged_work
from repro_torch.kernels.ragged_flash import plan_ragged_work
from repro_torch.launch.steps import build_paged_step, check_matmul_kernel
from repro_torch.models import model as M
from repro_torch.models.attention import RaggedBatch
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.profile import EnergyAccount, Profiler
from repro_torch.obs.slo import SLOMonitor, default_slos
from repro_torch.obs.trace import Tracer
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
                 drafter="ngram", ragged: bool = True,
                 trace: bool = False, trace_capacity: int = 65536,
                 profile_dir: Optional[str] = None,
                 profile_cost: bool = False,
                 record: bool = False, virtual_dt: float = 1e-3,
                 slo=None, device=None):
        sub = substrate_for(cfg)
        if sub.kind != "attention":
            _unported(f"the {sub.kind} substrate",
                      "5, 'Recurrent and hybrid substrate'")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if virtual_dt <= 0.0:
            raise ValueError(f"virtual_dt must be > 0, got {virtual_dt}")
        check_matmul_kernel(cfg, ctx)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.ctx = ctx
        self.substrate = sub
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
        self._t0 = time.perf_counter()
        self._skip = 0.0
        self._wall_s = 0.0
        # observability: one tracer threaded through every serving-path
        # module.  Ring events are off unless ``trace=True``; per-request
        # timelines are always on (the report's timeline section).
        self.tracer = Tracer(capacity=trace_capacity, clock=self._now,
                             enabled=trace)
        self.pool.tracer = self.tracer
        if self.pool.cache is not None:
            self.pool.cache.tracer = self.tracer
        self.sched.tracer = self.tracer
        # flight recorder: record mode runs on a deterministic VIRTUAL
        # clock (virtual_dt seconds a step, idle gaps jump to the next
        # arrival) and tees the scheduler-decision events into an
        # unbounded sink; tracing is forced on (the decision call sites
        # are ring-gated)
        self.record = record
        self.virtual_dt = virtual_dt
        self._virtual_time: Optional[float] = 0.0 if record else None
        if record:
            self.tracer.enabled = True
            self.tracer.decision_sink = []
        # SLO burn-rate monitor, evaluated once a step on the engine clock
        # (``slo=True``: the stock objectives; or a list of SLObjective)
        if slo is None:
            self.slo: Optional[SLOMonitor] = None
        else:
            objectives = default_slos() if slo is True else slo
            self.slo = SLOMonitor(objectives, tracer=self.tracer,
                                  value_fn=self._metric_value)
        self.profiler = Profiler(profile_dir=profile_dir, cost=profile_cost,
                                 device_type=self.device.type)
        # live Table-5 energy proxy, split prefill / decode / spec_wasted;
        # reconciles exactly with the requant counters below
        self.energy = EnergyAccount("bit_shifting")
        self.cache = M.init_paged_cache(cfg, num_blocks, block_size,
                                        device=self.device)
        self.seed = seed
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
        self._step_counter = 0
        # one requant op per KV element written (the paper's Table-5
        # unit): every layer writes K and V for each token
        self._elems_per_token = (cfg.n_layers * cfg.n_kv_heads
                                 * cfg.resolved_head_dim * 2)
        # W8A8 forward accounting: per-token dynamic quant ops at every
        # module boundary, only under matmul_kernel='int8'; kept apart
        # from the KV counters so those compare across runs
        self._fwd_elems_per_token = (
            hwcost.forward_quant_ops_per_token(cfg)
            if cfg.matmul_kernel == "int8" else 0)
        self._zero_counters()
        # the kernels this engine's steps launch: K2 per INT projection,
        # and per layer K1 (ragged step) or K4 (legacy per-shape steps)
        attn = "ragged_attention" if self.ragged else "paged_attention"
        self.launches = {"int8_matmul": 0, attn: 0}
        self._step_times: dict[tuple, list] = {}
        # the registry is the single source of report naming and typing:
        # report() is its nested view
        self.metrics = MetricsRegistry()
        self._register_metrics()

    def _zero_counters(self) -> None:
        self.requant_ops_performed = 0
        # the dataflow the int8-resident pool deletes: dequantizing each
        # slot's whole live cache before attending, every step
        self.requant_ops_avoided = 0
        # ops the PREFIX CACHE deleted: cached-prefix tokens are never
        # quantized for the hitting request
        self.requant_ops_avoided_cache = 0
        # ops SPENT on rejected drafts: performed, then rolled back
        self.requant_ops_wasted_spec = 0
        self.requant_ops_forward = 0
        self.requant_ops_forward_avoided_cache = 0
        self.requant_ops_forward_wasted_spec = 0
        self.cache_hit_prefill_tokens = 0
        self.ragged_steps = 0
        self.recurrent_steps = 0
        self.decode_steps = 0
        self.prefill_chunks = 0
        self.spec_steps = 0
        self.spec_slot_steps = 0    # (live slot, verify step) pairs
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_emitted = 0
        self.dispatched_tokens = 0
        self.padded_tokens = 0

    # -- clock ------------------------------------------------------------

    def _now(self) -> float:
        """Engine clock, seconds: monotonic minus fast-forwarded idle gaps,
        or the deterministic virtual clock under ``record=True``."""
        if self._virtual_time is not None:
            return self._virtual_time
        return time.perf_counter() - self._t0 + self._skip

    def _metric_value(self, name: str):
        """Registry read for the SLO monitor's gauge objectives."""
        return self.metrics.get_value(name)

    # -- public API -------------------------------------------------------

    def submit(self, req: Request) -> None:
        self.tracer.req_submit(req.rid, req.arrival)
        self.sched.submit(req)

    def workload_record(self, requests: list[Request]):
        """Freeze the last ``record=True`` run into a portable
        :class:`repro_torch.obs.replay.WorkloadRecord`."""
        from repro_torch.obs.replay import capture_workload
        return capture_workload(self, requests)

    def reset_metrics(self, *, flush_cache: bool = True) -> None:
        """Clear accounting between runs on a drained engine.  The
        sampling generator is re-seeded from the engine's seed, so a
        reused engine replays the same random stream; by default the
        prefix cache is flushed too, so every pass starts cold (pass
        ``flush_cache=False`` to keep it warm)."""
        assert self.sched.idle and self.pool.n_live == 0, \
            "reset_metrics on a non-drained engine"
        from repro_torch.serving.kv_pool import PoolStats
        from repro_torch.serving.prefix_cache import CacheStats
        self._step_counter = 0
        self.generator.manual_seed(self.seed)
        self.sched.done.clear()
        self.sched.admission_log.clear()
        if flush_cache:
            self.pool.flush_cache()
        self.pool.reset_free_order()
        self.pool.stats = PoolStats()
        if self.pool.cache is not None:
            self.pool.cache.stats = CacheStats()
        self._zero_counters()
        self.launches = dict.fromkeys(self.launches, 0)
        self._step_times.clear()
        self._wall_s = 0.0
        if self.record:
            self._virtual_time = 0.0
        self.energy.reset()
        self.tracer.reset()          # clears the decision sink too
        if self.slo is not None:
            self.slo.reset()
        self.profiler.reset()
        self.metrics.reset()        # owned metrics only; bound ones follow
        stats = getattr(self.drafter, "stats", None)
        if stats is not None:
            stats.reset()

    def run(self, requests: list[Request]) -> dict:
        """Serve ``requests`` (arrival-stamped) to completion; idle gaps
        between arrivals are fast-forwarded on the engine clock.  Under
        ``record=True`` the loop runs on the virtual clock instead
        (``virtual_dt`` a step), so the run is exactly replayable."""
        pending = sorted(requests, key=lambda r: (r.arrival, r.rid))
        start = dict(kops.LAUNCHES)
        if self.record:
            self._run_virtual(pending)
        else:
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

    def _run_virtual(self, pending: list[Request]) -> None:
        """The record-mode loop: as ``run``'s, but the clock advances
        ``virtual_dt`` a step and jumps to the next arrival when idle."""
        self._virtual_time = 0.0
        while pending or not self.sched.idle:
            now = self._virtual_time
            if self.sched.idle and pending and pending[0].arrival > now:
                self._virtual_time = now = pending[0].arrival
            while pending and pending[0].arrival <= now:
                self.submit(pending.pop(0))
            self.step()
            self._virtual_time += self.virtual_dt
        self._wall_s = self._virtual_time

    def step(self) -> None:
        """One engine iteration.  Ragged (default): admit, then ONE unified
        dispatch over the mixed work-list.  Legacy (``ragged=False``):
        admit, chunked prefill, then decode (a speculative verify step
        when drafting is on and produced drafts, else the plain (B, 1)
        decode)."""
        for req in self.sched.admit(self._now()):
            # cached-prefix hit: those tokens' KV is already resident, so
            # neither their KV quantization nor (W8A8) their forward runs
            self.cache_hit_prefill_tokens += req.n_prefilled
            self.requant_ops_avoided_cache += \
                req.n_prefilled * self._elems_per_token
            self.requant_ops_forward_avoided_cache += \
                req.n_prefilled * self._fwd_elems_per_token
        if self.ragged:
            self._run_ragged_step()
        else:
            self._run_prefills()
            if not (self.spec_k and self._run_spec_decode()):
                self._run_decode()
        if self.slo is not None:
            self.slo.evaluate(self._now())

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
                                           topks, sample_start, n_drafts,
                                           t_real)
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
                         kv_len, temps, topks, sample_start, n_drafts,
                         t_real: int):
        """One unified step + on-device sampling and draft verification +
        the host sync, timed under the work-list shape key
        ``("ragged", T_pad, S_pad)`` and, with tracing on, one
        ``ragged_step`` span (stream shape, real vs padded tokens, first
        call of the shape).  Every sequence gathers K+1 logit rows from
        its ``sample_start``; a prefill or decode row rides with
        ``n_drafts == 0``, which is plain sampling of its row.  Returns
        (out (S, K+1), n_accepted (S,)) on the host."""
        t_start = self._now()
        t0 = time.perf_counter()
        self._step_counter += 1
        shape_key = ("ragged", len(tokens), len(temps))
        first_call = shape_key not in self._step_times
        with self.profiler.step_annotation("ragged_step",
                                           self._step_counter):
            put = self._put
            # K1's work list, planned once from the host descriptors for
            # every layer (the plain CPU path needs none)
            work = (plan_ragged_work(
                q_start, q_len, kv_len,
                groups=self.cfg.n_heads // self.cfg.n_kv_heads
            ).to(self.device) if self._plans_work() else None)
            rb = RaggedBatch(dest=put(dest), block_tables=put(bt),
                             q_start=put(q_start), q_len=put(q_len),
                             kv_len=put(kv_len), work=work)
            tok_t = put(tokens)
            logits, self.cache = M.ragged_step(self.params, tok_t,
                                               self.cache, put(positions),
                                               rb, self.cfg, self.ctx)
            t = logits.shape[0]
            kp1 = self.spec_k + 1
            idx = torch.clamp(
                put(sample_start).long()[:, None]
                + torch.arange(kp1, device=self.device)[None, :], 0, t - 1)
            out, n_acc = self._verify(logits[idx], tok_t[idx], n_drafts,
                                      temps, topks)
        dt = time.perf_counter() - t0
        self._step_times.setdefault(shape_key, []).append(dt)
        tr = self.tracer
        if tr.enabled:
            tr.span("ragged_step", "dispatch", t_start, dt, {
                "shape": f"T{len(tokens)}xS{len(temps)}",
                "real_tokens": t_real,
                "padded_tokens": len(tokens) - t_real,
                "compile": first_call})
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

    def _dispatch(self, tokens, positions, bt, temps, topks, *, name: str,
                  n_real: int, last_idx: int = 0, n_drafts=None):
        """One legacy step: ``paged_step`` at (B, C), then on-device
        sampling and the host sync, timed under the shape key (B, C) and,
        with tracing on, one span ``name`` ('prefill', 'decode' or
        'spec_verify') with ``n_real`` of its B x C tokens real.  Without
        ``n_drafts`` each slot samples its row ``last_idx`` (the decode
        and prefill steps); with them the whole (B, C) chunk is a
        speculative verify.  Returns (out (B, K+1), n_accepted (B,))."""
        t_start = self._now()
        t0 = time.perf_counter()
        self._step_counter += 1
        shape_key = tuple(tokens.shape)
        first_call = shape_key not in self._step_times
        with self.profiler.step_annotation(name, self._step_counter):
            # K4's work list, planned once from the host positions for
            # every layer
            work = (plan_paged_work(
                positions, table_width=bt.shape[1],
                block_size=self.pool.block_size,
                groups=self.cfg.n_heads // self.cfg.n_kv_heads
            ).to(self.device) if self._plans_work() else None)
            tok_t = self._put(tokens)
            logits, self.cache = self._paged_fn(self.params, tok_t,
                                                self.cache,
                                                self._put(positions),
                                                self._put(bt), work=work)
            if n_drafts is None:
                logits = logits[:, last_idx:last_idx + 1]
                tok_t = tok_t[:, last_idx:last_idx + 1]
                n_drafts = np.zeros(len(tokens), np.int32)
            out, n_acc = self._verify(logits, tok_t, n_drafts, temps, topks)
        dt = time.perf_counter() - t0
        self._step_times.setdefault(shape_key, []).append(dt)
        tr = self.tracer
        if tr.enabled:
            n_disp = int(np.prod(tokens.shape))
            tr.span(name, "dispatch", t_start, dt, {
                "shape": "x".join(map(str, tokens.shape)),
                "real_tokens": n_real,
                "padded_tokens": n_disp - n_real,
                "compile": first_call})
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
                                name="prefill", n_real=c_real,
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
        out, _ = self._dispatch(tokens, positions, bt, temps, topks,
                                name="decode", n_real=len(reqs))
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
                                    name="spec_verify", n_real=n_real,
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
        """A prefill chunk's rows are resident: commit them and charge
        their requant ops, and when the prompt is complete the token
        sampled from its last row is the first generated token."""
        req.n_prefilled += c_real
        req.n_ctx = req.n_prefilled
        self.pool.commit(req.rid, start, req.feed[start:start + c_real])
        self.prefill_chunks += 1
        self.requant_ops_performed += c_real * self._elems_per_token
        self.requant_ops_forward += c_real * self._fwd_elems_per_token
        self.energy.charge(
            "prefill",
            c_real * (self._elems_per_token + self._fwd_elems_per_token),
            c_real)
        tr = self.tracer
        if tr.enabled:
            # chunk boundary: part of the scheduler-decision stream the
            # flight recorder diffs between runs
            tr.event("sched.prefill_chunk", "sched", ts=now, args={
                "rid": req.rid, "start": start, "tokens": c_real})
        tr.req_mark(req.rid, "first_chunk", now)
        if req.n_prefilled == len(req.feed):
            if req.t_first is None:
                req.t_first = now
            tr.req_mark(req.rid, "first_token", now)
            tr.req_token(req.rid, now)
            done = req.finished_by(tok, self.max_model_len)
            req.generated.append(tok)
            if done:
                self.sched.finish(req, now)
            else:
                req.state = RequestState.DECODE

    def _commit_decode(self, req: Request, fed_tok: int, tok: int,
                       now: float) -> None:
        self.pool.commit(req.rid, req.n_ctx, [fed_tok])
        self.requant_ops_performed += self._elems_per_token
        self.requant_ops_forward += self._fwd_elems_per_token
        self.energy.charge(
            "decode", self._elems_per_token + self._fwd_elems_per_token, 1)
        req.n_ctx += 1
        # what a dequantize-the-cache-every-step dataflow would pay: the
        # slot's whole live cache, once this step
        self.requant_ops_avoided += req.n_ctx * self._elems_per_token
        done = req.finished_by(tok, self.max_model_len)
        req.generated.append(tok)
        self.tracer.req_token(req.rid, now)
        if done:
            self.sched.finish(req, now)

    def _commit_spec(self, req: Request, fed_tok: int, d: np.ndarray,
                     out_row: np.ndarray, acc: int, now: float) -> None:
        """Emit the accepted drafts and the correction / bonus token
        (stopping at a finishing token), commit ONLY the fed token and the
        kept draft prefix, and retract the rejected tail's blocks.  Every
        fed row was quantized into the pool (and, under W8A8, ran the
        forward): the rejected rows' ops count as performed AND wasted."""
        kept_drafts = 0
        n_out = 0
        done = False
        for k, tok in enumerate(out_row[:acc + 1].tolist()):
            done = req.finished_by(int(tok), self.max_model_len)
            req.generated.append(int(tok))
            self.tracer.req_token(req.rid, now)
            self.spec_emitted += 1
            n_out += 1
            if k < acc:
                kept_drafts += 1        # this draft's KV row is resident
            if done:
                break
        self.pool.commit(req.rid, req.n_ctx,
                         [fed_tok] + d[:kept_drafts].tolist())
        wasted = len(d) - kept_drafts
        kv, fwd = self._elems_per_token, self._fwd_elems_per_token
        self.requant_ops_performed += (1 + len(d)) * kv
        self.requant_ops_wasted_spec += wasted * kv
        self.requant_ops_forward += (1 + len(d)) * fwd
        self.requant_ops_forward_wasted_spec += wasted * fwd
        self.energy.charge("decode", (1 + kept_drafts) * (kv + fwd), n_out)
        self.energy.charge("spec_wasted", wasted * (kv + fwd), wasted)
        self.spec_drafted += len(d)
        self.spec_accepted += acc
        req.n_ctx += 1 + kept_drafts
        if done:
            self.sched.finish(req, now)
        else:
            self.pool.retract(req.rid, req.n_ctx)
        # the dequantize-per-step counterfactual: the slot's whole live
        # cache once per VERIFY step
        self.requant_ops_avoided += req.n_ctx * kv

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

    def _wall(self) -> float:
        return self._wall_s or self._now()

    def _latency_samples(self) -> dict[str, list]:
        """Latency sample lists from the finished requests' timestamps
        (the trace timelines reproduce these exactly)."""
        done = self.sched.done
        return {
            "ttft": [r.t_first - r.arrival for r in done
                     if r.t_first is not None],
            "e2e": [r.t_done - r.arrival for r in done
                    if r.t_done is not None],
            "tpot": [(r.t_done - r.t_first) / (r.n_generated - 1)
                     for r in done if r.n_generated > 1],
        }

    def _register_metrics(self) -> None:
        """Declare every report field on the metrics registry, in report
        order — the reference's registry without the unported
        ``state_pool.*`` section, plus the port's ``device`` and
        ``kernel_launches`` (``obs.schema.PORT_EXTRAS``).  All metrics
        are bound (FuncMetric): the engine's counters, the pool's and
        cache's stats and the request lists stay the source of truth."""
        m = self.metrics
        sched = self.sched
        f = m.func

        def n_requests():
            return len(sched.done) + len(sched.waiting) \
                + len(sched.active())

        def tokens_per_s():
            wall = self._wall()
            gen = sum(r.n_generated for r in sched.done)
            return round(gen / wall, 2) if wall else None

        f("device", "torch device the engine runs on",
          lambda: str(self.device), typ=str)
        f("n_requests", "requests seen (done + waiting + active)",
          n_requests, kind="counter", typ=int)
        f("completed", "requests served to completion",
          lambda: len(sched.done), kind="counter", typ=int)
        f("preemptions", "recompute preemptions among completed requests",
          lambda: sum(r.preemptions for r in sched.done),
          kind="counter", typ=int)
        f("gen_tokens", "tokens generated across completed requests",
          lambda: sum(r.n_generated for r in sched.done),
          kind="counter", typ=int)
        f("prompt_tokens", "prompt tokens across completed requests",
          lambda: sum(len(r.prompt) for r in sched.done),
          kind="counter", typ=int)
        f("wall_s", "run wall-clock on the engine clock (fast-forwarded "
          "arrival gaps excluded from real time)",
          lambda: round(self._wall(), 4), unit="s", typ=float)
        f("tokens_per_s", "generated-token throughput over wall_s",
          tokens_per_s, typ=float, optional=True)
        f("decode_steps", "plain (non-speculative) decode dispatches",
          lambda: self.decode_steps, kind="counter", typ=int)
        f("spec_steps", "speculative verify dispatches",
          lambda: self.spec_steps, kind="counter", typ=int)
        f("prefill_chunks", "chunked-prefill pieces dispatched",
          lambda: self.prefill_chunks, kind="counter", typ=int)
        f("ragged", "unified ragged dispatch path enabled",
          lambda: self.ragged, typ=bool)
        f("ragged_steps", "unified ragged dispatches",
          lambda: self.ragged_steps, kind="counter", typ=int)
        f("substrate", "sequence-state substrate serving this model",
          lambda: self.substrate.kind, typ=str)
        f("recurrent_steps", "fixed-shape recurrent dispatches (the "
          "recurrent substrate is not ported: always 0)",
          lambda: self.recurrent_steps, kind="counter", typ=int)
        f("dispatched_tokens", "token rows dispatched incl. padding",
          lambda: self.dispatched_tokens, kind="counter", typ=int)
        f("padded_tokens", "dispatched token rows that carried no work",
          lambda: self.padded_tokens, kind="counter", typ=int)
        f("padding_frac", "padded_tokens / dispatched_tokens",
          lambda: round(self.padded_tokens / self.dispatched_tokens, 4)
          if self.dispatched_tokens else None, typ=float, optional=True)
        if self.spec_k:
            self._register_spec_metrics()
        for name, q in (("ttft_s", "time to first token"),
                        ("tpot_s", "per-output-token time"),
                        ("e2e_s", "request end-to-end latency")):
            key = name.split("_")[0] if name != "e2e_s" else "e2e"
            for p in (50, 99):
                f(f"{name}.p{p}", f"{q} p{p} (request-timestamp source), "
                  f"seconds",
                  (lambda key=key, p=p:
                   _pct(self._latency_samples()[key], p)),
                  unit="s", typ=float, optional=True)
        f("step_shapes", "per-dispatched-shape first-call-vs-steady step "
          "time summary (dynamic keys: one per dispatched shape)",
          lambda: summarize_step_times(self._step_times), typ=dict)
        f("kernel_launches", "launches of each kernel on this engine's "
          "path during its runs (dynamic keys: one per kernel)",
          lambda: dict(self.launches), typ=dict)
        self._register_pool_metrics()
        if self.pool.cache is not None:
            self._register_cache_metrics()
        self._register_hwcost_metrics()
        self._register_energy_metrics()
        self._register_timeline_metrics()
        f("obs.trace_enabled", "ring-event tracing active",
          lambda: self.tracer.enabled, typ=bool)
        f("obs.trace_events", "events currently held in the trace ring",
          lambda: len(self.tracer.events), typ=int)
        f("obs.trace_emitted", "events emitted since start/reset",
          lambda: self.tracer.n_emitted, kind="counter", typ=int)
        f("obs.trace_dropped", "events evicted from the bounded ring",
          lambda: self.tracer.dropped, kind="counter", typ=int)
        f("obs.trace_capacity", "trace ring capacity (hard bound)",
          lambda: self.tracer.capacity, typ=int)
        f("obs.trace_dropped_total",
          "events evicted from the bounded ring (prometheus-"
          "conventional view of obs.trace_dropped)",
          lambda: self.tracer.dropped, kind="counter", typ=int,
          alias_of="obs.trace_dropped")
        f("obs.trace_ring_used",
          "trace ring occupancy fraction (held / capacity); 1.0 means "
          "the next event evicts the oldest",
          lambda: round(len(self.tracer.events) / self.tracer.capacity,
                        6), typ=float)
        if self.slo is not None:
            self._register_slo_metrics()
        if self.profiler.enabled:
            f("profile", "torch.profiler capture (dynamic keys; present "
              "only when profiling is on)",
              lambda: self.profiler.report(), typ=dict, optional=True)
        m.check_aliases()

    def _register_slo_metrics(self) -> None:
        f = self.metrics.func
        f("slo.objectives", "number of configured SLO objectives",
          lambda: len(self.slo.objectives), typ=int)
        f("slo.evaluations", "monitoring ticks since start/reset "
          "(one per engine step)",
          lambda: self.slo.evaluations, kind="counter", typ=int)
        f("slo.alerts_fired", "burn-rate alert firings since "
          "start/reset",
          lambda: self.slo.alerts_fired, kind="counter", typ=int)
        f("slo.alerts_active", "objectives currently in alert",
          lambda: self.slo.alerts_active, typ=int)
        f("slo.worst_burn_rate", "max burn rate across objectives at "
          "the last evaluation (1.0 = violations exactly exhaust the "
          "error budget)",
          lambda: self.slo.worst_burn_rate(), typ=float, optional=True)
        f("slo.status", "per-objective window/burn/firing state "
          "(dynamic keys: one per objective)",
          lambda: self.slo.status(), typ=dict)

    def _register_spec_metrics(self) -> None:
        f = self.metrics.func
        f("speculative.spec_k", "max draft tokens per verify step",
          lambda: self.spec_k, typ=int)
        f("speculative.drafter", "drafter implementation",
          lambda: type(self.drafter).__name__, typ=str)
        f("speculative.verify_steps", "speculative verify dispatches",
          lambda: self.spec_steps, kind="counter", typ=int)
        f("speculative.fallback_decode_steps",
          "plain decode dispatches (no slot produced a draft)",
          lambda: self.decode_steps, kind="counter", typ=int)
        f("speculative.drafted_tokens", "tokens proposed by the drafter",
          lambda: self.spec_drafted, kind="counter", typ=int)
        f("speculative.accepted_tokens", "drafted tokens that verified",
          lambda: self.spec_accepted, kind="counter", typ=int)
        f("speculative.acceptance_rate", "accepted / drafted",
          lambda: round(self.spec_accepted / self.spec_drafted, 4)
          if self.spec_drafted else None, typ=float, optional=True)
        f("speculative.emitted_tokens",
          "tokens emitted by verify steps (accepted + correction/bonus)",
          lambda: self.spec_emitted, kind="counter", typ=int)
        f("speculative.tokens_per_step",
          "emitted tokens per (slot, verify step) pair",
          lambda: round(self.spec_emitted / self.spec_slot_steps, 4)
          if self.spec_slot_steps else None, typ=float, optional=True)
        f("speculative.retracts", "speculative rollbacks that freed "
          "blocks (view of pool.retracts — single source of truth)",
          lambda: self.pool.stats.retracts, kind="counter", typ=int,
          alias_of="pool.retracts")
        f("speculative.retracted_blocks", "blocks freed by rollback "
          "(view of pool.retracted_blocks)",
          lambda: self.pool.stats.retracted_blocks, kind="counter",
          typ=int, alias_of="pool.retracted_blocks")
        f("speculative.requant_ops_wasted",
          "KV quant ops spent on rejected drafts (performed, rolled back)",
          lambda: self.requant_ops_wasted_spec, kind="counter", typ=int)
        f("speculative.drafter_calls", "draft() invocations",
          lambda: getattr(self.drafter, "stats").calls
          if hasattr(self.drafter, "stats") else 0,
          kind="counter", typ=int)
        f("speculative.drafter_proposed", "tokens the drafter proposed "
          "(before the engine's per-request budget truncation)",
          lambda: getattr(self.drafter, "stats").proposed
          if hasattr(self.drafter, "stats") else 0,
          kind="counter", typ=int)
        f("speculative.drafter_empty", "draft() calls that proposed "
          "nothing (request decodes at the plain per-token rate)",
          lambda: getattr(self.drafter, "stats").empty
          if hasattr(self.drafter, "stats") else 0,
          kind="counter", typ=int)

    def _register_pool_metrics(self) -> None:
        f, pool = self.metrics.func, self.pool
        f("pool.num_blocks", "pool capacity in blocks (incl. trash)",
          lambda: pool.num_blocks, typ=int)
        f("pool.block_size", "tokens per KV block",
          lambda: pool.block_size, typ=int)
        f("pool.peak_live_blocks", "max simultaneously-live blocks",
          lambda: pool.stats.peak_live, typ=int)
        f("pool.peak_utilization", "peak_live / allocatable blocks",
          lambda: round(pool.stats.peak_live
                        / max(pool.num_blocks - 1, 1), 3), typ=float)
        f("pool.utilization", "live blocks / allocatable blocks now",
          lambda: round(pool.utilization, 3), typ=float)
        f("pool.residency", "(live + cached) / allocatable blocks now",
          lambda: round(pool.residency, 3), typ=float)
        f("pool.allocs", "blocks handed out fresh (not cache hits)",
          lambda: pool.stats.allocs, kind="counter", typ=int)
        f("pool.frees", "block references released",
          lambda: pool.stats.frees, kind="counter", typ=int)
        f("pool.evictions", "blocks released by preemption",
          lambda: pool.stats.evictions, kind="counter", typ=int)
        f("pool.seq_evictions", "sequences preempted",
          lambda: pool.stats.seq_evictions, kind="counter", typ=int)
        f("pool.cache_evictions", "idle cached blocks reclaimed (LRU)",
          lambda: pool.stats.cache_evictions, kind="counter", typ=int)
        f("pool.retracts", "speculative rollbacks that freed blocks "
          "(canonical; speculative.retracts is a view of this)",
          lambda: pool.stats.retracts, kind="counter", typ=int)
        f("pool.retracted_blocks", "blocks freed by rollback (canonical)",
          lambda: pool.stats.retracted_blocks, kind="counter", typ=int)
        f("pool.alloc_failures", "alloc/extend requests refused",
          lambda: pool.stats.alloc_failures, kind="counter", typ=int)

    def _register_cache_metrics(self) -> None:
        f, pool = self.metrics.func, self.pool
        f("prefix_cache.hits", "full-block lookups served from cache",
          lambda: pool.cache.stats.hits, kind="counter", typ=int)
        f("prefix_cache.misses", "full-block lookups that missed",
          lambda: pool.cache.stats.misses, kind="counter", typ=int)
        f("prefix_cache.hit_rate", "hits / (hits + misses)",
          lambda: round(pool.cache.stats.hit_rate, 4), typ=float)
        f("prefix_cache.hit_tokens", "tokens covered by block hits",
          lambda: pool.cache.stats.hit_tokens, kind="counter", typ=int)
        f("prefix_cache.lookup_tokens", "tokens covered by lookups",
          lambda: pool.cache.stats.lookup_tokens, kind="counter", typ=int)
        f("prefix_cache.token_hit_rate", "hit_tokens / lookup_tokens",
          lambda: round(pool.cache.stats.token_hit_rate, 4), typ=float)
        f("prefix_cache.cached_prefill_tokens",
          "prefill tokens served from resident KV (never re-quantized)",
          lambda: self.cache_hit_prefill_tokens, kind="counter", typ=int)
        f("prefix_cache.cow_copies", "shared blocks copied before a write",
          lambda: pool.cache.stats.cow_copies, kind="counter", typ=int)
        f("prefix_cache.published_blocks",
          "blocks registered under a content key",
          lambda: pool.cache.stats.published, kind="counter", typ=int)
        f("prefix_cache.cache_evictions",
          "idle cached blocks reclaimed (LRU)",
          lambda: pool.cache.stats.evictions, kind="counter", typ=int)
        f("prefix_cache.resident_cached_blocks",
          "idle cached blocks resident now",
          lambda: pool.n_cached, typ=int)
        f("prefix_cache.quant_ops_avoided",
          "KV quant ops deleted outright by cache hits",
          lambda: self.requant_ops_avoided_cache, kind="counter", typ=int)

    def _register_hwcost_metrics(self) -> None:
        f = self.metrics.func
        f("hwcost.requant_ops_performed",
          "KV requant ops executed (paper Table 5 unit)",
          lambda: self.requant_ops_performed, kind="counter", typ=int)
        f("hwcost.requant_ops_avoided", "ops a dequantize-the-cache-every-"
          "step dataflow would have executed on top",
          lambda: self.requant_ops_avoided, kind="counter", typ=int)
        f("hwcost.requant_ops_avoided_prefix_cache",
          "ops deleted outright by prefix-cache hits",
          lambda: self.requant_ops_avoided_cache, kind="counter", typ=int)
        f("hwcost.requant_ops_wasted_speculation",
          "ops spent on rejected speculative rows",
          lambda: self.requant_ops_wasted_spec, kind="counter", typ=int)

        def requant_ops_per_token():
            tok = self.energy.tokens["prefill"] + self.energy.tokens[
                "decode"]
            ops = self.requant_ops_performed + self.requant_ops_avoided
            return round(ops / tok, 2) if tok else None

        f("hwcost.requant_ops_per_token",
          "KV requant ops (performed + avoided counterfactual) per "
          "useful token",
          requant_ops_per_token, typ=float, optional=True)
        f("hwcost.energy_uj_bit_shift",
          "Table-5 bit-shift energy of the ops performed",
          lambda: hwcost.estimate(
              "bit_shifting", self.requant_ops_performed).energy_uj,
          unit="uJ", typ=float)
        f("hwcost.energy_uj_if_requant_per_step",
          "counterfactual energy of a requant-per-step dataflow",
          lambda: hwcost.estimate(
              "bit_shifting", self.requant_ops_performed
              + self.requant_ops_avoided).energy_uj, unit="uJ", typ=float)
        f("hwcost.energy_uj_if_no_prefix_cache",
          "counterfactual energy without the prefix cache",
          lambda: hwcost.estimate(
              "bit_shifting", self.requant_ops_performed
              + self.requant_ops_avoided_cache).energy_uj,
          unit="uJ", typ=float)
        f("hwcost.energy_uj_if_scaling_factor",
          "counterfactual energy with a scaling-factor requant unit",
          lambda: hwcost.estimate(
              "scaling_factor", self.requant_ops_performed
              + self.requant_ops_avoided).energy_uj, unit="uJ", typ=float)
        f("hwcost.w8a8", "int8 weight+activation matmul path active",
          lambda: self.cfg.matmul_kernel == "int8", typ=bool)
        f("hwcost.forward_quant_ops_per_token",
          "per-token dynamic quant ops of the W8A8 forward dataflow",
          lambda: self._fwd_elems_per_token, typ=int)
        f("hwcost.requant_ops_forward",
          "W8A8 forward boundary quant ops executed",
          lambda: self.requant_ops_forward, kind="counter", typ=int)
        f("hwcost.requant_ops_forward_avoided_prefix_cache",
          "forward ops skipped for cache-hit prefill tokens",
          lambda: self.requant_ops_forward_avoided_cache,
          kind="counter", typ=int)
        f("hwcost.requant_ops_forward_wasted_speculation",
          "forward ops spent on rejected speculative rows",
          lambda: self.requant_ops_forward_wasted_spec,
          kind="counter", typ=int)
        f("hwcost.energy_uj_forward_bit_shift",
          "Table-5 bit-shift energy of the forward ops",
          lambda: hwcost.estimate(
              "bit_shifting", self.requant_ops_forward).energy_uj,
          unit="uJ", typ=float)
        f("hwcost.energy_uj_forward_if_scaling_factor",
          "counterfactual forward energy with a scaling-factor unit",
          lambda: hwcost.estimate(
              "scaling_factor", self.requant_ops_forward).energy_uj,
          unit="uJ", typ=float)

    def _register_energy_metrics(self) -> None:
        """Live Table-5 energy proxy split by phase: ``sum(phase
        quant_ops) == requant_ops_performed + requant_ops_forward``
        always."""
        f, en = self.metrics.func, self.energy
        f("energy.unit", "Table-5 requant unit pricing the proxy",
          lambda: en.kind, typ=str)
        for p in ("prefill", "decode", "spec_wasted"):
            f(f"energy.{p}.quant_ops",
              f"requant ops (KV + forward) attributed to {p}",
              lambda p=p: en.quant_ops[p], kind="counter", typ=int)
            f(f"energy.{p}.tokens",
              "rejected draft rows" if p == "spec_wasted" else
              f"useful tokens processed in {p}",
              lambda p=p: en.tokens[p], kind="counter", typ=int)
            f(f"energy.{p}.energy_uj",
              f"Table-5 energy of the {p} ops",
              lambda p=p: round(en.energy_uj(p), 6), unit="uJ", typ=float)
            f(f"energy.{p}.uj_per_token",
              "wasted energy amortized over EMITTED decode tokens"
              if p == "spec_wasted" else
              f"energy per useful {p} token",
              lambda p=p: (lambda v: None if v is None else round(v, 9))(
                  en.uj_per_token(p)),
              unit="uJ", typ=float, optional=True)
        f("energy.total_quant_ops", "sum of phase quant ops (== "
          "hwcost.requant_ops_performed + hwcost.requant_ops_forward)",
          lambda: en.total_quant_ops, kind="counter", typ=int)
        f("energy.total_energy_uj", "Table-5 energy of all requant ops",
          lambda: round(hwcost.estimate(
              en.kind, en.total_quant_ops).energy_uj, 6),
          unit="uJ", typ=float)
        f("energy.proxy_uj_per_token", "LIVE headline gauge: total requant"
          " energy over useful (prefill + decode) tokens",
          lambda: (lambda v: None if v is None else round(v, 9))(
              en.proxy_uj_per_token()),
          unit="uJ", typ=float, optional=True)

    def _register_timeline_metrics(self) -> None:
        """Latency percentiles derived from the trace's per-request
        timelines; the ttft_s/tpot_s/e2e_s sections are the cross-check."""
        f, tr = self.metrics.func, self.tracer
        f("timeline.source", "where these latencies come from",
          lambda: "trace", typ=str)
        f("timeline.requests", "requests with a timeline",
          lambda: len(tr.timelines), typ=int)
        f("timeline.completed", "timelines with a done mark",
          lambda: sum(1 for t in tr.timelines.values()
                      if t.done is not None), typ=int)
        for name, key in (("ttft_s", "ttft"), ("tpot_s", "tpot"),
                          ("e2e_s", "e2e")):
            for p in (50, 99):
                f(f"timeline.{name}.p{p}",
                  f"trace-derived {key} p{p}, seconds",
                  (lambda key=key, p=p:
                   _pct(tr.derive_latencies()[key], p)),
                  unit="s", typ=float, optional=True)

    def report(self) -> dict:
        """Schema-stable snapshot of the metrics registry, nested into
        the report shape.  Disabled sections surface as explicit ``None``
        (their metrics are never registered)."""
        rep = self.metrics.nested()
        rep.setdefault("speculative", None)
        rep.setdefault("prefix_cache", None)
        rep.setdefault("pool", None)
        rep.setdefault("state_pool", None)
        return rep
