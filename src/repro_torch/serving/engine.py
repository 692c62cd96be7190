"""Continuous-batching step loop over the paged int8-KV block pool and
the fixed-slab recurrent substrate (PyTorch counterpart of
``repro.serving.engine``).

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

The recurrent substrates (RWKV6's ``ssm`` family and zamba2's hybrid,
``serving.substrate``) serve every step as ONE fixed-shape (n_slots,
chunk) ``models.model.paged_recurrent_step``: prefill rows feed their
next chunk, decode rows their last token, idle lanes ride along inert on
the trash slab.  Each live sequence owns one fixed-size state slab
(``serving.state_pool``), fp32 or int8 Eq.-1 codes requantized once a
step; the hybrid also grows block tables in the pool for its shared
attention block (K4 once a group).  Speculative decoding and the prefix
cache are refused there, and the ragged step is off; preemption on the
pure recurrent substrate copies the slab to the host and restores it at
readmission.

The host-side pools, prefix cache and scheduler are the JAX package's
numpy modules, copied unchanged.  The device pool is updated in place:
the scatter writes each token's codes into its row and copy-on-write
duplicates one block's rows, where the JAX engine donates the buffer.

The compiled step: where the JAX engine runs each step as one
``jax.jit`` executable per shape, the port's engine on a CUDA device
captures each step's whole device program (every layer, the fused
sampling and draft verification, the pool scatter) as one CUDA graph per
step key and replays it (``launch.steps.StepGraphs``: a key's first call
runs eagerly, its second captures); the host only stages the step's
arrays into the key's static buffers and reads back the sampled tokens.
The attention kernels' work lists are padded to a fixed capacity per key
(``kernels.ragged_flash.pad_work``), so one graph serves every step of
its shape.  ``graphs=False`` runs every step eagerly (unpadded lists),
the comparison the graphs are held to; on the CPU the same staging runs
without capture.  Copy-on-write copies stay eager, between steps, as the
reference jits them apart.

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

On a (data, model) mesh (``mesh``: the rank's ``launch.mesh.RankMesh``)
every rank runs this engine: the same scheduler, pool tables and prefix
cache over the same requests, its own slices of the weights and its own
pool of its KV heads (``models.model.init_paged_cache``), the logits
gathered whole on every rank, and a sampling generator seeded alike;
rank 0's clock says which arrivals join before each step (the other
ranks take its word), so every rank makes the same decisions and samples
the same tokens; the data ranks are replicas of one schedule (the
reference's ragged step has no batch axis to cut).  The recurrent
substrates serve so too: every rank's slabs are whole (its projections'
outputs are, so each rank runs the scans on the whole state, and a
preemption snapshot is each rank's own copy of the same slab), the
hybrid's pool holds its KV heads.  Its steps run eagerly (``StepGraphs``
refuses to capture the collectives).

``profile_cost`` counts each step shape's first call, the eager one,
under the cost counter (``obs.profile.Profiler.cost_for``; FLOPs, bytes,
peak live bytes and each kernel's charge a shape), where the reference
reads XLA's cost analysis of each compiled shape.
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
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops as kops
from repro_torch.kernels.flash_attention import (paged_capacity,
                                                 plan_paged_work)
from repro_torch.kernels.ragged_flash import (pad_work, plan_ragged_work,
                                              ragged_capacity)
from repro_torch.launch.steps import (StepGraphs, build_paged_step,
                                      build_ragged_step,
                                      build_recurrent_step,
                                      check_matmul_kernel)
from repro_torch.models import model as M
from repro_torch.models.attention import RaggedBatch
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.profile import EnergyAccount, Profiler
from repro_torch.obs.slo import SLOMonitor, default_slos
from repro_torch.obs.trace import Tracer
from repro_torch.serving.kv_pool import (TRASH_BLOCK, BlockPool,
                                         BlockPoolError)
from repro_torch.serving.scheduler import (Request, RequestState, Scheduler,
                                           chunk_bucket)
from repro_torch.serving.spec import (apply_top_k, resolve_drafter,
                                      verify_tokens)
from repro_torch.serving.state_pool import TRASH_SLAB, StateSlabPool
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
    ``ragged_{T}xS{S}`` and the recurrent step ``("recurrent", B, C)`` as
    ``recurrent_{B}xC{C}`` at the top level, the legacy per-shape steps'
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
        elif shape[0] == "recurrent":
            shapes[f"recurrent_{shape[1]}xC{shape[2]}"] = entry
        else:
            legacy["x".join(map(str, shape))] = entry
    if legacy:
        shapes["legacy_shapes"] = legacy
    return shapes


class ServingEngine:
    """Continuous-batching serving engine: the unified ragged step, or the
    legacy per-shape trio with ``ragged=False``, on the attention
    substrate; the fixed-shape recurrent step on the recurrent and hybrid
    substrates (``num_slabs`` state slabs, default one a slot plus the
    trash slab)."""

    def __init__(self, cfg: ModelConfig, params: Any, ctx: QuantContext, *,
                 n_slots: int = 4, block_size: int = 16,
                 max_model_len: int = 128,
                 num_blocks: Optional[int] = None, chunk: int = 16,
                 prefill_token_budget: Optional[int] = None,
                 num_slabs: Optional[int] = None,
                 top_k: int = 0, seed: int = 0,
                 prefix_cache: Optional[bool] = None, spec_k: int = 0,
                 drafter="ngram", ragged: bool = True,
                 trace: bool = False, trace_capacity: int = 65536,
                 profile_dir: Optional[str] = None,
                 profile_cost: bool = False,
                 record: bool = False, virtual_dt: float = 1e-3,
                 slo=None, graphs: Optional[bool] = None, device=None,
                 mesh=None):
        # substrate routing: the config's layer mix decides which pools
        # back the sequences — growing block tables (attention), one fixed
        # state slab (recurrent), or both (hybrid)
        sub = substrate_for(cfg)
        if spec_k > 0 and not sub.supports_spec:
            raise ValueError(
                f"spec_k={spec_k} is unsupported on the {sub.kind} "
                "substrate: speculative decoding must retract rejected "
                "draft tokens, but fixed-size recurrent state cannot be "
                "rolled back (use spec_k=0 for recurrent/hybrid models)")
        if prefix_cache and not sub.supports_prefix_cache:
            raise ValueError(
                f"prefix_cache=True is unsupported on the {sub.kind} "
                "substrate: recurrent state is a running summary, not an "
                "addressable token range, so there is no prefix to share "
                "(leave prefix_cache unset for auto, or pass False)")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if virtual_dt <= 0.0:
            raise ValueError(f"virtual_dt must be > 0, got {virtual_dt}")
        check_matmul_kernel(cfg, ctx)
        shd.local_config(cfg, mesh)         # the mesh's refusals
        self.device = resolve_device(device)
        self.mesh = mesh
        self.cfg = cfg
        self.params = params
        self.ctx = ctx
        self.substrate = sub
        self.n_slots = n_slots
        self.max_model_len = max_model_len
        if prefix_cache is None:
            prefix_cache = sub.supports_prefix_cache
        ragged = ragged and sub.supports_ragged
        nbmax = -(-max_model_len // block_size)
        self.pool: Optional[BlockPool] = None
        if sub.grows:
            if num_blocks is None:
                # full residency; callers undersize this to force
                # preemption
                num_blocks = 1 + n_slots * nbmax
            scale_exp = cfg.kv_cache_frac_bits if cfg.kv_cache_bits == 8 \
                else 0
            self.pool = BlockPool(num_blocks, block_size,
                                  scale_exp=scale_exp,
                                  prefix_cache=prefix_cache)
        self.state_pool: Optional[StateSlabPool] = None
        if sub.fixed_state:
            if num_slabs is None:
                num_slabs = 1 + n_slots      # one a slot + the trash slab
            self.state_pool = StateSlabPool(
                num_slabs, scale_exp=cfg.state_frac_bits
                if cfg.state_bits == 8 else 0)
        self.sched = Scheduler(self.pool, n_slots=n_slots, chunk=chunk,
                               max_model_len=max_model_len,
                               prefill_token_budget=prefill_token_budget,
                               state_pool=self.state_pool, substrate=sub)
        self._t0 = time.perf_counter()
        self._skip = 0.0
        self._wall_s = 0.0
        # observability: one tracer threaded through every serving-path
        # module.  Ring events are off unless ``trace=True``; per-request
        # timelines are always on (the report's timeline section).
        self.tracer = Tracer(capacity=trace_capacity, clock=self._now,
                             enabled=trace)
        if self.pool is not None:
            self.pool.tracer = self.tracer
            if self.pool.cache is not None:
                self.pool.cache.tracer = self.tracer
        if self.state_pool is not None:
            self.state_pool.tracer = self.tracer
        self.sched.tracer = self.tracer
        if sub.snapshot_preempt:
            # pure-recurrent preemption copies the sequence's whole slab
            # to the host (no token range to recompute from a pool); the
            # scheduler calls this hook, admission restores it
            self.sched.snapshot_fn = self._snapshot_slab
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
        if sub.kind == "attention":
            self.cache = M.init_paged_cache(cfg, num_blocks, block_size,
                                            device=self.device, mesh=mesh)
        else:                   # slabs (+ the hybrid's shared-block pool)
            self.cache = M.init_paged_state(
                cfg, self.state_pool.num_slabs,
                num_blocks=num_blocks if sub.grows else None,
                block_size=block_size if sub.grows else None,
                device=self.device, mesh=mesh)
        self.seed = seed
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.default_top_k = top_k
        self.spec_k = spec_k
        self.drafter = resolve_drafter(drafter)
        self.ragged = ragged
        if sub.kind == "attention":
            self._paged_fn = build_paged_step(cfg, ctx, mesh=mesh)
            self._ragged_fn = build_ragged_step(cfg, ctx, mesh=mesh)
        else:
            # off a mesh built as stand-ins of it are, without the keyword
            self._rec_fn = build_recurrent_step(
                cfg, ctx, **({} if mesh is None else {"mesh": mesh}))
        self._groups = cfg.n_heads // cfg.n_kv_heads
        # the compiled step: on by default on a CUDA device, off a mesh
        if graphs is None:
            graphs = self.device.type == "cuda" and (
                mesh is None or mesh.size == 1)
        # (StepGraphs refuses to capture on a mesh; off one it is built
        # as stand-ins of it are, without the keyword)
        self.graphs = StepGraphs(self.device, self.generator,
                                 capture=bool(graphs),
                                 **({} if mesh is None else {"mesh": mesh}))
        budget = self.sched.prefill_token_budget
        # worst-case stream: the full prefill budget plus every slot
        # verifying a K-token tail
        self._t_max = max(8, -(-(budget + n_slots * (spec_k + 1)) // 8) * 8)
        self._step_counter = 0
        # one requant op per KV element written (the paper's Table-5
        # unit): every layer writes K and V for each token on attention,
        # the shared attention block (once a group) on the hybrid, no
        # layer on pure recurrent
        if sub.kind == "hybrid":
            n_kv_layers = cfg.n_layers // cfg.hybrid.attn_every
        elif sub.kind == "recurrent":
            n_kv_layers = 0
        else:
            n_kv_layers = cfg.n_layers
        self._elems_per_token = (n_kv_layers * cfg.n_kv_heads
                                 * cfg.resolved_head_dim * 2)
        # the fixed-slab counterpart: ops to requantize one sequence's
        # WHOLE recurrent state, paid once a step whatever the context
        # (performed with int8 slabs, the counterfactual 'avoided' bucket
        # with fp32 ones)
        self._state_elems_per_step = hwcost.state_quant_ops_per_step(cfg) \
            if sub.fixed_state else 0
        # W8A8 forward accounting: per-token dynamic quant ops at every
        # module boundary, only under matmul_kernel='int8'; kept apart
        # from the KV counters so those compare across runs
        self._fwd_elems_per_token = (
            hwcost.forward_quant_ops_per_token(cfg)
            if cfg.matmul_kernel == "int8" else 0)
        self._zero_counters()
        # the kernels this engine's steps launch: K2 per INT projection,
        # and per layer K1 (ragged step) or K4 (legacy per-shape steps; the
        # hybrid's shared block, once a group); none on pure recurrent
        self.launches = {"int8_matmul": 0}
        if sub.grows:
            attn = "ragged_attention" if self.ragged else "paged_attention"
            self.launches[attn] = 0
        self._step_times: dict[tuple, list] = {}
        # the registry is the single source of report naming and typing:
        # report() is its nested view
        self.metrics = MetricsRegistry()
        self._register_metrics()

    def _zero_counters(self) -> None:
        # the whole-slab state requant ops, apart from the merged buckets
        # below, so a hybrid run reports the recurrent share on its own
        self.requant_ops_state = 0
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
        assert self.sched.idle \
            and (self.pool is None or self.pool.n_live == 0) \
            and (self.state_pool is None or self.state_pool.n_live == 0), \
            "reset_metrics on a non-drained engine"
        from repro_torch.serving.kv_pool import PoolStats
        from repro_torch.serving.prefix_cache import CacheStats
        self._step_counter = 0
        self.generator.manual_seed(self.seed)
        self.sched.done.clear()
        self.sched.admission_log.clear()
        if self.pool is not None:
            if flush_cache:
                self.pool.flush_cache()
            self.pool.reset_free_order()
            self.pool.stats = PoolStats()
            if self.pool.cache is not None:
                self.pool.cache.stats = CacheStats()
        if self.state_pool is not None:
            self.state_pool.reset_free_order()
            self.state_pool.stats = PoolStats()
        self._zero_counters()
        self.launches = dict.fromkeys(self.launches, 0)
        self.graphs.reset_counts()
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
        (``virtual_dt`` a step), so the run is exactly replayable.  On a
        mesh of more than one rank, rank 0's clock decides which arrivals
        join before each step and every rank admits those
        (:meth:`_agreed`): the ranks' clocks differ, their schedules must
        not."""
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
                n = 0
                while n < len(pending) and pending[n].arrival <= now:
                    n += 1
                n = self._agreed(n)
                for req in pending[:n]:
                    self.submit(req)
                del pending[:n]
                self.step()
            self._wall_s = self._now()
        for name in self.launches:
            self.launches[name] += kops.LAUNCHES[name] - start[name]
        return self.report()

    def _agreed(self, n: int) -> int:
        """Rank 0's ``n`` on every rank of a mesh of more than one (this
        process's ``n`` off one)."""
        if self.mesh is None or self.mesh.size == 1:
            return n
        return self.mesh.broadcast_object(n)

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
        decode).  Recurrent / hybrid: admit (a fresh slab zeroed, or a
        preempted sequence's snapshot restored), then ONE fixed-shape
        recurrent dispatch."""
        for req in self.sched.admit(self._now()):
            if self.substrate.fixed_state:
                if req.snapshot is not None:
                    # the saved state drops back into the fresh slab: these
                    # tokens were paid for before eviction, not cache hits
                    self._restore_snapshot(req)
                else:
                    # slabs recycle LIFO: a fresh sequence must not
                    # inherit the previous owner's final state
                    self._reset_slab(req)
                continue
            # cached-prefix hit: those tokens' KV is already resident, so
            # neither their KV quantization nor (W8A8) their forward runs
            self.cache_hit_prefill_tokens += req.n_prefilled
            self.requant_ops_avoided_cache += \
                req.n_prefilled * self._elems_per_token
            self.requant_ops_forward_avoided_cache += \
                req.n_prefilled * self._fwd_elems_per_token
        if self.substrate.fixed_state:
            self._run_recurrent_step()
        elif self.ragged:
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
        the host sync, run through the compiled step under the key
        ``("ragged", T_pad, S_pad)`` and the sampling key, timed under
        the work-list shape key ``("ragged", T_pad, S_pad)`` and, with
        tracing on, one ``ragged_step`` span (stream shape, real vs padded
        tokens, and ``compile``: the key's eager first call or its
        capture, or without graphs the shape's first call).  Every
        sequence gathers K+1 logit rows from its ``sample_start``; a
        prefill or decode row rides with ``n_drafts == 0``, which is plain
        sampling of its row.  Returns (out (S, K+1), n_accepted (S,)) on
        the host."""
        t_start = self._now()
        t0 = time.perf_counter()
        self._step_counter += 1
        shape_key = ("ragged", len(tokens), len(temps))
        first_call = shape_key not in self._step_times
        with self.profiler.step_annotation("ragged_step",
                                           self._step_counter):
            arrays = dict(tokens=tokens, positions=positions, dest=dest,
                          block_tables=bt, q_start=q_start, q_len=q_len,
                          kv_len=kv_len, temps=temps, topks=topks,
                          sample_start=sample_start, n_drafts=n_drafts)
            work = None
            if self._plans_work():
                # K1's work list, planned once from the host descriptors
                # for every layer (the plain CPU path needs none); padded
                # to the step shape's capacity when steps are captured
                work = plan_ragged_work(q_start, q_len, kv_len,
                                        groups=self._groups)
                if self.graphs.capture:
                    work = pad_work(work, ragged_capacity(
                        len(tokens), len(temps), groups=self._groups,
                        rows=self.sched.nbmax * self.pool.block_size))
                arrays["work"] = work.table
            sampling = self._sampling(temps, topks)
            with self.profiler.cost_for(shape_key):
                res = self.graphs.run(
                    shape_key + tuple(sampling.values()),
                    lambda inp: self._ragged_sampled(inp, work, **sampling),
                    arrays)
            out, n_acc = self._host(res)
        dt = time.perf_counter() - t0
        self._step_times.setdefault(shape_key, []).append(dt)
        tr = self.tracer
        if tr.enabled:
            tr.span("ragged_step", "dispatch", t_start, dt, {
                "shape": f"T{len(tokens)}xS{len(temps)}",
                "real_tokens": t_real,
                "padded_tokens": len(tokens) - t_real,
                "compile": self._compiled(first_call)})
        return out, n_acc

    def _ragged_sampled(self, inp: dict, work, *, k_cap, has_top_k,
                        sampled) -> torch.Tensor:
        """The ragged step's device program over the staged ``inp``:
        every layer (the pool updated in place), then sampling and draft
        verification of each sequence's K+1 rows from its
        ``sample_start``."""
        rb = RaggedBatch(dest=inp["dest"], block_tables=inp["block_tables"],
                         q_start=inp["q_start"], q_len=inp["q_len"],
                         kv_len=inp["kv_len"],
                         work=None if work is None
                         else work._replace(table=inp["work"]))
        tok = inp["tokens"]
        logits, _ = self._ragged_fn(self.params, tok, self.cache,
                                    inp["positions"], rb)
        kp1 = self.spec_k + 1
        idx = torch.clamp(
            inp["sample_start"].long()[:, None]
            + torch.arange(kp1, device=self.device)[None, :], 0,
            logits.shape[0] - 1)
        return self._verify(logits[idx], tok[idx], inp, inp["n_drafts"],
                            k_cap=k_cap, has_top_k=has_top_k,
                            sampled=sampled)

    def _verify(self, logits, tokens, inp, n_drafts, *, k_cap, has_top_k,
                sampled) -> torch.Tensor:
        """On-device sampling / draft verification of (B, K+1, V) logits
        fed by ``tokens`` (B, K+1): (out | n_accepted) as one (B, K+2)
        int32 tensor, read back by :meth:`_host`."""
        out, n_acc = verify_tokens(
            logits, tokens, n_drafts, self.generator, inp["temps"],
            inp["topks"] if has_top_k else None, k_cap=k_cap,
            any_sampled=sampled)
        return torch.cat([out, n_acc[:, None]], dim=1)

    @staticmethod
    def _host(res: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
        """The step's one host sync: (out, n_accepted) of :meth:`_verify`
        on the host."""
        res = res.cpu().numpy()
        return res[:, :-1], res[:, -1]

    @staticmethod
    def _sampling(temps: np.ndarray, topks: np.ndarray) -> dict:
        """The host-known sampling key of a step, static in its device
        program as ``k_cap`` is in the JAX jit: the largest top-k (None
        without one), whether any row takes top-k, whether any row
        samples (temperature > 0)."""
        has_top_k = bool(topks.any())
        return dict(k_cap=int(topks.max()) if has_top_k else None,
                    has_top_k=has_top_k, sampled=bool((temps > 0).any()))

    def _compiled(self, first_call: bool) -> bool:
        """The dispatch span's ``compile`` field: the call did its key's
        one-time work, the eager first call or the capture (between them
        the JAX engine's first-call compile); without graphs, the shape's
        first call."""
        return (self.graphs.last != "replay" if self.graphs.capture
                else first_call)

    def _plans_work(self) -> bool:
        """Whether a step plans its attention kernel's work list on the
        host: on the card; the plain CPU path takes none."""
        return self.device.type == "cuda"

    # -- legacy per-shape steps (ragged=False) ---------------------------

    def _dispatch(self, tokens, positions, bt, temps, topks, *, name: str,
                  n_real: int, last_idx: int = 0, n_drafts=None):
        """One legacy step: ``paged_step`` at (B, C), then on-device
        sampling and the host sync, run through the compiled step under
        the key (B, C) and the sampling key, timed under the shape key
        (B, C) and, with tracing on, one span ``name`` ('prefill',
        'decode' or 'spec_verify') with ``n_real`` of its B x C tokens
        real.  Without ``n_drafts`` each slot samples its row
        ``last_idx`` (the decode and prefill steps; staged, so one graph
        serves every chunk of a shape); with them the whole (B, C) chunk
        is a speculative verify.  Returns (out (B, K+1), n_accepted
        (B,))."""
        t_start = self._now()
        t0 = time.perf_counter()
        self._step_counter += 1
        shape_key = tuple(tokens.shape)
        first_call = shape_key not in self._step_times
        verify = n_drafts is not None
        with self.profiler.step_annotation(name, self._step_counter):
            arrays = dict(tokens=tokens, positions=positions,
                          block_tables=bt, temps=temps, topks=topks)
            if verify:
                arrays["n_drafts"] = n_drafts
            else:
                arrays["last_idx"] = np.asarray([last_idx], np.int32)
            work = None
            if self._plans_work():
                # K4's work list, planned once from the host positions for
                # every layer; padded to the shape's capacity when steps
                # are captured
                work = plan_paged_work(
                    positions, table_width=bt.shape[1],
                    block_size=self.pool.block_size, groups=self._groups)
                if self.graphs.capture:
                    work = pad_work(work, paged_capacity(
                        *tokens.shape, groups=self._groups,
                        table_width=bt.shape[1],
                        block_size=self.pool.block_size))
                arrays["work"] = work.table
            sampling = self._sampling(temps, topks)
            with self.profiler.cost_for(shape_key):
                res = self.graphs.run(
                    shape_key + (verify,) + tuple(sampling.values()),
                    lambda inp: self._paged_sampled(inp, work, verify,
                                                    **sampling),
                    arrays)
            out, n_acc = self._host(res)
        dt = time.perf_counter() - t0
        self._step_times.setdefault(shape_key, []).append(dt)
        tr = self.tracer
        if tr.enabled:
            n_disp = int(np.prod(tokens.shape))
            tr.span(name, "dispatch", t_start, dt, {
                "shape": "x".join(map(str, tokens.shape)),
                "real_tokens": n_real,
                "padded_tokens": n_disp - n_real,
                "compile": self._compiled(first_call)})
        return out, n_acc

    def _paged_sampled(self, inp: dict, work, verify: bool, *, k_cap,
                       has_top_k, sampled) -> torch.Tensor:
        """The legacy step's device program over the staged ``inp``:
        ``paged_step`` (the pool updated in place), then sampling of each
        slot's row ``last_idx``, or verification of the whole chunk."""
        tok = inp["tokens"]
        logits, _ = self._paged_fn(
            self.params, tok, self.cache, inp["positions"],
            inp["block_tables"],
            work=None if work is None else work._replace(table=inp["work"]))
        if verify:
            n_drafts = inp["n_drafts"]
        else:
            idx = inp["last_idx"].long()
            logits, tok = logits.index_select(1, idx), tok.index_select(1, idx)
            n_drafts = torch.zeros(tok.shape[0], dtype=torch.int32,
                                   device=self.device)
        return self._verify(logits, tok, inp, n_drafts, k_cap=k_cap,
                            has_top_k=has_top_k, sampled=sampled)

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

    # -- the fixed-slab recurrent step ------------------------------------

    def _snapshot_slab(self, req: Request) -> dict:
        """Scheduler preemption hook (pure recurrent substrate): copy the
        sequence's whole state slab to the host, codes as codes (int8
        slabs) or raw fp32, so the resume is bit-exact.  Runs between
        steps."""
        slab = self.state_pool.slab_of(req.rid)
        state = {k: v[:, slab].to("cpu", copy=True)
                 for k, v in self.cache["state"].items()}
        return {"n_ctx": req.n_ctx, "state": state}

    def _restore_snapshot(self, req: Request) -> None:
        """Drop a preemption snapshot back into the freshly allocated slab,
        in place.  Admission already resumed the token bookkeeping from
        ``snapshot['n_ctx']``; the slab grid is the engine's fixed one,
        so the codes read back identically."""
        slab = self.state_pool.slab_of(req.rid)
        st = self.cache["state"]
        for k, v in req.snapshot["state"].items():
            st[k][:, slab] = v.to(self.device)
        req.snapshot = None

    def _reset_slab(self, req: Request) -> None:
        """Zero a freshly allocated slab, in place: slabs recycle LIFO still
        holding their previous owner's final state."""
        slab = self.state_pool.slab_of(req.rid)
        if "state" in self.cache:               # pure recurrent
            for arr in self.cache["state"].values():
                arr[:, slab] = 0
        else:                                   # the hybrid's Mamba slabs
            for arr in self.cache["ssm"]:
                arr[:, :, slab] = 0

    def _charge_recurrent(self, phase: str, n_tok: int,
                          int8_state: bool) -> None:
        """Table-5 accounting of one sequence's share of a recurrent step:
        ``n_tok`` per-token KV appends (the hybrid's shared attention
        blocks; none on pure recurrent) plus ONE whole-slab state requant,
        context-free.  int8 slabs PERFORM the state ops; fp32 slabs book
        the same count as the dequantize-per-step counterfactual
        ``avoided``, so the ops/token gauge compares across storage
        modes."""
        kv = n_tok * self._elems_per_token
        st = self._state_elems_per_step
        fwd = n_tok * self._fwd_elems_per_token
        self.requant_ops_state += st
        if int8_state:
            self.requant_ops_performed += kv + st
            self.energy.charge(phase, kv + st + fwd, n_tok)
        else:
            self.requant_ops_performed += kv
            self.requant_ops_avoided += st
            self.energy.charge(phase, kv + fwd, n_tok)
        self.requant_ops_forward += fwd

    def _run_recurrent_step(self) -> None:
        """Serve the whole mixed work-list in ONE fixed-shape dispatch
        (n_slots, chunk): prefill rows feed their next chunk (q_len = c),
        decode rows their last sampled token (q_len = 1), idle lanes ride
        along inert (q_len = 0 on the trash slab).  On the hybrid substrate
        the same dispatch carries per-row positions and block tables (one
        trash column past nbmax, where padded positions point) for the
        shared attention blocks."""
        sub = self.substrate
        now = self._now()
        if sub.grows:
            # the hybrid's KV half: decode rows append one KV row a step,
            # so tables may grow, and growth may preempt a peer
            for req in list(self.sched.decode_reqs()):
                if req.slot is not None \
                        and req.state is RequestState.DECODE:
                    self.sched.grow_for_decode(req, now)
        prefills = []
        for req in self.sched.prefill_jobs():
            start = req.n_prefilled
            prefills.append((req, start, min(self.sched.chunk,
                                             len(req.feed) - start)))
        decodes = self.sched.decode_reqs()
        if not prefills and not decodes:
            return
        b, c = self.n_slots, self.sched.chunk
        tokens = np.zeros((b, c), np.int32)
        q_len = np.zeros((b,), np.int32)
        slab_ids = np.full((b,), TRASH_SLAB, np.int32)   # idle lanes
        temps = np.zeros((b,), np.float32)
        topks = np.zeros((b,), np.int32)
        positions = bt = None
        if sub.grows:
            nbmax = self.sched.nbmax
            positions = np.full((b, c), nbmax * self.pool.block_size,
                                np.int32)
            bt = np.full((b, nbmax + 1), TRASH_BLOCK, np.int32)
        rows = [(req, start, c_real) for req, start, c_real in prefills] \
            + [(req, req.n_ctx, 1) for req in decodes]
        for i, (req, start, n) in enumerate(rows):
            s = req.slot
            if i < len(prefills):
                tokens[s, :n] = req.feed[start:start + n]
            else:
                tokens[s, 0] = req.generated[-1]
            q_len[s] = n
            slab_ids[s] = self.state_pool.slab_of(req.rid)
            temps[s] = req.temperature
            topks[s] = self._req_top_k(req)
            if sub.grows:
                positions[s, :n] = start + np.arange(n, dtype=np.int32)
                bt[s, :nbmax] = self.pool.table_row(req.rid, nbmax)
        n_real = int(q_len.sum())
        toks = self._dispatch_recurrent(tokens, slab_ids, q_len, positions,
                                        bt, temps, topks, n_real)
        self.recurrent_steps += 1
        self.dispatched_tokens += b * c
        self.padded_tokens += b * c - n_real
        int8_state = self.cfg.state_bits == 8
        now = self._now()
        tr = self.tracer
        for req, start, c_real in prefills:
            req.n_prefilled += c_real
            req.n_ctx = req.n_prefilled
            if sub.grows:
                self.pool.commit(req.rid, start,
                                 req.feed[start:start + c_real])
            self.prefill_chunks += 1
            self._charge_recurrent("prefill", c_real, int8_state)
            if tr.enabled:
                tr.event("sched.prefill_chunk", "sched", ts=now, args={
                    "rid": req.rid, "start": start, "tokens": c_real})
            tr.req_mark(req.rid, "first_chunk", now)
            if req.n_prefilled == len(req.feed):
                tok = int(toks[req.slot])
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
        for req in decodes:
            if sub.grows:
                self.pool.commit(req.rid, req.n_ctx, [req.generated[-1]])
            req.n_ctx += 1
            if sub.grows:
                # the hybrid's KV half still avoids the dequantize-the-
                # cache-every-step counterfactual, as attention does
                self.requant_ops_avoided += req.n_ctx * self._elems_per_token
            self._charge_recurrent("decode", 1, int8_state)
            tok = int(toks[req.slot])
            done = req.finished_by(tok, self.max_model_len)
            req.generated.append(tok)
            tr.req_token(req.rid, now)
            if done:
                self.sched.finish(req, now)

    def _dispatch_recurrent(self, tokens, slab_ids, q_len, positions, bt,
                            temps, topks, n_real: int) -> np.ndarray:
        """One recurrent step + on-device sampling + the host sync, run
        through the compiled step under the key ``("recurrent", B, C)`` and
        the sampling key, timed under ``("recurrent", B, C)`` and, with
        tracing on, one ``recurrent`` span.  On the hybrid, K4's work list
        is planned once from the host positions for every group (on the
        card), padded to the shape's capacity when steps are captured.
        Returns each row's sampled token (B,) on the host."""
        t_start = self._now()
        t0 = time.perf_counter()
        self._step_counter += 1
        shape_key = ("recurrent",) + tuple(tokens.shape)
        first_call = shape_key not in self._step_times
        with self.profiler.step_annotation("recurrent", self._step_counter):
            arrays = dict(tokens=tokens, slab_ids=slab_ids, q_len=q_len,
                          temps=temps, topks=topks)
            work = None
            if positions is not None:
                arrays.update(positions=positions, block_tables=bt)
                if self._plans_work():
                    work = plan_paged_work(
                        positions, table_width=bt.shape[1],
                        block_size=self.pool.block_size,
                        groups=self._groups)
                    if self.graphs.capture:
                        work = pad_work(work, paged_capacity(
                            *tokens.shape, groups=self._groups,
                            table_width=bt.shape[1],
                            block_size=self.pool.block_size))
                    arrays["work"] = work.table
            sampling = self._sampling(temps, topks)
            with self.profiler.cost_for(shape_key):
                res = self.graphs.run(
                    shape_key + tuple(sampling.values()),
                    lambda inp: self._recurrent_sampled(inp, work,
                                                        **sampling),
                    arrays)
            out, _ = self._host(res)
        dt = time.perf_counter() - t0
        self._step_times.setdefault(shape_key, []).append(dt)
        tr = self.tracer
        if tr.enabled:
            n_disp = int(np.prod(tokens.shape))
            tr.span("recurrent", "dispatch", t_start, dt, {
                "shape": "x".join(map(str, tokens.shape)),
                "real_tokens": n_real,
                "padded_tokens": n_disp - n_real,
                "compile": self._compiled(first_call)})
        return out[:, 0]

    def _recurrent_sampled(self, inp: dict, work, *, k_cap, has_top_k,
                           sampled) -> torch.Tensor:
        """The recurrent step's device program over the staged ``inp``:
        ``paged_recurrent_step`` (slabs and pool updated in place), then
        sampling of each row's logits at its last real token."""
        tok = inp["tokens"]
        logits, _ = self._rec_fn(
            self.params, tok, self.cache, inp["slab_ids"], inp["q_len"],
            inp.get("positions"), inp.get("block_tables"),
            work=None if work is None else work._replace(table=inp["work"]))
        n_drafts = torch.zeros(tok.shape[0], dtype=torch.int32,
                               device=self.device)
        return self._verify(logits[:, None], tok[:, :1], inp, n_drafts,
                            k_cap=k_cap, has_top_k=has_top_k,
                            sampled=sampled)

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
        if self.substrate.fixed_state:
            raise BlockPoolError(
                f"copy-on-write on the {self.substrate.kind} substrate: "
                f"sequence {req.rid} keeps fixed-size recurrent state and "
                f"never shares a block (no prefix cache to COW from)")
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
        order — the reference's registry, plus the port's ``device`` and
        ``kernel_launches`` and ``step_graphs``
        (``obs.schema.PORT_EXTRAS``).  All metrics
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
        f("substrate", "sequence-state substrate serving this model: "
          "attention block tables, recurrent state slabs, or the hybrid "
          "of both", lambda: self.substrate.kind, typ=str)
        f("recurrent_steps", "fixed-shape recurrent dispatches",
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
        f("step_graphs", "the compiled step: whether steps run as CUDA "
          "graphs, the step keys seen, and the keys' eager first calls, "
          "captures and replays since start/reset",
          lambda: {"enabled": self.graphs.capture,
                   "keys": len(self.graphs.keys),
                   "first_calls": self.graphs.first_calls,
                   "captures": self.graphs.captures,
                   "replays": self.graphs.replays}, typ=dict)
        if self.pool is not None:
            self._register_pool_metrics()
        if self.state_pool is not None:
            self._register_state_pool_metrics()
        if self.pool is not None and self.pool.cache is not None:
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
            f("profile", "torch.profiler capture and per-shape cost "
              "analysis (dynamic keys; present only when profiling is on)",
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

    def _register_state_pool_metrics(self) -> None:
        """The fixed-slab substrate's section, the recurrent counterpart
        of ``pool.*``."""
        f, sp = self.metrics.func, self.state_pool
        f("state_pool.num_slabs", "slab capacity (incl. trash slab 0)",
          lambda: sp.num_slabs, typ=int)
        f("state_pool.scale_exp", "fixed Eq.-1 scale exponent slabs are "
          "allocated with (0 when slabs store fp32 state)",
          lambda: sp.default_scale_exp, typ=int)
        f("state_pool.state_quant_ops_per_step", "ops to requantize one "
          "sequence's WHOLE state once — paid per step, context-free",
          lambda: self._state_elems_per_step, typ=int)
        f("state_pool.requant_ops_state", "whole-slab state requant ops "
          "booked so far (performed when slabs are int8, counterfactual "
          "otherwise) — the recurrent share of hwcost totals",
          lambda: self.requant_ops_state, kind="counter", typ=int)

        def state_ops_per_token():
            tok = self.energy.tokens["prefill"] + self.energy.tokens[
                "decode"]
            return round(self.requant_ops_state / tok, 2) if tok else None

        f("state_pool.state_ops_per_token", "recurrent-substrate share "
          "of hwcost.requant_ops_per_token — context-free by "
          "construction", state_ops_per_token, typ=float, optional=True)
        f("state_pool.peak_live_slabs", "max simultaneously-live slabs",
          lambda: sp.stats.peak_live, typ=int)
        f("state_pool.utilization", "live slabs / allocatable slabs now",
          lambda: round(sp.utilization, 3), typ=float)
        f("state_pool.allocs", "slabs handed out",
          lambda: sp.stats.allocs, kind="counter", typ=int)
        f("state_pool.frees", "slab references released",
          lambda: sp.stats.frees, kind="counter", typ=int)
        f("state_pool.seq_evictions", "sequences preempted off slabs",
          lambda: sp.stats.seq_evictions, kind="counter", typ=int)
        f("state_pool.alloc_failures", "slab allocations refused",
          lambda: sp.stats.alloc_failures, kind="counter", typ=int)

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
          "KV+state requant ops (performed + avoided counterfactual) "
          "per useful token",
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
