"""Continuous-batching step loop over the paged int8-KV block pool
(PyTorch counterpart of ``repro.serving.engine`` on its default path).

Every engine step flattens the whole mixed work-list — prefill chunks
under the shared token budget and one decode row per decoding request —
into a single (T,) token stream with per-sequence descriptors, and serves
it with one ``models.model.ragged_step`` (one ragged attention kernel
launch per layer) followed by on-device sampling; only the sampled
tokens cross to the host.  Padded stream lengths are powers of two from
8 up to the step's worst case, so step shapes stay O(few).

The host-side pool, prefix cache and scheduler are the JAX package's
numpy modules, copied unchanged.  The device pool is updated in place:
the scatter writes each token's codes into its row and copy-on-write
duplicates one block's rows, where the JAX engine donates the buffer.

Not ported yet, and raising ``NotImplementedError``: speculative decoding
(``spec_k > 0``), the legacy per-shape steps (``ragged=False``), the
recurrent / hybrid substrates, and the observability options (``trace``,
``record``, ``slo``).
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
from repro_torch.models import model as M
from repro_torch.models.attention import RaggedBatch
from repro_torch.serving.kv_pool import TRASH_BLOCK, BlockPool
from repro_torch.serving.scheduler import Request, RequestState, Scheduler
from repro_torch.serving.spec import apply_top_k, verify_tokens
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
    """Per-shape first-call vs steady step time, keyed
    ``ragged_{T}xS{S}`` by the dispatched stream shape.  ``p99_s`` needs
    at least two steady samples."""
    shapes: dict = {}
    for shape, ts in sorted(step_times.items(), key=lambda kv: str(kv[0])):
        steady_ts = ts[1:]
        steady = float(np.median(steady_ts)) if steady_ts else None
        p99 = _pct(steady_ts, 99) if len(steady_ts) >= 2 else None
        shapes[f"ragged_{shape[1]}xS{shape[2]}"] = {
            "calls": len(ts),
            "first_s": round(ts[0], 4) if ts else None,
            "steady_s": round(steady, 4) if steady is not None else None,
            "p99_s": round(p99, 4) if p99 is not None else None}
    return shapes


def _unported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported to repro_torch yet "
                              f"(ROADMAP Queue 1 item {item})")


class ServingEngine:
    """Continuous-batching serving engine on the unified ragged step."""

    def __init__(self, cfg: ModelConfig, params: Any, ctx: QuantContext, *,
                 n_slots: int = 4, block_size: int = 16,
                 max_model_len: int = 128,
                 num_blocks: Optional[int] = None, chunk: int = 16,
                 prefill_token_budget: Optional[int] = None,
                 top_k: int = 0, seed: int = 0,
                 prefix_cache: Optional[bool] = None, spec_k: int = 0,
                 ragged: bool = True, trace: bool = False,
                 record: bool = False, slo=None, device=None):
        sub = substrate_for(cfg)
        if sub.kind != "attention":
            _unported(f"the {sub.kind} substrate", "9")
        if spec_k:
            _unported("speculative decoding (spec_k > 0)", "4")
        if not ragged:
            _unported("the legacy per-shape steps (ragged=False)", "8")
        if trace or record or slo is not None:
            _unported("tracing, the flight recorder and SLO monitoring", "6")
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
        budget = self.sched.prefill_token_budget
        self._t_max = max(8, -(-(budget + n_slots) // 8) * 8)
        self.ragged_steps = 0
        self.decode_steps = 0
        self.prefill_chunks = 0
        self.dispatched_tokens = 0
        self.padded_tokens = 0
        self.cache_hit_prefill_tokens = 0
        self.launches = {name: 0 for name in kops.LAUNCHES}
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
        """One engine iteration: admit, then ONE unified dispatch."""
        for req in self.sched.admit(self._now()):
            # cached-prefix hit: those tokens' KV is already resident
            self.cache_hit_prefill_tokens += req.n_prefilled
        self._run_ragged_step()

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
        token.  Growth/CoW for a later request may preempt an earlier one,
        so planned items are re-validated before the arrays are built."""
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

        planned = set()
        for req in list(self.sched.decode_reqs()):
            if req.slot is None or req.state is not RequestState.DECODE:
                continue
            if not self.sched.grow_for_decode(req, now):
                continue                    # req itself was preempted
            planned.add(req.rid)

        prefill_items = [
            (r, s, c) for (r, s, c) in prefill_items
            if r.slot is not None and r.state is RequestState.PREFILL
            and r.n_prefilled == s]
        decode_items = [r for r in self.sched.decode_reqs()
                        if r.rid in planned]
        if not prefill_items and not decode_items:
            return

        # -- build the flattened stream + descriptors ---------------------
        bs = self.pool.block_size
        nbmax = self.sched.nbmax
        s_pad = self.n_slots
        t_real = sum(c for (_, _, c) in prefill_items) + len(decode_items)
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
        fed: list[np.ndarray] = []
        off = 0
        work = [(r, (s, c)) for (r, s, c) in prefill_items] \
            + [(r, None) for r in decode_items]
        for i, (req, item) in enumerate(work):
            if item is not None:
                start, c_real = item
                toks_i = np.asarray(req.feed[start:start + c_real], np.int32)
                pos_i = start + np.arange(c_real, dtype=np.int32)
                sample_start[i] = off + c_real - 1     # last real row
            else:
                toks_i = np.asarray([req.generated[-1]], np.int32)
                pos_i = np.asarray([req.n_ctx], np.int32)
                sample_start[i] = off                  # fed-token row
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
        out = self._dispatch_ragged(tokens, positions, dest, bt, q_start,
                                    q_len, kv_len, temps, topks,
                                    sample_start)
        self.ragged_steps += 1
        self.dispatched_tokens += t_pad
        self.padded_tokens += t_pad - t_real
        now = self._now()

        for i, (req, start, c_real) in enumerate(prefill_items):
            req.n_prefilled += c_real
            req.n_ctx = req.n_prefilled
            self.pool.commit(req.rid, start, req.feed[start:start + c_real])
            self.prefill_chunks += 1
            if req.n_prefilled == len(req.feed):
                tok = int(out[i, 0])
                if req.t_first is None:
                    req.t_first = now
                done = req.finished_by(tok, self.max_model_len)
                req.generated.append(tok)
                if done:
                    self.sched.finish(req, now)
                else:
                    req.state = RequestState.DECODE

        if decode_items:
            self.decode_steps += 1
        for j, req in enumerate(decode_items):
            i = len(prefill_items) + j
            self.pool.commit(req.rid, req.n_ctx, [int(fed[i][0])])
            req.n_ctx += 1
            tok = int(out[i, 0])
            done = req.finished_by(tok, self.max_model_len)
            req.generated.append(tok)
            if done:
                self.sched.finish(req, now)

    def _dispatch_ragged(self, tokens, positions, dest, bt, q_start, q_len,
                         kv_len, temps, topks, sample_start) -> np.ndarray:
        """One unified step + on-device sampling + the host sync, timed
        under the work-list shape key ``("ragged", T_pad, S_pad)``.
        Returns the sampled tokens (S, 1) on the host."""
        t0 = time.perf_counter()
        dev = self.device

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        rb = RaggedBatch(dest=put(dest), block_tables=put(bt),
                         q_start=put(q_start), q_len=put(q_len),
                         kv_len=put(kv_len))
        tok_t = put(tokens)
        logits, self.cache = M.ragged_step(self.params, tok_t, self.cache,
                                           put(positions), rb, self.cfg,
                                           self.ctx)
        t = logits.shape[0]
        idx = torch.clamp(put(sample_start).long()[:, None], 0, t - 1)
        rows = logits[idx]                               # (S, 1, V)
        cap = int(topks.max()) if topks.any() else None
        topks_arg = put(topks) if topks.any() else None
        out, _ = verify_tokens(rows, tok_t[idx], torch.zeros_like(idx[:, 0]),
                               self.generator, put(temps), topks_arg,
                               k_cap=cap)
        out = out.cpu().numpy()                          # host sync
        shape_key = ("ragged", len(tokens), len(temps))
        self._step_times.setdefault(shape_key, []).append(
            time.perf_counter() - t0)
        return out

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
            "ragged_steps": self.ragged_steps,
            "decode_steps": self.decode_steps,
            "prefill_chunks": self.prefill_chunks,
            "dispatched_tokens": self.dispatched_tokens,
            "padded_tokens": self.padded_tokens,
            "padding_frac": (round(self.padded_tokens
                                   / self.dispatched_tokens, 4)
                             if self.dispatched_tokens else None),
            "step_shapes": summarize_step_times(self._step_times),
            "kernel_launches": dict(self.launches),
            "prefix_cache": None if cs is None else {
                "hits": cs.hits, "misses": cs.misses,
                "cached_prefill_tokens": self.cache_hit_prefill_tokens,
                "cow_copies": cs.cow_copies},
        }
