"""Structured event tracing for the serving engine (DESIGN §14).

Two complementary stores, one object:

* **Event ring** — a bounded ``collections.deque`` of span/instant
  events covering the span taxonomy in DESIGN §14: scheduler admission,
  chunked-prefill planning, preemption, CoW retries, ``grow_for_spec``
  degradation, pool alloc/free/evict/retract, prefix-cache
  hit/miss/publish, and every jitted dispatch (stream shape, real vs
  padded token counts, compile-vs-steady flag).  The ring NEVER grows
  past ``capacity``: old events drop (counted in ``dropped``) instead
  of growing the host heap on a long-lived server.  With
  ``enabled=False`` every recording call is one attribute test — the
  overhead gate in ``serving_bench --check`` holds the whole disabled
  layer under 1% of a steady engine step.
* **Per-request timelines** — arrival → admission → first prefill
  chunk → first token (TTFT) → per-token (ring-gated) → done.  These
  are a handful of floats per request, always on, and are the SOURCE
  for the report's ``timeline`` latency section: TTFT/TPOT/e2e
  percentiles are *derived from the trace* and cross-checked against
  the legacy request-timestamp lists (``tests/test_obs.py``,
  ``serving_bench --check``).

Export is Chrome trace-event JSON (the Perfetto-loadable subset:
``X``/``i``/``M`` phases, microsecond timestamps), see
:meth:`Tracer.to_chrome` and ``examples/inspect_trace.py``.

Pure Python (stdlib only) — safe to import from the host modules
(kv_pool / scheduler / prefix_cache carry an optional tracer).  A copy
of ``repro.obs.trace``, held to the same behaviour by
``tests/test_torch_obs.py``.
"""
from __future__ import annotations

import dataclasses
import json
import time
from collections import deque
from typing import Any, Callable, Optional

__all__ = ["Tracer", "Timeline", "validate_chrome_trace",
           "CHROME_REQUIRED_KEYS", "DECISION_CATS"]

# Perfetto lanes (tids) per subsystem: stable small ints so a trace of
# one engine renders as a fixed set of named tracks.
LANES = {"engine": 0, "dispatch": 1, "sched": 2, "pool": 3, "cache": 4,
         "requests": 5, "profile": 6, "slo": 7}

# Event categories that constitute the scheduler-decision stream: what
# the flight recorder (obs/replay.py) captures losslessly and diffs
# between a recorded run and its replay.  Admission order, chunk
# boundaries, preemptions, spec degradation, pool alloc/CoW/retract and
# prefix-cache hit/publish all live here.
DECISION_CATS = ("sched", "pool", "cache")

CHROME_REQUIRED_KEYS = ("name", "ph", "ts", "pid", "tid")


@dataclasses.dataclass
class Timeline:
    """One request's lifecycle marks on the engine clock (seconds).
    ``None`` marks simply never happened (e.g. an unfinished request at
    report time)."""
    rid: int
    arrival: float
    admit: Optional[float] = None
    first_chunk: Optional[float] = None
    first_token: Optional[float] = None
    done: Optional[float] = None
    n_generated: int = 0
    preemptions: int = 0
    tokens: list = dataclasses.field(default_factory=list)

    @property
    def ttft(self) -> Optional[float]:
        return None if self.first_token is None \
            else self.first_token - self.arrival

    @property
    def e2e(self) -> Optional[float]:
        return None if self.done is None else self.done - self.arrival

    @property
    def tpot(self) -> Optional[float]:
        """Per-output-token time, same definition as the legacy report:
        (done - first_token) / (n_generated - 1)."""
        if self.done is None or self.first_token is None \
                or self.n_generated < 2:
            return None
        return (self.done - self.first_token) / (self.n_generated - 1)


class Tracer:
    """Ring-buffered structured events + always-on request timelines."""

    def __init__(self, *, capacity: int = 65536,
                 clock: Optional[Callable[[], float]] = None,
                 enabled: bool = False):
        if capacity < 1:
            raise ValueError("trace ring needs capacity >= 1")
        self.capacity = capacity
        self.clock = clock or time.perf_counter
        self.enabled = enabled
        self.events: deque = deque(maxlen=capacity)
        self.n_emitted = 0
        self.timelines: dict[int, Timeline] = {}
        # Optional UNBOUNDED side-channel for the flight recorder: when
        # set (a list), every event whose category is in DECISION_CATS
        # is also appended as (name, args) — no timestamp, so two runs
        # of the same workload compare by decision order and content,
        # not wall clock.  The ring may drop events under load; the
        # decision sink never does (record mode only, bounded by the
        # workload's own decision count).
        self.decision_sink: Optional[list] = None

    # -- ring events ------------------------------------------------------

    @property
    def dropped(self) -> int:
        """Events evicted from the ring (bounded-memory guarantee)."""
        return self.n_emitted - len(self.events)

    def event(self, name: str, cat: str, *, ts: Optional[float] = None,
              args: Optional[dict] = None) -> None:
        """Instant event (phase ``i``).  ``ts`` on the tracer clock,
        seconds; defaults to now."""
        if not self.enabled:
            return
        if self.decision_sink is not None and cat in DECISION_CATS:
            self.decision_sink.append((name, args))
        self.n_emitted += 1
        self.events.append(
            ("i", name, cat, self.clock() if ts is None else ts, 0.0,
             args))

    def span(self, name: str, cat: str, ts: float, dur: float,
             args: Optional[dict] = None) -> None:
        """Complete span (phase ``X``): started at ``ts``, lasted
        ``dur`` seconds.  Recorded after the fact — the engine times its
        dispatches anyway, so spans cost one append, not two."""
        if not self.enabled:
            return
        self.n_emitted += 1
        self.events.append(("X", name, cat, ts, dur, args))

    # -- request timelines (always on) ------------------------------------

    def req_submit(self, rid: int, arrival: float) -> None:
        """First submission creates the timeline; a re-queue after
        preemption keeps the original marks."""
        if rid not in self.timelines:
            self.timelines[rid] = Timeline(rid=rid, arrival=arrival)

    def req_mark(self, rid: int, mark: str, t: float) -> None:
        """Set a lifecycle mark once (first occurrence wins — a resumed
        request's re-admission is not its admission latency)."""
        tl = self.timelines.get(rid)
        if tl is not None and getattr(tl, mark) is None:
            setattr(tl, mark, t)

    def req_preempt(self, rid: int) -> None:
        tl = self.timelines.get(rid)
        if tl is not None:
            tl.preemptions += 1

    def req_token(self, rid: int, t: float) -> None:
        """Per-token mark — ring-gated (full inter-token detail only
        when tracing is on; TTFT/TPOT need only the lifecycle marks)."""
        if self.enabled:
            tl = self.timelines.get(rid)
            if tl is not None:
                tl.tokens.append(t)

    def req_done(self, rid: int, t: float, n_generated: int) -> None:
        tl = self.timelines.get(rid)
        if tl is not None and tl.done is None:
            tl.done = t
            tl.n_generated = n_generated

    # -- derivation -------------------------------------------------------

    def derive_latencies(self) -> dict[str, list]:
        """TTFT / TPOT / e2e sample lists derived from the COMPLETED
        request timelines — the trace-derived counterpart of the legacy
        ``report()`` percentile inputs.

        Contract (vs ``obs.metrics.Histogram.percentile``): these are
        EXACT raw samples — percentiles computed from them (the
        engine's ``timeline`` report section) interpolate between true
        observations.  A ``Histogram`` only retains bucket counts, so
        its ``percentile`` returns the UPPER BOUND of the bucket
        holding the rank — biased high by at most one bucket width.
        Reports must never swap one for the other silently; the
        pinning test is ``tests/test_obs.py::
        test_histogram_percentile_vs_exact_error_bound``."""
        ttft = [tl.ttft for tl in self.timelines.values()
                if tl.ttft is not None]
        tpot = [tl.tpot for tl in self.timelines.values()
                if tl.tpot is not None]
        e2e = [tl.e2e for tl in self.timelines.values()
               if tl.e2e is not None]
        return {"ttft": ttft, "tpot": tpot, "e2e": e2e}

    def reset(self) -> None:
        self.events.clear()
        self.n_emitted = 0
        self.timelines.clear()
        if self.decision_sink is not None:
            self.decision_sink.clear()

    # -- chrome trace export ----------------------------------------------

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON object (Perfetto: open ui.perfetto.dev
        and drop the file).  Ring events become ``i``/``X`` events on
        per-subsystem lanes; request timelines render as one span per
        request on the ``requests`` lane with TTFT marked as an instant
        event, so queueing, prefill and decode phases line up against
        the dispatch spans that served them."""
        us = 1e6
        ev: list[dict] = []
        ev.append({"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
                   "ts": 0, "args": {"name": "repro-serving-engine"}})
        for lane, tid in LANES.items():
            ev.append({"name": "thread_name", "ph": "M", "pid": 0,
                       "tid": tid, "ts": 0, "args": {"name": lane}})
        for ph, name, cat, ts, dur, args in self.events:
            e = {"name": name, "cat": cat, "ph": ph, "pid": 0,
                 "tid": LANES.get(cat, LANES["engine"]),
                 "ts": round(ts * us, 3)}
            if ph == "X":
                e["dur"] = round(dur * us, 3)
            if ph == "i":
                e["s"] = "t"                 # thread-scoped instant
            if args:
                e["args"] = args
            ev.append(e)
        for tl in self.timelines.values():
            start = tl.admit if tl.admit is not None else tl.arrival
            end = tl.done if tl.done is not None else \
                (tl.tokens[-1] if tl.tokens else start)
            args = {"rid": tl.rid, "arrival_s": tl.arrival,
                    "n_generated": tl.n_generated,
                    "preemptions": tl.preemptions}
            if tl.ttft is not None:
                args["ttft_s"] = round(tl.ttft, 6)
            if tl.tpot is not None:
                args["tpot_s"] = round(tl.tpot, 6)
            ev.append({"name": f"req {tl.rid}", "cat": "request",
                       "ph": "X", "pid": 0, "tid": LANES["requests"],
                       "ts": round(start * us, 3),
                       "dur": round(max(end - start, 0.0) * us, 3),
                       "args": args})
            if tl.first_token is not None:
                ev.append({"name": f"first_token rid={tl.rid}",
                           "cat": "request", "ph": "i", "s": "t",
                           "pid": 0, "tid": LANES["requests"],
                           "ts": round(tl.first_token * us, 3)})
        return {"traceEvents": ev, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped,
                              "ring_capacity": self.capacity}}

    def export(self, path: str) -> dict:
        """Write the Chrome trace to ``path``; returns the object."""
        obj = self.to_chrome()
        with open(path, "w") as f:
            json.dump(obj, f)
        return obj


def validate_chrome_trace(obj: Any) -> list[str]:
    """Schema check against the Chrome trace-event format (the subset
    Perfetto's JSON importer requires).  Returns a list of problems —
    empty means loadable.  Used by ``tests/test_obs.py`` and the bench
    gate, so a malformed exporter fails CI instead of Perfetto.

    Deliberately order-agnostic: the format does not require sorted
    timestamps (Perfetto sorts on import), so out-of-order ``ts`` is
    valid.  An empty ``traceEvents`` list and an events-only trace
    (instants, no ``X`` spans) are both valid too."""
    problems: list[str] = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["top level must be an object with a 'traceEvents' list"]
    events = obj["traceEvents"]
    if not isinstance(events, list):
        return ["'traceEvents' must be a list"]
    try:
        json.dumps(obj)
    except (TypeError, ValueError) as e:
        problems.append(f"not JSON-serializable: {e}")
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            problems.append(f"event {i} is not an object")
            continue
        for k in CHROME_REQUIRED_KEYS:
            if k not in e:
                problems.append(f"event {i} ({e.get('name')!r}) "
                                f"missing required key {k!r}")
        ph = e.get("ph")
        if ph not in ("X", "i", "B", "E", "M", "C"):
            problems.append(f"event {i} has unknown phase {ph!r}")
        if ph == "X" and "dur" not in e:
            problems.append(f"event {i} ({e.get('name')!r}) is a "
                            f"complete span without 'dur'")
        ts = e.get("ts")
        if ts is not None and not isinstance(ts, (int, float)):
            problems.append(f"event {i} ts is not numeric")
    return problems
