"""Workload flight recorder: deterministic capture + replay
(DESIGN §15).

**Capture.**  An engine built with ``record=True`` runs under a
deterministic VIRTUAL clock (``engine.virtual_dt`` seconds per step,
idle gaps jump straight to the next arrival) and tees every
scheduler-decision event — admission order, prefill chunk boundaries,
preemptions, spec degradation, pool alloc/CoW/retract, prefix-cache
hit/publish (``trace.DECISION_CATS``) — into an unbounded decision
sink next to the bounded trace ring.  :func:`capture_workload` then
freezes the run into a portable :class:`WorkloadRecord`: arrival
process, prompt token ids, sampling params, seeds, spec-k, an engine
config fingerprint, the emitted tokens, the decision stream and the
per-request timelines.  Because arrival→admission composition depends
only on the virtual clock, the capture run is itself exactly
reproducible — which is what makes the replay contract below testable
at all (a wall-clock capture's admissions would race the scheduler).

**Replay.**  :func:`replay_workload` re-injects the recorded arrival
process into a fresh ``record=True`` engine (same virtual clock, same
seeds: the engine's sampling stream restarts from its seed) and checks two
things: the emitted tokens are IDENTICAL per request, and the
scheduler-decision diff (:func:`diff_decisions`, a unified diff over
canonicalized ``(name, args)`` lines — timestamps excluded by
construction) is EMPTY.  Replaying against a *different* engine config
(ragged vs legacy, W8A8 on/off, spec on/off) turns the same record
into an A/B harness: the token parity check still holds at greedy fp32
while the decision diff localizes exactly where the two schedulers
diverged.

Pure Python (stdlib only): the record is plain JSON, and this module
imports only ``repro_torch.serving.scheduler.Request`` (host-side) to
rebuild the workload.  A copy of ``repro.obs.replay``: a record's
format is the same in both packages, so a record taken on one replays
on the other.  The fingerprint hashes the engine's ``ModelConfig``,
which holds fewer fields in the port, so a cross-package replay reports
``fingerprint_match=False`` and runs with ``strict_fingerprint=False``.
The port's engine samples from a ``torch.Generator`` seeded from the
engine's seed (re-seeded by ``reset_metrics``), so a replay on the port
is token-identical for sampled requests too; across packages only
greedy requests can be.
"""
from __future__ import annotations

import dataclasses
import difflib
import hashlib
import json
import numbers
from typing import Any, Optional

__all__ = ["WorkloadRecord", "ReplayResult", "RECORD_VERSION",
           "engine_settings", "engine_fingerprint", "capture_workload",
           "build_requests", "decision_lines", "diff_decisions",
           "replay_workload"]

RECORD_VERSION = 1

# immutable Request fields that define the workload
_REQUEST_FIELDS = ("rid", "prompt", "max_new_tokens", "temperature",
                   "top_k", "stop_token", "arrival")
_TIMELINE_MARKS = ("arrival", "admit", "first_chunk", "first_token",
                   "done", "n_generated", "preemptions")


def _canon(v: Any) -> Any:
    """JSON-stable canonical form: numpy scalars become python
    ints/floats (a loaded record must compare equal to a live one),
    floats round to 9 places, containers recurse."""
    if v is None or isinstance(v, (bool, str)):
        return v
    if isinstance(v, numbers.Integral):
        return int(v)
    if isinstance(v, numbers.Real):
        return round(float(v), 9)
    if isinstance(v, dict):
        return {str(k): _canon(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_canon(x) for x in v]
    return str(v)


# -- engine identity -------------------------------------------------------

def engine_settings(engine) -> dict:
    """The portable engine/scheduler configuration a replay needs to
    reconstruct an equivalent engine (and the fingerprint input)."""
    pool = engine.pool
    s = {
        "model": dataclasses.asdict(engine.cfg),
        "n_slots": engine.n_slots,
        "block_size": pool.block_size if pool is not None else None,
        "num_blocks": pool.num_blocks if pool is not None else None,
        "max_model_len": engine.max_model_len,
        "chunk": engine.sched.chunk,
        "prefill_token_budget": engine.sched.prefill_token_budget,
        "default_top_k": engine.default_top_k,
        "seed": engine.seed,
        "prefix_cache": pool is not None and pool.cache is not None,
        "spec_k": engine.spec_k,
        "drafter": type(engine.drafter).__name__,
        "ragged": engine.ragged,
        "virtual_dt": engine.virtual_dt,
    }
    # substrate keys ride along ONLY off the attention substrate, so
    # every pre-§16 transformer fingerprint stays byte-identical
    sub = getattr(engine, "substrate", None)
    if sub is not None and sub.kind != "attention":
        s["substrate"] = sub.kind
        s["num_slabs"] = engine.state_pool.num_slabs
        s["state_scale_exp"] = engine.state_pool.default_scale_exp
    return _canon(s)


def engine_fingerprint(engine) -> str:
    """Short stable hash of :func:`engine_settings` — two engines with
    the same fingerprint must schedule a recorded workload
    identically."""
    blob = json.dumps(engine_settings(engine), sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


# -- the record ------------------------------------------------------------

@dataclasses.dataclass
class WorkloadRecord:
    """One captured serving run, JSON-portable."""
    version: int
    fingerprint: str
    engine: dict                 # engine_settings() of the capture engine
    requests: list               # [{rid, prompt, ..., arrival}, ...]
    outputs: dict                # rid -> [token, ...]
    decisions: list              # [[name, args], ...] in emission order
    timelines: dict              # rid -> lifecycle marks (virtual clock)
    meta: dict                   # run-level scalars (steps, tokens, ...)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["outputs"] = {str(k): v for k, v in d["outputs"].items()}
        d["timelines"] = {str(k): v for k, v in d["timelines"].items()}
        return d

    @classmethod
    def from_json(cls, obj: dict) -> "WorkloadRecord":
        if obj.get("version") != RECORD_VERSION:
            raise ValueError(
                f"workload record version {obj.get('version')!r} != "
                f"supported {RECORD_VERSION}")
        return cls(
            version=obj["version"], fingerprint=obj["fingerprint"],
            engine=obj["engine"], requests=obj["requests"],
            outputs={int(k): list(v)
                     for k, v in obj["outputs"].items()},
            decisions=[[n, a] for n, a in obj["decisions"]],
            timelines={int(k): v for k, v in obj["timelines"].items()},
            meta=obj.get("meta", {}))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)

    @classmethod
    def load(cls, path: str) -> "WorkloadRecord":
        with open(path) as f:
            return cls.from_json(json.load(f))


def _serial_requests(requests) -> list:
    out = []
    for r in sorted(requests, key=lambda r: (r.arrival, r.rid)):
        d = {f: getattr(r, f) for f in _REQUEST_FIELDS}
        d["prompt"] = [int(t) for t in r.prompt]
        out.append(_canon(d))
    return out


def _serial_outputs(outputs) -> dict:
    return {int(rid): [int(t) for t in toks]
            for rid, toks in outputs.items()}


def capture_workload(engine, requests) -> WorkloadRecord:
    """Freeze a finished ``record=True`` run into a
    :class:`WorkloadRecord`.  Call after ``engine.run(requests)`` and
    before any ``reset_metrics`` (which clears the decision sink)."""
    if not getattr(engine, "record", False):
        raise ValueError("capture needs ServingEngine(record=True) — a "
                         "wall-clock run is not deterministically "
                         "replayable")
    sink = engine.tracer.decision_sink
    if sink is None:
        raise ValueError("engine has no decision sink — was the tracer "
                         "replaced after construction?")
    timelines = {
        int(rid): _canon({m: getattr(tl, m) for m in _TIMELINE_MARKS})
        for rid, tl in engine.tracer.timelines.items()}
    return WorkloadRecord(
        version=RECORD_VERSION,
        fingerprint=engine_fingerprint(engine),
        engine=engine_settings(engine),
        requests=_serial_requests(requests),
        outputs=_serial_outputs(engine.outputs()),
        decisions=[[name, _canon(args) if args else {}]
                   for name, args in sink],
        timelines=timelines,
        meta=_canon({
            "n_requests": len(requests),
            "n_decisions": len(sink),
            "decode_steps": engine.decode_steps,
            "ragged_steps": engine.ragged_steps,
            "recurrent_steps": engine.recurrent_steps,
            "prefill_chunks": engine.prefill_chunks,
            "wall_s_virtual": engine._wall_s,
        }))


def build_requests(record: WorkloadRecord) -> list:
    """Materialize the recorded arrival process as fresh Request
    objects (imported lazily: keeps ``repro.obs`` importable without
    the serving package on the path)."""
    from repro_torch.serving.scheduler import Request
    return [Request(rid=d["rid"], prompt=list(d["prompt"]),
                    max_new_tokens=d["max_new_tokens"],
                    temperature=d["temperature"], top_k=d["top_k"],
                    stop_token=d["stop_token"], arrival=d["arrival"])
            for d in record.requests]


# -- decision diff ---------------------------------------------------------

def decision_lines(decisions) -> list[str]:
    """Canonical one-line form of each decision: ``name k=v k=v`` with
    sorted keys and JSON-canonical values.  No timestamps — replay
    equivalence is about order and content, not wall clock."""
    out = []
    for name, args in decisions:
        if args:
            kv = " ".join(
                f"{k}={json.dumps(_canon(v), sort_keys=True)}"
                for k, v in sorted(args.items()))
            out.append(f"{name} {kv}")
        else:
            out.append(str(name))
    return out


def diff_decisions(a, b, *, label_a: str = "recorded",
                   label_b: str = "replayed") -> list[str]:
    """Unified diff between two decision streams; ``[]`` means the two
    runs made IDENTICAL scheduling decisions in the same order."""
    return list(difflib.unified_diff(
        decision_lines(a), decision_lines(b),
        fromfile=label_a, tofile=label_b, lineterm=""))


# -- replay ----------------------------------------------------------------

@dataclasses.dataclass
class ReplayResult:
    """Outcome of one :func:`replay_workload` call."""
    report: dict
    outputs: dict                  # rid -> [token, ...] from the replay
    token_identical: bool
    mismatched_rids: list
    decision_diff: list            # unified-diff lines; [] == identical
    fingerprint_match: bool
    record_fingerprint: str
    engine_fingerprint: str

    @property
    def ok(self) -> bool:
        """Token-identical AND decision-identical."""
        return self.token_identical and not self.decision_diff


def replay_workload(record: WorkloadRecord, engine, *,
                    strict_fingerprint: bool = False) -> ReplayResult:
    """Re-inject ``record``'s arrival process into ``engine`` and
    compare outcomes.

    The engine must be ``record=True`` (virtual clock + decision sink)
    and drained; its metrics/tracer/prefix-cache are reset so the
    replay starts from the same cold state as the capture.  With
    ``strict_fingerprint`` a config mismatch raises instead of being
    reported — use the default (False) for deliberate A/B replays
    across engine configs."""
    if not getattr(engine, "record", False):
        raise ValueError("replay needs ServingEngine(record=True)")
    fp = engine_fingerprint(engine)
    match = fp == record.fingerprint
    if strict_fingerprint and not match:
        raise ValueError(
            f"engine fingerprint {fp} != record {record.fingerprint} "
            f"(pass strict_fingerprint=False for A/B replays)")
    engine.reset_metrics(flush_cache=True)
    report = engine.run(build_requests(record))
    outputs = _serial_outputs(engine.outputs())
    mism = sorted(
        (set(record.outputs) ^ set(outputs))
        | {rid for rid in set(record.outputs) & set(outputs)
           if record.outputs[rid] != outputs[rid]})
    diff = diff_decisions(record.decisions,
                          engine.tracer.decision_sink)
    return ReplayResult(
        report=report, outputs=outputs,
        token_identical=not mism, mismatched_rids=mism,
        decision_diff=diff, fingerprint_match=match,
        record_fingerprint=record.fingerprint,
        engine_fingerprint=fp)
