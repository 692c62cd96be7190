"""The port's observability package against the JAX package's.

``repro_torch.obs`` keeps its own copies of ``repro.obs``'s stdlib-only
modules (metrics registry, tracer, SLO monitor, schema, flight recorder)
and an ``EnergyAccount`` / ``Profiler`` of its own.  Every unit case
below runs against both packages as one parametrised test, so the copies
are held to the reference's behaviour; a cross-check feeds both the same
events and compares their Prometheus text and Chrome traces byte for
byte.  The port-only cases drive the port's engine on the CPU: turning
observability on changes no token and no counter, ``torch.profiler``
capture annotates every dispatch, ``reset_metrics`` re-seeds sampling so
a sampled record replays exactly, and ``profile_cost`` raises.
"""
import dataclasses
import importlib
import json
import math
import types

import numpy as np
import pytest
import torch

PKGS = ("repro", "repro_torch")


@pytest.fixture(params=PKGS)
def pkg(request):
    if request.param == "repro":
        pytest.importorskip("jax")
    mods = {name: importlib.import_module(f"{request.param}.obs.{name}")
            for name in ("metrics", "trace", "slo", "schema", "replay",
                         "profile")}
    mods["hwcost"] = importlib.import_module(f"{request.param}.core.hwcost")
    mods["name"] = request.param
    return types.SimpleNamespace(**mods)


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

def test_counter_unlabeled_and_labeled(pkg):
    c = pkg.metrics.Counter("x.ops", "ops", label_names=("phase",))
    c.inc(3, phase="prefill")
    c.inc(2, phase="decode")
    c.inc(1, phase="prefill")
    assert c.get() == 6
    assert c.get(phase="prefill") == 4
    assert c.value() == {"phase=decode": 2, "phase=prefill": 4}
    c.reset()
    assert c.get() == 0 and c.value() == {}
    u = pkg.metrics.Counter("y", "plain")
    u.inc()
    u.inc(4)
    assert u.value() == 5


def test_gauge_and_func_metric(pkg):
    g = pkg.metrics.Gauge("g", "a gauge")
    g.set(2.5)
    g.add(0.5)
    assert g.value() == 3.0
    src = {"v": 7}
    f = pkg.metrics.FuncMetric("f", "bound", lambda: src["v"],
                               kind="counter")
    assert f.value() == 7
    src["v"] = 9
    assert f.value() == 9          # read at snapshot time, not bind time
    f.reset()                      # bound metrics follow their source
    assert f.value() == 9
    with pytest.raises(ValueError):
        pkg.metrics.FuncMetric("f", "bad kind", lambda: 0, kind="summary")


def test_histogram_percentile_upper_bound_never_interpolates(pkg):
    h = pkg.metrics.Histogram("h", "lat", buckets=[0.001, 0.01, 0.1])
    assert h.percentile(50) is None
    for v in (0.0005, 0.002, 0.003, 0.05):
        h.observe(v)
    assert h.n == 4
    assert h.percentile(50) == 0.01
    assert h.percentile(99) == 0.1
    h.observe(5.0)                 # lands in +Inf
    assert h.percentile(99) == math.inf
    val = h.value()
    assert val["count"] == 5 and val["buckets"]["+Inf"] == 1


def test_registry_rejects_duplicates_and_undocumented(pkg):
    m = pkg.metrics.MetricsRegistry()
    m.counter("a", "doc")
    with pytest.raises(ValueError):
        m.counter("a", "again")
    with pytest.raises(ValueError):
        m.counter("b", "")
    assert "a" in m and len(m) == 1


def test_registry_alias_check_is_deferred(pkg):
    m = pkg.metrics.MetricsRegistry()
    m.func("view.n", "view", lambda: 0, alias_of="canon.n")
    with pytest.raises(ValueError):
        m.check_aliases()
    m.func("canon.n", "canonical", lambda: 0)
    m.check_aliases()


def test_registry_nested_and_reset_owned_only(pkg):
    m = pkg.metrics.MetricsRegistry()
    m.counter("top", "t")
    m.counter("sec.a", "a")
    m.gauge("sec.deep.b", "b")
    src = {"v": 3}
    m.func("sec.bound", "bound", lambda: src["v"])
    m.get("top").inc(2)
    m.get("sec.a").inc(1)
    m.get("sec.deep.b").set(1.5)
    assert m.nested() == {"top": 2,
                          "sec": {"a": 1, "deep": {"b": 1.5}, "bound": 3}}
    assert list(m.snapshot()) == ["top", "sec.a", "sec.deep.b",
                                  "sec.bound"]
    m.reset()
    assert m.get("top").value() == 0
    assert m.get("sec.bound").value() == 3      # bound follows its source


def test_prometheus_exposition(pkg):
    m = pkg.metrics.MetricsRegistry()
    m.counter("pool.allocs", "blocks allocated").inc(4)
    m.gauge("engine.util", "utilization").set(0.5)
    m.func("engine.mode", "serving mode", lambda: "ragged")
    m.func("engine.maybe", "optional value", lambda: None, optional=True)
    h = m.histogram("step.time", "step seconds", buckets=[0.01, 0.1])
    h.observe(0.005)
    h.observe(0.05)
    text = m.to_prometheus()
    assert "# TYPE pool_allocs counter\npool_allocs 4" in text
    assert "engine_util 0.5" in text
    assert 'engine_mode_info{value="ragged"} 1' in text
    assert 'engine_maybe_info{value="none"} 1' in text
    assert 'step_time_bucket{le="0.01"} 1' in text
    assert 'step_time_bucket{le="+Inf"} 2' in text
    assert "step_time_count 2" in text
    assert pkg.metrics.prom_name("a.b-c d") == "a_b_c_d"


def test_prometheus_escaping_round_trips_pathological_strings(pkg):
    nasty_help = 'multi\nline "quoted" back\\slash help'
    nasty_value = 'path\\to\n"thing"'
    m = pkg.metrics.MetricsRegistry()
    m.counter("nasty.ops", nasty_help, label_names=("k",)).inc(2, k="a\nb")
    m.func("nasty.mode", "mode str", lambda: nasty_value)
    text = m.to_prometheus()
    help_line = next(ln for ln in text.splitlines()
                     if ln.startswith("# HELP nasty_ops "))
    escaped = help_line[len("# HELP nasty_ops "):]
    out, i = [], 0
    while i < len(escaped):
        if escaped[i] == "\\" and i + 1 < len(escaped):
            out.append({"n": "\n", "\\": "\\"}[escaped[i + 1]])
            i += 2
        else:
            out.append(escaped[i])
            i += 1
    assert "".join(out) == nasty_help
    series = next(ln for ln in text.splitlines()
                  if ln.startswith("nasty_ops{"))
    assert 'k="a\\nb"' in series and series.endswith(" 2")
    info = next(ln for ln in text.splitlines()
                if ln.startswith("nasty_mode_info{"))
    val = info[info.index('value="') + len('value="'):info.rindex('"')]
    assert (val.replace("\\\\", "\x00").replace('\\"', '"')
            .replace("\\n", "\n").replace("\x00", "\\") == nasty_value)


def test_histogram_percentile_vs_exact_error_bound(pkg):
    rng = np.random.default_rng(3)
    samples = rng.uniform(0.0, 0.1, size=97)
    width = 0.01
    h = pkg.metrics.Histogram("h", "lat",
                              buckets=[width * k for k in range(1, 11)])
    for v in samples:
        h.observe(float(v))
    srt = np.sort(samples)
    for q in (1, 10, 25, 50, 75, 90, 99):
        exact = float(srt[max(1, math.ceil(q / 100.0 * len(srt))) - 1])
        bb = h.percentile(q)
        assert exact <= bb <= exact + width + 1e-12, q


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------

def test_ring_is_bounded_and_counts_drops(pkg):
    tr = pkg.trace.Tracer(capacity=8, clock=lambda: 0.0, enabled=True)
    for i in range(30):
        tr.event(f"e{i}", "pool")
    assert len(tr.events) == 8
    assert tr.n_emitted == 30 and tr.dropped == 22
    assert [e[1] for e in tr.events] == [f"e{i}" for i in range(22, 30)]
    tr.reset()
    assert len(tr.events) == 0 and tr.dropped == 0


def test_disabled_tracer_records_nothing_but_timelines_stay_on(pkg):
    tr = pkg.trace.Tracer(capacity=8, clock=lambda: 0.0, enabled=False)
    tr.event("e", "pool")
    tr.span("s", "dispatch", 0.0, 1.0)
    assert tr.n_emitted == 0 and not tr.events
    tr.req_submit(1, arrival=0.5)
    tr.req_mark(1, "first_token", 1.5)
    tr.req_token(1, 1.5)                       # ring-gated: dropped
    tr.req_done(1, 2.5, n_generated=3)
    tl = tr.timelines[1]
    assert tl.ttft == 1.0 and tl.e2e == 2.0
    assert tl.tpot == pytest.approx(0.5)
    assert tl.tokens == []


def test_timeline_marks_are_first_occurrence_wins(pkg):
    tr = pkg.trace.Tracer(capacity=8, enabled=False)
    tr.req_submit(7, arrival=1.0)
    tr.req_submit(7, arrival=99.0)
    tr.req_mark(7, "admit", 2.0)
    tr.req_mark(7, "admit", 50.0)
    tr.req_preempt(7)
    tr.req_done(7, 5.0, n_generated=1)
    tr.req_done(7, 90.0, n_generated=9)
    tl = tr.timelines[7]
    assert (tl.arrival, tl.admit, tl.done) == (1.0, 2.0, 5.0)
    assert tl.n_generated == 1 and tl.preemptions == 1
    assert tl.tpot is None


def test_derive_latencies_skips_unfinished(pkg):
    tr = pkg.trace.Tracer(capacity=8, enabled=False)
    tr.req_submit(0, 0.0)
    tr.req_mark(0, "first_token", 1.0)
    tr.req_done(0, 3.0, n_generated=5)
    tr.req_submit(1, 0.0)
    lat = tr.derive_latencies()
    assert lat["ttft"] == [1.0] and lat["e2e"] == [3.0]
    assert lat["tpot"] == [pytest.approx(0.5)]


def test_chrome_export_schema(pkg):
    tr = pkg.trace.Tracer(capacity=16, clock=lambda: 0.0, enabled=True)
    tr.event("pool.alloc", "pool", ts=0.001, args={"seq": 1})
    tr.span("ragged_step", "dispatch", 0.002, 0.003,
            {"shape": "T8xS2", "compile": True})
    tr.req_submit(0, 0.0)
    tr.req_mark(0, "admit", 0.001)
    tr.req_mark(0, "first_token", 0.004)
    tr.req_done(0, 0.01, n_generated=4)
    obj = tr.to_chrome()
    assert pkg.trace.validate_chrome_trace(obj) == []
    ev = obj["traceEvents"]
    names = {e["name"] for e in ev}
    assert {"ragged_step", "req 0", "first_token rid=0"} <= names
    step = next(e for e in ev if e["name"] == "ragged_step")
    assert step["ts"] == 2000.0 and step["dur"] == 3000.0
    req = next(e for e in ev if e["name"] == "req 0")
    assert req["args"]["ttft_s"] == pytest.approx(0.004)
    assert obj["otherData"]["dropped_events"] == 0
    json.dumps(obj)


def test_validate_chrome_trace_rejects_malformed(pkg):
    v = pkg.trace.validate_chrome_trace
    assert v([]) != [] and v({"foo": 1}) != []
    assert any("phase" in p for p in v({"traceEvents": [
        {"name": "e", "ph": "Z", "ts": 0, "pid": 0, "tid": 0}]}))
    assert any("dur" in p for p in v({"traceEvents": [
        {"name": "e", "ph": "X", "ts": 0, "pid": 0, "tid": 0}]}))
    probs = v({"traceEvents": [{"ph": "i", "ts": 0, "pid": 0}]})
    assert any("name" in p for p in probs) and any("tid" in p
                                                   for p in probs)


def test_validate_chrome_trace_accepts_edge_cases(pkg):
    v = pkg.trace.validate_chrome_trace
    assert v({"traceEvents": []}) == []
    assert v({"traceEvents": [{"name": "e", "ph": "i", "ts": 5.0, "pid": 0,
                               "tid": 1, "s": "t"}]}) == []
    assert v({"traceEvents": [
        {"name": "b", "ph": "X", "ts": 900.0, "dur": 1.0, "pid": 0,
         "tid": 0},
        {"name": "a", "ph": "i", "ts": 1.0, "pid": 0, "tid": 0, "s": "t"},
        {"name": "M", "ph": "M", "ts": 0, "pid": 0, "tid": 0,
         "args": {"name": "proc"}}]}) == []


# ---------------------------------------------------------------------------
# energy account and profiler
# ---------------------------------------------------------------------------

def test_energy_account_phases_and_per_token_semantics(pkg):
    en = pkg.profile.EnergyAccount("bit_shifting")
    with pytest.raises(ValueError):
        pkg.profile.EnergyAccount("free_lunch")
    assert en.uj_per_token("prefill") is None
    en.charge("prefill", 1000, 10)
    en.charge("decode", 500, 5)
    en.charge("spec_wasted", 200, 2)
    assert en.total_quant_ops == 1700
    pj = pkg.hwcost.energy_per_op_pj("bit_shifting")
    assert en.energy_uj("prefill") == pytest.approx(1000 * pj * 1e-6)
    assert en.uj_per_token("prefill") == pytest.approx(
        en.energy_uj("prefill") / 10)
    assert en.uj_per_token("spec_wasted") == pytest.approx(
        en.energy_uj("spec_wasted") / 5)
    assert en.proxy_uj_per_token() == pytest.approx(
        pkg.hwcost.estimate("bit_shifting", 1700).energy_uj / 15)
    rep = en.report()
    assert rep["unit"] == "bit_shifting"
    assert set(pkg.profile.ENERGY_PHASES) <= set(rep)
    assert rep["total_quant_ops"] == 1700
    en.reset()
    assert en.total_quant_ops == 0 and en.proxy_uj_per_token() is None


def test_energy_ops_without_tokens_is_inf_not_crash(pkg):
    en = pkg.profile.EnergyAccount()
    en.charge("decode", 100, 0)
    assert en.uj_per_token("decode") == float("inf")


def test_profiler_disabled_is_inert(pkg):
    p = pkg.profile.Profiler()
    assert not p.enabled and p.report() is None
    with p.capture():
        pass
    with p.step_annotation("step", 0):
        pass
    assert p.report() is None


# ---------------------------------------------------------------------------
# SLO monitor
# ---------------------------------------------------------------------------

def _obj(pkg, **kw):
    base = dict(name="o", metric="ttft", target=1.0, budget_frac=0.25,
                window_s=10.0, burn_threshold=1.0, min_samples=1)
    base.update(kw)
    return pkg.slo.SLObjective(**base)


def test_objective_validation(pkg):
    for kw in (dict(name=""), dict(budget_frac=0.0), dict(budget_frac=1.5),
               dict(window_s=0.0), dict(min_samples=0)):
        with pytest.raises(ValueError):
            _obj(pkg, **kw)
    assert _obj(pkg, metric="ttft").kind == "request"
    assert _obj(pkg, metric="e2e").kind == "request"
    assert _obj(pkg, metric="pool.utilization").kind == "gauge"
    assert set(pkg.slo.REQUEST_METRICS) == {"ttft", "tpot", "e2e"}


def test_default_slos_composition(pkg):
    objs = {o.name: o for o in pkg.slo.default_slos()}
    assert set(objs) == {"ttft", "e2e", "pool_pressure"}
    assert objs["pool_pressure"].metric == "pool.utilization"
    objs = {o.name: o for o in pkg.slo.default_slos(
        ttft_s=None, e2e_s=None, pool_utilization=None,
        tpot_s=0.01, energy_uj_per_token=200.0)}
    assert set(objs) == {"tpot", "energy_per_token"}
    assert objs["energy_per_token"].metric == "energy.proxy_uj_per_token"
    with pytest.raises(ValueError):
        pkg.slo.SLOMonitor([_obj(pkg), _obj(pkg)])


def test_burn_rate_math(pkg):
    mon = pkg.slo.SLOMonitor([_obj(pkg, budget_frac=0.25)])
    assert mon.burn_rate("o", 0.0) == (None, 0, 0)
    for i in range(8):
        mon.observe("o", float(i), 0.5 if i % 4 else 2.0)  # 2 of 8 bad
    burn, total, bad = mon.burn_rate("o", 7.0)
    assert (total, bad) == (8, 2)
    assert burn == pytest.approx((2 / 8) / 0.25)


def test_window_trims_old_observations(pkg):
    mon = pkg.slo.SLOMonitor([_obj(pkg, window_s=5.0)])
    mon.observe("o", 0.0, 99.0)
    for t in (4.0, 6.0, 8.0):
        mon.observe("o", t, 0.1)
    burn, total, bad = mon.burn_rate("o", 8.0)
    assert total == 3 and bad == 0 and burn == 0.0
    assert mon.burn_rate("o", 11.0)[1] == 2


def test_min_samples_gates_firing(pkg):
    mon = pkg.slo.SLOMonitor([_obj(pkg, min_samples=3)])
    mon.observe("o", 0.0, 9.0)
    mon.evaluate(0.0)
    assert mon.alerts_fired == 0
    mon.observe("o", 0.1, 9.0)
    mon.observe("o", 0.2, 9.0)
    mon.evaluate(0.2)
    assert mon.alerts_fired == 1 and mon.alerts_active == 1


def test_fire_and_clear_emit_tracer_events(pkg):
    tr = pkg.trace.Tracer(capacity=64, clock=lambda: 0.0, enabled=True)
    mon = pkg.slo.SLOMonitor([_obj(pkg, window_s=2.0)], tracer=tr)
    mon.observe("o", 0.0, 9.0)
    mon.evaluate(0.0)
    assert mon.alerts_fired == 1 and mon.alerts_active == 1
    alert = mon.alerts[-1]
    assert alert["objective"] == "o" and alert["burn_rate"] == 4.0
    assert alert["window_total"] == 1 and alert["window_bad"] == 1
    mon.evaluate(0.5)
    assert mon.alerts_fired == 1
    mon.evaluate(5.0)
    assert mon.alerts_active == 0
    names = [name for (_ph, name, *_r) in tr.events]
    assert names.count("slo.alert") == 1 and names.count("slo.recover") == 1
    assert mon.worst_burn_rate() is None
    st = mon.status()["o"]
    assert st["firing"] is False and st["window_total"] == 0


def test_request_objectives_ingest_from_timelines_once(pkg):
    tr = pkg.trace.Tracer(capacity=8, enabled=False)
    mon = pkg.slo.SLOMonitor(
        [_obj(pkg, name="ttft", metric="ttft", target=0.05),
         _obj(pkg, name="e2e", metric="e2e", target=10.0)], tracer=tr)
    tr.req_submit(0, arrival=0.0)
    tr.req_mark(0, "first_token", 0.2)
    tr.req_done(0, 0.3, n_generated=2)
    tr.req_submit(1, arrival=0.0)
    mon.evaluate(0.3)
    assert mon.burn_rate("ttft", 0.3)[1:] == (1, 1)
    assert mon.burn_rate("e2e", 0.3)[1:] == (1, 0)
    mon.evaluate(0.4)
    assert mon.burn_rate("ttft", 0.4)[1] == 1
    assert mon.alerts_active == 1
    assert mon.status()["ttft"]["firing"] is True


def test_gauge_objectives_read_value_fn(pkg):
    vals = {"pool.utilization": 0.99}
    mon = pkg.slo.SLOMonitor(
        [_obj(pkg, name="pool", metric="pool.utilization", target=0.9),
         _obj(pkg, name="missing", metric="not.registered", target=1.0),
         _obj(pkg, name="undefined", metric="late.metric", target=1.0)],
        value_fn=lambda n: ({"late.metric": None} | vals)[n])
    mon.evaluate(1.0)
    assert mon.burn_rate("pool", 1.0)[1:] == (1, 1)
    assert mon.burn_rate("missing", 1.0)[1] == 0
    assert mon.burn_rate("undefined", 1.0)[1] == 0
    vals["pool.utilization"] = 0.5
    mon.evaluate(2.0)
    assert mon.burn_rate("pool", 2.0)[1:] == (2, 1)
    mon.reset()
    assert mon.evaluations == 0 and mon.alerts_fired == 0


# ---------------------------------------------------------------------------
# schema and flight recorder helpers
# ---------------------------------------------------------------------------

def test_diff_schema_reports_drift(pkg):
    golden = pkg.schema.GOLDEN_SCHEMA
    got = {k: dict(v) for k, v in golden.items()
           if not k.startswith(("profile", "state_pool."))}
    kw = dict(spec=True, cache=True, slo=True)
    if pkg.name == "repro_torch":
        kw["extras"] = {}
    assert pkg.schema.diff_schema(got, **kw) == []
    assert pkg.schema.diff_schema(dict(got), spec=False, cache=True,
                                  slo=True, **({} if pkg.name == "repro"
                                               else {"extras": {}}))
    retyped = dict(got, gen_tokens={"kind": "counter", "type": "float"})
    assert any("gen_tokens" in e for e in pkg.schema.diff_schema(retyped,
                                                                 **kw))
    missing = {k: v for k, v in got.items() if k != "wall_s"}
    assert any("wall_s" in e for e in pkg.schema.diff_schema(missing, **kw))


def test_decision_lines_canonicalization(pkg):
    lines = pkg.replay.decision_lines([
        ("sched.admit", {"rid": np.int64(3), "slot": 0, "resume": False}),
        ("pool.free", {}),
        ("cache.publish", {"block": np.int32(7), "frac": 0.25}),
    ])
    assert lines == ["sched.admit resume=false rid=3 slot=0",
                     "pool.free",
                     "cache.publish block=7 frac=0.25"]
    assert pkg.replay.decision_lines([("e", {"x": np.float64(0.5)})]) == \
        pkg.replay.decision_lines([("e", {"x": 0.5})])


def test_diff_decisions_empty_and_localized(pkg):
    a = [("sched.admit", {"rid": 0}), ("pool.alloc", {"seq": 0})]
    assert pkg.replay.diff_decisions(a, list(a)) == []
    b = [("sched.admit", {"rid": 0}), ("pool.alloc", {"seq": 1})]
    diff = pkg.replay.diff_decisions(a, b, label_a="run1", label_b="run2")
    assert diff[0].startswith("--- run1") and diff[1].startswith("+++ run2")
    assert "-pool.alloc seq=0" in diff and "+pool.alloc seq=1" in diff
    assert not any(ln.startswith("-sched.admit") for ln in diff)


def test_decision_sink_tees_only_decision_cats(pkg):
    tr = pkg.trace.Tracer(capacity=4, clock=lambda: 0.0, enabled=True)
    tr.decision_sink = []
    for cat in pkg.trace.DECISION_CATS:
        tr.event(f"{cat}.x", cat, args={"i": 1})
    tr.event("ragged_step", "dispatch")
    tr.event("slo.alert", "slo")
    assert [n for n, _ in tr.decision_sink] == \
        [f"{c}.x" for c in pkg.trace.DECISION_CATS]
    for i in range(50):
        tr.event("sched.admit", "sched", args={"order": i})
    assert len(tr.events) == 4
    assert len(tr.decision_sink) == len(pkg.trace.DECISION_CATS) + 50
    tr.reset()
    assert tr.decision_sink == []


def test_record_json_round_trip(pkg, tmp_path):
    R = pkg.replay
    rec = R.WorkloadRecord(
        version=R.RECORD_VERSION, fingerprint="ab" * 8,
        engine={"n_slots": 2}, requests=[
            {"rid": 0, "prompt": [1, 2, 3], "max_new_tokens": 4,
             "temperature": 0.0, "top_k": 0, "stop_token": None,
             "arrival": 0.001}],
        outputs={0: [5, 6]}, decisions=[["sched.admit", {"rid": 0}]],
        timelines={0: {"arrival": 0.001, "done": 0.01}},
        meta={"n_requests": 1})
    path = tmp_path / "rec.json"
    rec.save(str(path))
    back = R.WorkloadRecord.load(str(path))
    assert back == rec
    assert json.loads(path.read_text())["outputs"] == {"0": [5, 6]}
    reqs = R.build_requests(back)
    assert reqs[0].rid == 0 and list(reqs[0].prompt) == [1, 2, 3]
    assert reqs[0].arrival == 0.001
    assert type(reqs[0]).__module__ == f"{pkg.name}.serving.scheduler"
    with pytest.raises(ValueError):
        R.WorkloadRecord.from_json(rec.to_json()
                                   | {"version": R.RECORD_VERSION + 1})


def test_same_events_give_identical_exports():
    """Both packages' registries and tracers, fed the same calls, give
    the same Prometheus text and the same Chrome trace."""
    pytest.importorskip("jax")
    outs = []
    for name in PKGS:
        met = importlib.import_module(f"{name}.obs.metrics")
        trace = importlib.import_module(f"{name}.obs.trace")
        m = met.MetricsRegistry()
        m.counter("a.ops", "ops", label_names=("p",)).inc(3, p="x")
        m.gauge("a.util", "util").set(0.25)
        m.func("a.mode", "mode", lambda: "ragged")
        h = m.histogram("a.t", "t", buckets=[0.01, 0.1])
        for v in (0.001, 0.05, 3.0):
            h.observe(v)
        tr = trace.Tracer(capacity=6, clock=lambda: 0.5, enabled=True)
        tr.decision_sink = []
        for i in range(9):
            tr.event("pool.alloc", "pool", args={"seq": i})
        tr.span("decode", "dispatch", 0.1, 0.02, {"shape": "4x1"})
        tr.req_submit(0, 0.0)
        tr.req_mark(0, "first_token", 0.2)
        tr.req_token(0, 0.3)
        tr.req_done(0, 0.4, n_generated=3)
        outs.append((m.to_prometheus(), m.nested(), tr.to_chrome(),
                     tr.decision_sink, tr.derive_latencies()))
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# the port's engine on the CPU
# ---------------------------------------------------------------------------

def _engine(ragged=True, spec_k=0, **kw):
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.qmodel import QuantContext, QuantMode
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServingEngine
    cfg = dataclasses.replace(get_smoke_config("qwen3_1_7b"),
                              kv_cache_bits=8, dtype="float32")
    base = dict(n_slots=2, block_size=8, max_model_len=64, chunk=8,
                ragged=ragged, spec_k=spec_k, device="cpu")
    base.update(kw)
    return ServingEngine(cfg, _port_params(cfg),
                         QuantContext(mode=QuantMode.FP), **base)


_PARAMS = {}


def _port_params(cfg):
    if "p" not in _PARAMS:
        from repro_torch.models import model as M
        _PARAMS["p"] = M.init_params(cfg, 0, device="cpu")
    return _PARAMS["p"]


def _requests(vocab, n=4, temperature=0.0, top_k=0, arrive=0.0):
    from repro_torch.serving.scheduler import Request
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, vocab, size=8)
    reqs = []
    for i in range(n):
        # one repetitive prompt so the n-gram drafter proposes something
        tail = (np.tile(rng.integers(0, vocab, size=3), 4) if i == 1
                else rng.integers(0, vocab, size=int(rng.integers(3, 12))))
        reqs.append(Request(rid=i, prompt=np.concatenate(
            [prefix, tail]).astype(np.int32),
            max_new_tokens=int(rng.integers(8, 12)), temperature=temperature,
            top_k=top_k, arrival=arrive * i))
    return reqs


def _run(eng, reqs):
    with torch.no_grad():
        return eng.run(reqs)


ENGINE_CASES = [(True, 0), (True, 2), (False, 0), (False, 2)]


@pytest.mark.parametrize("ragged,spec_k", ENGINE_CASES)
def test_obs_changes_no_token_counter_or_decision(ragged, spec_k):
    """The same workload with observability off and on (trace, SLO and
    a metrics export, on the real clock): identical tokens, step counts,
    Table-5 counters and pool / cache statistics."""
    off = _engine(ragged, spec_k, num_blocks=5, max_model_len=32)
    on = _engine(ragged, spec_k, num_blocks=5, max_model_len=32, trace=True,
                 slo=True)
    r_off = _run(off, _requests(off.cfg.vocab_size))
    r_on = _run(on, _requests(on.cfg.vocab_size))
    assert off.outputs().keys() == on.outputs().keys()
    for rid, toks in off.outputs().items():
        assert np.array_equal(toks, on.outputs()[rid]), rid
    for key in ("ragged_steps", "decode_steps", "spec_steps",
                "prefill_chunks", "dispatched_tokens", "padded_tokens",
                "preemptions", "hwcost", "energy", "pool", "prefix_cache",
                "speculative", "kernel_launches"):
        assert r_off[key] == r_on[key], key
    assert r_on["preemptions"] > 0 and r_on["prefix_cache"]["hits"] > 0
    assert r_off["obs"]["trace_emitted"] == 0 < r_on["obs"]["trace_emitted"]
    assert "slo" not in r_off and r_on["slo"]["evaluations"] > 0
    assert "# TYPE gen_tokens counter" in on.metrics.to_prometheus()


@pytest.mark.parametrize("ragged", [True, False])
def test_profile_dir_annotates_every_dispatch(tmp_path, ragged):
    from repro_torch.launch.serve import serve_engine
    kw = dict(n_requests=3, rate=1e9, mode="fp", calibrate=False,
              cfg_overrides={"dtype": "float32"}, ragged=ragged,
              device="cpu")
    plain = serve_engine("qwen3_1_7b", **kw)
    o = serve_engine("qwen3_1_7b", profile_dir=str(tmp_path), **kw)
    for rid, toks in plain["outputs"].items():
        assert np.array_equal(toks, o["outputs"][rid]), rid
    rep = o["report"]
    prof = rep["profile"]
    (path,) = prof["trace_files"]
    events = json.loads(open(path).read())["traceEvents"]
    names = [e["name"] for e in events if "#" in str(e.get("name", ""))]
    if ragged:
        want = {"ragged_step": rep["ragged_steps"]}
    else:
        want = {"prefill": rep["prefill_chunks"],
                "decode": rep["decode_steps"]}
    got = {}
    for n in names:
        got[n.split("#")[0]] = got.get(n.split("#")[0], 0) + 1
    assert got == want == {k: v for k, v in want.items() if v}
    assert prof["annotated_dispatches"] == sum(want.values())
    assert "profile" not in plain["report"]


def test_profile_cost_raises_naming_its_roadmap_item():
    from repro_torch.obs.profile import Profiler
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 8"):
        Profiler(cost=True)
    with pytest.raises(NotImplementedError, match="item 8"):
        _engine(profile_cost=True)


@pytest.mark.parametrize("ragged,spec_k", [(True, 2), (False, 2)])
def test_sampled_record_replays_after_reset(ragged, spec_k):
    """``reset_metrics`` re-seeds the sampling generator: a record of
    sampled requests (temperature 1, top-k) replays token for token on
    the same engine and on a fresh one, with an empty decision diff."""
    from repro_torch.obs.replay import (WorkloadRecord, build_requests,
                                        engine_fingerprint,
                                        replay_workload)
    eng = _engine(ragged, spec_k, num_blocks=5, max_model_len=32,
                  record=True)
    reqs = _requests(eng.cfg.vocab_size, temperature=1.0, top_k=20,
                     arrive=0.003)
    _run(eng, reqs)
    rec = WorkloadRecord.from_json(json.loads(json.dumps(
        eng.workload_record(reqs).to_json())))
    assert rec.fingerprint == engine_fingerprint(eng)
    with torch.no_grad():
        same = replay_workload(rec, eng)
        fresh_eng = _engine(ragged, spec_k, num_blocks=5, max_model_len=32,
                  record=True)
        fresh = replay_workload(rec, fresh_eng, strict_fingerprint=True)
    for res in (same, fresh):
        assert res.ok and res.fingerprint_match, res.decision_diff[:5]
        assert res.outputs == rec.outputs
    assert fresh_eng.tracer.timelines[0].done == pytest.approx(
        rec.timelines[0]["done"], abs=1e-9)
    other = _engine(ragged, spec_k, num_blocks=9, record=True,
                    virtual_dt=2e-3)
    assert engine_fingerprint(other) != rec.fingerprint
    assert build_requests(rec)[0].temperature == 1.0


def test_disabled_sections_surface_as_none():
    from repro_torch.obs.schema import diff_schema, schema_of
    eng = _engine(prefix_cache=False, max_model_len=32)
    rep = eng.report()
    assert rep["speculative"] is None and rep["prefix_cache"] is None
    assert rep["state_pool"] is None
    assert "speculative.spec_k" not in eng.metrics.names()
    assert diff_schema(schema_of(eng.metrics), spec=False, cache=False) == []
    assert rep["obs"]["trace_enabled"] is False
    assert rep["energy"]["total_quant_ops"] == 0
    assert rep["device"] == "cpu"
    assert rep["kernel_launches"] == {"int8_matmul": 0,
                                      "ragged_attention": 0}
    with pytest.raises(ValueError, match="record=True"):
        eng.workload_record([])


def test_ring_overflow_and_reset_metrics():
    eng = _engine(trace=True, trace_capacity=8, max_model_len=32, spec_k=2)
    assert eng.metrics.get_value("obs.trace_dropped_total") == 0
    rep = _run(eng, _requests(eng.cfg.vocab_size, n=3))
    dropped = eng.metrics.get_value("obs.trace_dropped_total")
    assert dropped == eng.tracer.dropped == rep["obs"]["trace_dropped"] > 0
    assert rep["obs"]["trace_ring_used"] == 1.0
    assert eng.energy.total_quant_ops > 0 and eng.drafter.stats.calls > 0
    eng.reset_metrics()
    rep = eng.report()
    assert rep["completed"] == 0 and rep["ttft_s"]["p50"] is None
    assert rep["energy"]["proxy_uj_per_token"] is None
    assert rep["timeline"]["requests"] == 0
    assert rep["obs"]["trace_dropped_total"] == 0
    assert rep["hwcost"]["requant_ops_performed"] == 0
    assert eng.drafter.stats.calls == 0
