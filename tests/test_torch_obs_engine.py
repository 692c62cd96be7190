"""Differential tests: the port's engine observability against the JAX
engine's.

Each scenario serves the same greedy ``poisson_workload`` (6 requests
arriving at once, a 16-token shared prefix that hits the prefix cache,
an 8-block pool that preempts) through the 2-layer fp32 smoke qwen3 on
both packages, the JAX weights carried over by ``from_jax_params``, with
``record=True, trace=True`` and an SLO monitor: the ragged and the
legacy engine, each with ``spec_k`` 0 and 2, and the W8A8 ragged engine.
The virtual clock makes every latency deterministic, so the two reports
must agree on everything but the per-shape wall times: tokens, the
Table-5 requant and energy counters, the speculative, prefix-cache, pool
and SLO sections, the latency percentiles, the scheduler-decision
stream, and the schema (the port's adds only ``PORT_EXTRAS``).  A record
captured on either package replays on the other with identical tokens
and decisions and a matching fingerprint (the port's ``ModelConfig``
holds every field of the reference's), and on a fresh engine of its own
package likewise.
"""
import dataclasses
import functools
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.obs import replay as jreplay  # noqa: E402
from repro.obs import schema as jschema  # noqa: E402
from repro.obs import slo as jslo  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.model import from_jax_params  # noqa: E402
from repro_torch.obs import replay as treplay  # noqa: E402
from repro_torch.obs import schema as tschema  # noqa: E402
from repro_torch.obs import slo as tslo  # noqa: E402
from repro_torch.obs.trace import validate_chrome_trace  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

# scenario -> (ragged, spec_k, w8a8, tight SLOs)
SCENARIOS = {
    "ragged": (True, 0, False, False),
    "ragged_spec2": (True, 2, False, False),
    "legacy": (False, 0, False, False),
    "legacy_spec2": (False, 2, False, True),
    "w8a8": (True, 0, True, False),
}
N_REQ = 6
# objectives every run breaks, so alerts fire and recover on both engines
TIGHT = dict(ttft_s=0.005, e2e_s=0.02, tpot_s=0.001,
             energy_uj_per_token=1e-3, pool_utilization=0.5, window_s=0.05)


def _flat(d, pre=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict) and k not in ("step_shapes", "status"):
            out.update(_flat(v, f"{pre}{k}."))
        else:
            out[pre + k] = v
    return out


@functools.lru_cache(maxsize=None)
def _params(w8a8):
    jcfg = dataclasses.replace(
        get_smoke_config("qwen3_1_7b"), kv_cache_bits=8, dtype="float32",
        **({"matmul_kernel": "int8"} if w8a8 else {}))
    tcfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})
    npt = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                  jax.random.PRNGKey(0)))
    return from_jax_params(npt, tcfg, device="cpu")


def _kw(name, **extra):
    ragged, spec_k, w8a8, _ = SCENARIOS[name]
    kw = dict(n_requests=N_REQ, rate=1e9, kv_bits=8,
              cfg_overrides={"dtype": "float32"}, shared_prefix=16,
              num_blocks=8, ragged=ragged, spec_k=spec_k)
    kw.update(dict(w8a8=True) if w8a8 else dict(mode="fp", calibrate=False))
    kw.update(extra)
    return kw


@functools.lru_cache(maxsize=None)
def _runs(name):
    """Both packages' runs of one scenario, with what the tests read
    snapshotted right after each run (the replay tests reuse the
    engines)."""
    tight = SCENARIOS[name][3]
    out = {}
    for pkg, serve, slo_mod in (("jax", jserve, jslo), ("torch", tserve,
                                                         tslo)):
        slo = slo_mod.default_slos(**TIGHT) if tight else True
        extra = {} if pkg == "jax" else dict(params=_params(SCENARIOS[name][2]),
                                             device="cpu")
        o = serve.serve_engine("qwen3_1_7b", **_kw(
            name, record=True, trace=True, slo=slo, **extra))
        eng = o["engine"]
        mod = jschema if pkg == "jax" else tschema
        o["schema"] = mod.schema_of(eng.metrics)
        o["chrome"] = eng.tracer.to_chrome()
        o["alerts"] = [(n, a) for (_ph, n, _c, _t, _d, a)
                       in eng.tracer.events if n.startswith("slo.")]
        out[pkg] = o
    return out["jax"], out["torch"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_tokens_identical(name):
    jo, to = _runs(name)
    assert sorted(jo["outputs"]) == sorted(to["outputs"]) \
        == list(range(N_REQ))
    for rid, toks in jo["outputs"].items():
        assert np.array_equal(toks, to["outputs"][rid]), rid
    assert to["record"].outputs == jo["record"].outputs


@pytest.mark.parametrize("name", SCENARIOS)
def test_counters_identical(name):
    """Every report value but the per-shape wall times, and the JAX
    report's keys exactly (the port adds ``device`` and
    ``kernel_launches``)."""
    jo, to = _runs(name)
    jf, tf = _flat(jo["report"]), _flat(to["report"])
    extra = {k for k in tf if k not in jf}
    assert {k.split(".")[0] for k in extra} == set(tschema.PORT_EXTRAS)
    jf.pop("step_shapes")
    for key, want in jf.items():
        assert tf[key] == want, key
    tr = to["report"]
    assert tr["preemptions"] > 0 and tr["prefix_cache"]["hits"] > 0
    assert tr["hwcost"]["requant_ops_avoided_prefix_cache"] > 0
    ragged, spec_k, w8a8, _ = SCENARIOS[name]
    assert (tr["hwcost"]["requant_ops_forward"] > 0) is w8a8
    if spec_k:
        assert tr["speculative"]["drafted_tokens"] > 0
        assert tr["hwcost"]["requant_ops_wasted_speculation"] > 0
    assert set(tr["step_shapes"]) == set(jo["report"]["step_shapes"])
    assert tr["kernel_launches"] == dict.fromkeys(tr["kernel_launches"], 0)


@pytest.mark.parametrize("name", SCENARIOS)
def test_latency_percentiles_identical(name):
    jo, to = _runs(name)
    tr, jr = to["report"], jo["report"]
    for sec in ("ttft_s", "tpot_s", "e2e_s"):
        assert tr[sec] == jr[sec] and tr[sec]["p50"] is not None, sec
        assert tr["timeline"][sec] == tr[sec], sec
    assert tr["wall_s"] == jr["wall_s"]
    assert tr["slo"] == jr["slo"]
    assert to["alerts"] == jo["alerts"]
    if SCENARIOS[name][3]:
        assert tr["slo"]["alerts_fired"] >= 3
        assert {a["objective"] for n, a in to["alerts"]
                if n == "slo.alert"} >= {"ttft", "e2e", "energy_per_token"}


@pytest.mark.parametrize("name", SCENARIOS)
def test_decisions_identical(name):
    jo, to = _runs(name)
    jd, td = jo["record"].decisions, to["record"].decisions
    assert len(td) > 0
    assert treplay.diff_decisions(jd, td) == []
    names = {n for n, _ in td}
    assert {"sched.admit", "sched.prefill_chunk", "sched.preempt",
            "pool.alloc", "cache.publish"} <= names


@pytest.mark.parametrize("name", SCENARIOS)
def test_schema_clean_apart_from_port_extras(name):
    jo, to = _runs(name)
    spec = SCENARIOS[name][1] > 0
    errs = tschema.diff_schema(to["schema"], spec=spec, cache=True, slo=True)
    assert errs == [], "\n".join(errs)
    assert jschema.diff_schema(jo["schema"], spec=spec, cache=True,
                               slo=True) == []
    # identical identity fields key by key: the port adds only its extras
    assert {k: v for k, v in to["schema"].items()
            if k not in tschema.PORT_EXTRAS} == jo["schema"]
    assert tschema.GOLDEN_SCHEMA == jschema.GOLDEN_SCHEMA
    # an undeclared key is still drift
    bad = dict(to["schema"], extra_key={"kind": "gauge", "type": "int"})
    assert any("extra_key" in e for e in tschema.diff_schema(
        bad, spec=spec, cache=True, slo=True))


@pytest.mark.parametrize("name", SCENARIOS)
def test_energy_reconciles_with_hwcost(name):
    _, to = _runs(name)
    en, hw = to["report"]["energy"], to["report"]["hwcost"]
    assert sum(en[p]["quant_ops"] for p in ("prefill", "decode",
                                            "spec_wasted")) \
        == en["total_quant_ops"] \
        == hw["requant_ops_performed"] + hw["requant_ops_forward"] > 0
    assert en["spec_wasted"]["quant_ops"] == (
        hw["requant_ops_wasted_speculation"]
        + hw["requant_ops_forward_wasted_speculation"])
    assert en["total_energy_uj"] == pytest.approx(
        hw["energy_uj_bit_shift"] + hw["energy_uj_forward_bit_shift"],
        abs=1e-6)
    assert en["decode"]["tokens"] + en["prefill"]["tokens"] > 0


@pytest.mark.parametrize("name", SCENARIOS)
def test_chrome_trace_has_one_span_per_dispatch(name):
    jo, to = _runs(name)
    obj, rep = to["chrome"], to["report"]
    assert validate_chrome_trace(obj) == []
    json.dumps(obj)
    spans = [e for e in obj["traceEvents"]
             if e["ph"] == "X" and e.get("cat") == "dispatch"]
    by_name = {}
    for e in spans:
        by_name[e["name"]] = by_name.get(e["name"], 0) + 1
    if SCENARIOS[name][0]:
        want = {"ragged_step": rep["ragged_steps"]}
    else:
        want = {"prefill": rep["prefill_chunks"],
                "decode": rep["decode_steps"],
                "spec_verify": rep["spec_steps"]}
    assert by_name == {k: v for k, v in want.items() if v}
    assert sum(e["args"]["real_tokens"] + e["args"]["padded_tokens"]
               for e in spans) == rep["dispatched_tokens"]
    assert sum(e["args"]["padded_tokens"] for e in spans) \
        == rep["padded_tokens"]
    jspans = [(e["name"], e["ts"], e["args"]["shape"],
               e["args"]["real_tokens"]) for e in jo["chrome"]["traceEvents"]
              if e["ph"] == "X" and e.get("cat") == "dispatch"]
    assert [(e["name"], e["ts"], e["args"]["shape"], e["args"]["real_tokens"])
            for e in spans] == jspans


def _round_trip(rec_mod, rec):
    return rec_mod.WorkloadRecord.from_json(
        json.loads(json.dumps(rec.to_json())))


# the replay tests come last: they reset and rerun the scenario engines
REPLAYS = [(name, way) for name in ("ragged_spec2", "legacy_spec2")
           for way in ("jax->torch", "torch->jax", "torch->torch")]


@pytest.mark.parametrize("name,way", REPLAYS)
def test_record_replays_across_packages(name, way):
    jo, to = _runs(name)
    if way == "jax->torch":
        rec = _round_trip(treplay, jo["record"])
        res = treplay.replay_workload(rec, to["engine"])
        assert res.fingerprint_match
    elif way == "torch->jax":
        rec = _round_trip(jreplay, to["record"])
        res = jreplay.replay_workload(rec, jo["engine"])
        assert res.fingerprint_match
    else:
        rec = _round_trip(treplay, to["record"])
        slo = tslo.default_slos(**TIGHT) if SCENARIOS[name][3] else True
        fresh = tserve.serve_engine("qwen3_1_7b", **_kw(
            name, record=True, trace=True, slo=slo,
            requests=treplay.build_requests(rec),
            params=_params(False), device="cpu"))["engine"]
        res = treplay.replay_workload(rec, fresh, strict_fingerprint=True)
        assert res.fingerprint_match
        assert res.report["hwcost"] == to["report"]["hwcost"]
        assert res.report["energy"] == to["report"]["energy"]
    assert res.token_identical and res.mismatched_rids == []
    assert res.decision_diff == []
    assert res.ok
    assert res.outputs == jo["record"].outputs
