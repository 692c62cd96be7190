"""The three example twins under ``repro_torch/launch/`` against the JAX
package's examples, on the CPU at smoke size:

* ``continuous_batching``: the same greedy tokens, scheduler decisions and
  dense-cache exact-match line as ``examples/continuous_batching.py``'s
  ``serve_engine`` runs, run for run: the ragged engine with its legacy
  A/B, ``--no-ragged``, ``--shared-prefix 0``, ``--spec-k 2``, and
  rwkv6-3b (the substrate note, every request checked, the attention
  baseline);
* ``replay_workload``: the replay ``EXACT`` and the ``--legacy-ab``
  decision diff as long as the reference example's;
* ``inspect_trace``: the per-request timelines it prints for a trace the
  port's engine wrote equal to those the reference example prints for the
  JAX engine's trace of the same workload, and a broken trace refused.

Each package's ``serve_engine`` is wrapped for the comparison: every run
in fp32 on the flight recorder's virtual clock (``record=True``), so that
both engines admit, preempt and time alike, and the port's runs take the
JAX run's weights through ``from_jax_params``.  The examples themselves
run unchanged, from their files.  About 2 minutes on one thread, most of
it the JAX engines' compilations.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.launch import serve as jserve  # noqa: E402
from repro_torch.launch import continuous_batching as tcb  # noqa: E402
from repro_torch.launch import inspect_trace as tinspect  # noqa: E402
from repro_torch.launch import replay_workload as treplay  # noqa: E402
from repro_torch.models.model import from_jax_params  # noqa: E402
from repro_torch.obs.replay import decision_lines  # noqa: E402
from tests.test_torch_recurrent_blocks import tcfg_of  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
N_REQ = 4


def _example(name):
    """The JAX package's example ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _settings(kw):
    """Both packages' runs in fp32 on the virtual clock."""
    overrides = dict(kw.pop("cfg_overrides", None) or {})
    overrides.setdefault("dtype", "float32")
    kw["cfg_overrides"] = overrides
    kw.setdefault("record", True)
    return kw


class Runs:
    """The ``serve_engine`` calls of the reference example (``jax``) and
    of the twin (``port``), in call order; the port's n-th call takes the
    weights of the JAX call with the same arch and overrides."""

    def __init__(self, monkeypatch):
        self.jax, self.port = [], []
        real_j = jserve.serve_engine
        real_t = tcb.serve_engine

        def jax_run(arch, **kw):
            kw = _settings(kw)
            out = real_j(arch, **kw)
            self.jax.append((arch, kw, out))
            return out

        def port_run(arch, **kw):
            kw = _settings(kw)
            _, jkw, jout = next(r for r in self.jax if r[0] == arch and
                                r[1]["cfg_overrides"] == kw["cfg_overrides"])
            jcfg = jout["engine"].cfg
            np_params = jax.tree.map(np.asarray, jout["engine"].params)
            kw["params"] = from_jax_params(np_params, tcfg_of(jcfg),
                                           device="cpu")
            kw["device"] = "cpu"
            out = real_t(arch, **kw)
            self.port.append((arch, kw, out))
            return out

        monkeypatch.setattr(jserve, "serve_engine", jax_run)
        for mod in (tcb, treplay):
            monkeypatch.setattr(mod, "serve_engine", port_run)


def _same_run(jout, tout):
    assert sorted(jout["outputs"]) == sorted(tout["outputs"])
    for rid, toks in jout["outputs"].items():
        assert np.array_equal(np.asarray(toks), tout["outputs"][rid]), rid
    assert decision_lines(jout["record"].decisions) == \
        decision_lines(tout["record"].decisions)
    assert jout["record"].timelines == tout["record"].timelines


def _oracle_line(text):
    return [ln for ln in text.splitlines()
            if ln.startswith("paged engine vs dense")]


CB_CASES = {
    "ragged": [],
    "no-ragged": ["--no-ragged"],
    "no-prefix": ["--shared-prefix", "0"],
    "spec2": ["--spec-k", "2"],
    "rwkv6": ["--arch", "rwkv6_3b"],
}


@pytest.mark.parametrize("case", CB_CASES)
def test_continuous_batching_twin_matches_example(case, monkeypatch,
                                                  capsys):
    argv = ["--requests", str(N_REQ)] + CB_CASES[case]
    runs = Runs(monkeypatch)
    monkeypatch.setattr("sys.argv", ["continuous_batching.py"] + argv)
    _example("continuous_batching").main()
    jtext = capsys.readouterr().out
    res = tcb.main(argv)
    ttext = capsys.readouterr().out
    assert len(runs.jax) == len(runs.port) >= 1
    for (ja, _, jo), (ta, _, to) in zip(runs.jax, runs.port):
        assert ja == ta
        _same_run(jo, to)
    # the dense-cache check: the same verdict, and exact
    assert _oracle_line(ttext) == _oracle_line(jtext) != []
    assert res["exact"] and "exact match" in _oracle_line(ttext)[0]
    if case == "rwkv6":
        assert res["substrate"] == "recurrent" and "baseline" in res
        for text in (jtext, ttext):      # the default prefix turned off
            assert "serves from the recurrent substrate" in text
            assert "requant ops/token, equal-length workload" in text
    if case in ("ragged", "no-prefix", "spec2"):
        assert res["legacy_identical"]
        assert "greedy tokens: identical" in ttext
    if case == "spec2":
        assert "speculative (K=2" in ttext


def test_continuous_batching_twin_notes_the_substrate(monkeypatch, capsys):
    """A recurrent arch with the prefix cache or speculation asked for:
    the note, and both turned off (the reference's behaviour)."""
    runs = Runs(monkeypatch)
    argv = ["--arch", "zamba2_2_7b", "--requests", "2", "--spec-k", "2",
            "--no-ragged"]
    monkeypatch.setattr("sys.argv", ["continuous_batching.py"] + argv)
    _example("continuous_batching").main()
    jtext = capsys.readouterr().out
    res = tcb.main(argv)
    ttext = capsys.readouterr().out
    note = [ln for ln in ttext.splitlines() if ln.startswith("note:")]
    assert note == [ln for ln in jtext.splitlines()
                    if ln.startswith("note:")] != []
    assert "hybrid substrate" in note[0]
    for (_, jkw, jo), (_, tkw, to) in zip(runs.jax, runs.port):
        assert tkw["spec_k"] == jkw["spec_k"] == 0
        assert tkw["shared_prefix"] == jkw["shared_prefix"] == 0
        _same_run(jo, to)
    assert res["exact"]


def test_replay_twin_matches_example(monkeypatch, capsys, tmp_path):
    runs = Runs(monkeypatch)
    jpath, tpath = tmp_path / "j.json", tmp_path / "t.json"
    monkeypatch.setattr("sys.argv", [
        "replay_workload.py", "--requests", str(N_REQ), "--legacy-ab",
        "--record", str(jpath)])
    _example("replay_workload").main()
    jtext = capsys.readouterr().out
    out = treplay.main(["--requests", str(N_REQ), "--legacy-ab",
                        "--record", str(tpath), "--device", "cpu"])
    ttext = capsys.readouterr().out
    assert out["replay"].ok and "-> EXACT" in ttext and "-> EXACT" in jtext
    ab = out["legacy_ab"]
    assert ab.token_identical and not ab.fingerprint_match
    jdiff = next(ln for ln in jtext.splitlines()
                 if ln.startswith("legacy per-shape A/B"))
    assert f"decision diff {len(ab.decision_diff)} lines" in jdiff
    assert len(ab.decision_diff) > 0
    # the capture: the reference's tokens and decisions
    _same_run(runs.jax[0][2], runs.port[0][2])
    assert json.loads(tpath.read_text())["decisions"] == \
        json.loads(jpath.read_text())["decisions"]


def _timeline_lines(text):
    lines = text.splitlines()
    i = next(i for i, ln in enumerate(lines) if ln.startswith("[timelines]"))
    return lines[i:i + 1 + N_REQ]


def test_inspect_twin_matches_example(monkeypatch, capsys, tmp_path):
    """The same workload through each package's engine with ``trace=``
    (the port's on the JAX weights), each trace through its package's
    inspector: the same per-request timelines."""
    runs = Runs(monkeypatch)
    jpath, tpath = tmp_path / "j.json", tmp_path / "t.json"
    kw = dict(n_requests=N_REQ, rate=50.0, mode="fp", calibrate=False,
              shared_prefix=16)
    jserve.serve_engine("qwen3_1_7b", trace=str(jpath), **kw)
    tcb.serve_engine("qwen3_1_7b", trace=str(tpath), **kw)
    _same_run(runs.jax[0][2], runs.port[0][2])
    monkeypatch.setattr("sys.argv", ["inspect_trace.py", str(jpath)])
    _example("inspect_trace").main()
    jtext = capsys.readouterr().out
    s = tinspect.main([str(tpath)])
    ttext = capsys.readouterr().out
    assert _timeline_lines(ttext) == _timeline_lines(jtext)
    assert s["n_requests"] == N_REQ and len(s["requests"]) == N_REQ
    assert s["lanes"]
    # a trace that breaks the schema is refused
    bad = json.loads(tpath.read_text())
    bad["traceEvents"].append({"name": "x", "ph": "X"})
    broken = tmp_path / "bad.json"
    broken.write_text(json.dumps(bad))
    with pytest.raises(SystemExit, match="invalid trace"):
        tinspect.main([str(broken)])


@pytest.mark.skipif(__import__("torch").cuda.is_available(),
                    reason="checks the refusal without a GPU")
@pytest.mark.parametrize("twin", [tcb, treplay])
def test_twins_default_to_the_card(twin):
    """Without ``--device cpu`` the twins run on ``cuda``, and raise where
    there is none."""
    with pytest.raises(RuntimeError, match="GPU|CUDA|cuda"):
        twin.main(["--requests", "1"])
