"""Differential tests of the port's fixed-slab recurrent substrate against
the JAX package's, on the JAX package's own smoke weights carried over by
``from_jax_params``, fp32:

* ``init_paged_state``: the arenas' shapes and dtypes, RWKV6 and zamba2,
  fp32 and int8 slabs, bf16-typed and int8 KV pools;
* ``paged_recurrent_step``: two steps (prefill chunks with an idle lane,
  then a decode row beside a chunk) of both families, fp32 and int8
  slabs, FP and INT mode, the trash slab passed through bit for bit.
  Tolerances, as measured: logits within atol = rtol = 1e-5 (INT: every
  logit on the same output-grid code); fp32 slab values within 1e-5 of
  the tensor's largest |value| (the wkv state reaches 27 and differs by
  up to 3e-5 where the two sum in other orders); int8 pool codes
  identical; int8 slab codes identical in INT mode, and in FP mode
  within one step on at most 0.1% of the codes, the logits after such a
  flip within atol = rtol = 1e-3 (RWKV6: one wkv code of 65536 flips in
  the first step, 30 in the second, the logits move by 3e-4);
* the engines, greedy, on the JAX recurrent tests' workload (4 requests
  through 2 slots, so slabs are reused; chunk 8, 4-row blocks), on the
  virtual clock: RWKV6 and zamba2 with fp32 and int8 slabs, FP and INT,
  and zamba2 on an undersized pool (recompute preemption): identical
  tokens, every ``report()`` value but the per-shape wall times equal
  (``state_pool.*`` and the Table-5 counters included), identical
  scheduler decisions and a clean golden-schema diff;
* a mid-decode preemption on RWKV6 snapshots the slab to the host and the
  resumed request finishes on the JAX engine's tokens, fp32 and int8;
* ``spec_k`` and ``prefix_cache=True`` refused at construction with the
  reference's messages, and the calibrated INT engine served;
* a zamba2 record replayed across the packages with an empty decision
  diff;
* the recurrent step key through ``StepGraphs`` with the stand-in graph:
  one key, its first call eager, then one capture and replays, every
  dispatch's launches counted once, tokens those of the eager engine.
"""
import contextlib
import dataclasses
import functools
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.core.qmodel import QuantContext as JCtx  # noqa: E402
from repro.core.qmodel import QuantMode as JMode  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.obs import replay as jreplay  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import RequestState as JState  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch.core.qmodel import QuantContext as TCtx  # noqa: E402
from repro_torch.core.qmodel import QuantMode as TMode  # noqa: E402
from repro_torch.core.qmodel import quantize_weight_tree  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.steps import StepGraphs  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.obs import replay as treplay  # noqa: E402
from repro_torch.obs import schema as tschema  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving.scheduler import Request as TRequest  # noqa: E402
from repro_torch.serving.scheduler import RequestState as TState  # noqa: E402
from tests.test_torch_recurrent_blocks import tcfg_of  # noqa: E402
from tests.test_torch_step_capture import StubGraph  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

ARCHS = ["rwkv6_3b", "zamba2_2_7b"]
TOL = dict(atol=1e-5, rtol=1e-5)
ENGINE = dict(n_slots=2, chunk=8, max_model_len=64, block_size=4)
# scenario -> (arch, serve_engine options)
SCENARIOS = {
    "rwkv fp": ("rwkv6_3b", dict(mode="fp")),
    "rwkv int8 slabs": ("rwkv6_3b", dict(mode="fp", state_bits=8)),
    "rwkv int": ("rwkv6_3b", dict(mode="int", calibrate=False)),
    "zamba fp": ("zamba2_2_7b", dict(mode="fp")),
    "zamba int8 slabs": ("zamba2_2_7b", dict(mode="fp", state_bits=8)),
    "zamba int": ("zamba2_2_7b", dict(mode="int", calibrate=False)),
    "zamba fp preempt": ("zamba2_2_7b", dict(mode="fp", num_blocks=8,
                                             max_model_len=28)),
}


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The JAX package's ``init_params`` at seed 0, compiled once (op by
    op it compiles every primitive at every shape).  The JAX engines take
    these same weights (``_jax_weights``), as the port's do."""
    jcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jp = jax.jit(JM.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(0))
    return jcfg, jp, jax.tree.map(np.asarray, jp)


@contextlib.contextmanager
def _jax_weights(arch):
    """The JAX ``serve_engine`` builds its weights by ``init_params(cfg,
    PRNGKey(seed))`` from the fp32 smoke config at seed 0; inside this
    context it takes ``_weights(arch)``'s instead (the same function,
    compiled: for rwkv6 its numbers differ from the op-by-op ones in the
    last bit, so both packages must take one set)."""
    real, jp = JM.init_params, _weights(arch)[1]
    JM.init_params = lambda cfg, key: jp
    try:
        yield
    finally:
        JM.init_params = real


@functools.lru_cache(maxsize=None)
def _jax_step(jcfg, mode):
    """The JAX package's ``paged_recurrent_step``, compiled once per
    config and mode."""
    jctx = JCtx(mode=JMode(mode))
    return jax.jit(lambda p, t, c, ids, ql, pos, bt: JM.paged_recurrent_step(
        p, t, c, ids, ql, pos, bt, jcfg, jctx))


def _tparams(arch, state_bits=None, kv_bits=None):
    jcfg, _, npt = _weights(arch)
    tcfg = dataclasses.replace(tcfg_of(jcfg), state_bits=state_bits,
                               kv_cache_bits=kv_bits)
    return tcfg, TM.from_jax_params(npt, tcfg, device="cpu")


def _workload(cls, vocab, seed=4, n=4):
    """The JAX recurrent tests' workload, built with ``cls``."""
    rng = np.random.default_rng(seed)
    t, reqs = 0.0, []
    for i in range(n):
        t += float(rng.exponential(0.02))
        reqs.append(cls(rid=i, prompt=rng.integers(0, vocab, size=int(
            rng.integers(6, 20))).astype(np.int32),
            max_new_tokens=int(rng.integers(4, 9)), arrival=t))
    return reqs


def _flat(d, pre=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict) and k not in ("step_shapes", "status"):
            out.update(_flat(v, f"{pre}{k}."))
        else:
            out[pre + k] = v
    return out


# ---------------------------------------------------------------------------
# init_paged_state and paged_recurrent_step
# ---------------------------------------------------------------------------

def _leaves(tree):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _leaves_named(k, v)}
    return dict(_leaves_named("", tree))


def _leaves_named(name, node):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves_named(f"{name}/{k}", v)
    elif isinstance(node, tuple):
        for k, v in zip(node._fields, node):
            yield from _leaves_named(f"{name}/{k}", v)
    else:
        yield name, node


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("state_bits,kv_bits", [(None, None), (8, 8)])
def test_init_paged_state_matches_jax(arch, state_bits, kv_bits):
    jcfg = dataclasses.replace(get_smoke_config(arch),
                               state_bits=state_bits, kv_cache_bits=kv_bits)
    tcfg = tcfg_of(jcfg)
    kw = dict(num_blocks=6, block_size=4) if arch.startswith("zamba") else {}
    jst = _leaves(JM.init_paged_state(jcfg, 5, **kw))
    tst = _leaves(TM.init_paged_state(tcfg, 5, device="cpu", **kw))
    assert sorted(jst) == sorted(tst)
    for name, a in jst.items():
        t = tst[name]
        assert tuple(t.shape) == a.shape, name
        assert str(t.dtype).split(".")[-1] == str(a.dtype), name
        assert (t.float().numpy() == np.asarray(a, np.float32)).all()


def _rec_steps(vocab, bs, nbmax, hybrid):
    """Two steps of (tokens, slab_ids, q_len, positions, tables): slots
    0 and 1 prefill 6 and 8 tokens on slabs 2 and 1, slot 2 idle on the
    trash slab; then slot 0 decodes one token while slot 1 feeds 5 more."""
    rng = np.random.default_rng(7)
    tok = rng.integers(0, vocab, size=(3, 8)).astype(np.int32)
    s1 = (tok, np.asarray([2, 1, 0], np.int32), np.asarray([6, 8, 0],
                                                            np.int32))
    tok2 = np.zeros((3, 8), np.int32)
    tok2[0, 0] = 5
    tok2[1, :5] = rng.integers(0, vocab, size=5)
    s2 = (tok2, np.asarray([2, 1, 0], np.int32), np.asarray([1, 5, 0],
                                                             np.int32))
    out = []
    for (t, ids, ql), start in ((s1, (0, 0)), (s2, (6, 8))):
        pos = bt = None
        if hybrid:
            pos = np.full((3, 8), nbmax * bs, np.int32)
            bt = np.zeros((3, nbmax + 1), np.int32)
            bt[0, :nbmax] = 1 + np.arange(nbmax)
            bt[1, :nbmax] = 1 + nbmax + np.arange(nbmax)
            for r in (0, 1):
                pos[r, :ql[r]] = start[r] + np.arange(ql[r])
        out.append((t, ids, ql, pos, bt))
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["fp", "int"])
@pytest.mark.parametrize("state_bits", [None, 8])
def test_paged_recurrent_step_matches_jax(arch, mode, state_bits):
    jcfg0, jp, _ = _weights(arch)
    hybrid = arch.startswith("zamba")
    kv_bits = 8 if hybrid else None
    jcfg = dataclasses.replace(jcfg0, state_bits=state_bits,
                               kv_cache_bits=kv_bits)
    tcfg, tp = _tparams(arch, state_bits, kv_bits)
    tctx = TCtx(mode=TMode(mode))
    if mode == "int":
        tp = quantize_weight_tree(tp, tctx, name_fn=TM.qlinear_weight)
    bs, nbmax = 4, 4
    kw = dict(num_blocks=1 + 2 * nbmax, block_size=bs) if hybrid else {}
    jcache = JM.init_paged_state(jcfg, 4, **kw)
    tcache = TM.init_paged_state(tcfg, 4, device="cpu", **kw)
    for step in _rec_steps(jcfg.vocab_size, bs, nbmax, hybrid):
        t, ids, ql, pos, bt = step
        jl, jcache = _jax_step(jcfg, mode)(
            jp, jnp.asarray(t), jcache, jnp.asarray(ids), jnp.asarray(ql),
            None if pos is None else jnp.asarray(pos),
            None if bt is None else jnp.asarray(bt))
        trash = {k: v.clone() for k, v in _leaves(tcache).items()
                 if k.startswith(("/state", "/ssm"))}
        tl, tcache = TM.paged_recurrent_step(
            tp, torch.from_numpy(t), tcache, torch.from_numpy(ids),
            torch.from_numpy(ql), None if pos is None
            else torch.from_numpy(pos),
            None if bt is None else torch.from_numpy(bt), tcfg, tctx)
        # an FP-mode int8 slab code may flip where the float state sits on
        # a rounding boundary (the two packages sum in other orders)
        flips = mode == "fp" and state_bits == 8
        if mode == "int":
            # every logit on the same 2^-4 output-grid code
            assert np.array_equal(tl.numpy(), np.asarray(jl))
        else:
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       **(dict(atol=1e-3, rtol=1e-3)
                                          if flips else TOL))
        tst, jst = _leaves(tcache), _leaves(jcache)
        for name, a in jst.items():
            got, want = tst[name].numpy(), np.asarray(a)
            if name.startswith("/paged_kv"):
                got, want = got[:, 1:], want[:, 1:]      # past trash block
            if got.dtype == np.int8 and flips and not name.startswith(
                    "/paged_kv"):
                d = np.abs(got.astype(np.int32) - want)
                assert d.max() <= 1 and (d > 0).mean() <= 1e-3, name
            elif got.dtype == np.int8 or name == "/exp":
                assert np.array_equal(got, want), name
            else:
                np.testing.assert_allclose(
                    got, want, err_msg=name, rtol=1e-5,
                    atol=1e-5 * max(1.0, float(np.abs(want).max())))
        # the idle lane's slab (trash slab 0) passes through bit for bit
        axis = 1 if arch == "rwkv6_3b" else 2
        for name, before in trash.items():
            assert torch.equal(before.select(axis, 0),
                               tst[name].select(axis, 0)), name


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

def _kw(name, **extra):
    arch, opts = SCENARIOS[name]
    kw = dict(ENGINE, cfg_overrides={"dtype": "float32"}, kv_bits=8,
              record=True, trace=True)
    kw.update(opts, **extra)
    return arch, kw


@functools.lru_cache(maxsize=None)
def _runs(name):
    arch, kw = _kw(name)
    jcfg, _, _ = _weights(arch)
    with _jax_weights(arch):
        jo = jserve.serve_engine(arch, requests=_workload(
            JRequest, jcfg.vocab_size), **kw)
    tcfg, tp = _tparams(arch, kw.get("state_bits"), 8)
    to = tserve.serve_engine(arch, requests=_workload(
        TRequest, jcfg.vocab_size), params=tp, device="cpu", **kw)
    for o, mod in ((jo, None), (to, tschema)):
        if mod is not None:
            o["schema"] = mod.schema_of(o["engine"].metrics)
    return jo, to


@pytest.mark.parametrize("name", SCENARIOS)
def test_engine_tokens_identical_to_jax(name):
    jo, to = _runs(name)
    assert sorted(jo["outputs"]) == sorted(to["outputs"]) == [0, 1, 2, 3]
    for rid, toks in jo["outputs"].items():
        assert np.array_equal(toks, to["outputs"][rid]), rid
    eng = to["engine"]
    eng.state_pool.check_invariants()
    assert eng.state_pool.n_live == 0
    assert eng.state_pool.stats.allocs >= 4
    if eng.pool is not None:
        eng.pool.check_invariants()
        assert eng.pool.n_live == 0


@pytest.mark.parametrize("name", SCENARIOS)
def test_engine_report_identical_to_jax(name):
    """Every report value but the per-shape wall times (the virtual clock
    makes every latency deterministic), and the JAX report's keys
    exactly apart from the port's extras."""
    jo, to = _runs(name)
    jf, tf = _flat(jo["report"]), _flat(to["report"])
    assert {k.split(".")[0] for k in tf if k not in jf} \
        == set(tschema.PORT_EXTRAS)
    jf.pop("step_shapes")
    for key, want in jf.items():
        assert tf[key] == want, key
    tr = to["report"]
    arch = SCENARIOS[name][0]
    assert tr["substrate"] == ("hybrid" if arch.startswith("zamba")
                               else "recurrent")
    assert tr["recurrent_steps"] > 0 and tr["ragged"] is False
    assert set(tr["step_shapes"]) == {"recurrent_2xC8"}
    st = tr["state_pool"]
    assert st["requant_ops_state"] == (
        st["state_quant_ops_per_step"]
        * (tr["prefill_chunks"] + tr["energy"]["decode"]["tokens"]))
    if name.endswith("preempt"):
        assert tr["preemptions"] > 0
    want_launches = {"int8_matmul": 0}
    if arch.startswith("zamba"):
        want_launches["paged_attention"] = 0
    assert tr["kernel_launches"] == want_launches


@pytest.mark.parametrize("name", SCENARIOS)
def test_engine_decisions_and_schema(name):
    jo, to = _runs(name)
    assert treplay.diff_decisions(jo["record"].decisions,
                                  to["record"].decisions) == []
    names = {n for n, _ in to["record"].decisions}
    assert {"pool.slab_alloc", "pool.slab_free", "sched.admit"} <= names
    hybrid = SCENARIOS[name][0].startswith("zamba")
    errs = tschema.diff_schema(to["schema"], spec=False, cache=False,
                               kv=hybrid, slab=True)
    assert errs == [], "\n".join(errs)
    rep = to["report"]
    assert rep["prefix_cache"] is None and rep["speculative"] is None
    assert (rep["pool"] is None) is not hybrid


def _drive_with_preemption(eng, req, decode_state):
    """Serve ``req`` alone, preempting it once after 4 decoded tokens."""
    eng.submit(req)
    preempted = False
    for _ in range(200):
        if eng.sched.idle:
            break
        if (not preempted and req.state is decode_state
                and len(req.generated) >= 4):
            eng.sched.preempt(req, eng._now())
            assert req.snapshot is not None
            preempted = True
        eng.step()
    assert preempted and eng.sched.idle
    return eng.outputs()[req.rid]


@pytest.mark.parametrize("state_bits", [None, 8])
def test_snapshot_preemption_resumes_on_jax_tokens(state_bits):
    jcfg0, jp, _ = _weights("rwkv6_3b")
    jcfg = dataclasses.replace(jcfg0, state_bits=state_bits)
    tcfg, tp = _tparams("rwkv6_3b", state_bits)
    prompt = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, size=19).astype(np.int32)
    outs = []
    for eng, cls, dec in (
            (JEngine(jcfg, jp, JCtx(), **ENGINE), JRequest, JState.DECODE),
            (tengine.ServingEngine(tcfg, tp, TCtx(), device="cpu", **ENGINE),
             TRequest, TState.DECODE)):
        req = cls(rid=0, prompt=prompt, max_new_tokens=10)
        outs.append(_drive_with_preemption(eng, req, dec))
        assert eng.state_pool.stats.seq_evictions == 1
    assert np.array_equal(outs[0], outs[1]) and len(outs[1]) == 10
    # and the uninterrupted run's tokens
    plain = tengine.ServingEngine(tcfg, tp, TCtx(), device="cpu", **ENGINE)
    req = TRequest(rid=0, prompt=prompt, max_new_tokens=10)
    plain.submit(req)
    while not plain.sched.idle:
        plain.step()
    assert np.array_equal(plain.outputs()[0], outs[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_and_prefix_cache_rejected_at_construction(arch):
    tcfg, tp = _tparams(arch)
    with pytest.raises(ValueError, match="speculative decoding"):
        tengine.ServingEngine(tcfg, tp, TCtx(), device="cpu", spec_k=2,
                              **ENGINE)
    with pytest.raises(ValueError, match="not an addressable token"):
        tengine.ServingEngine(tcfg, tp, TCtx(), device="cpu",
                              prefix_cache=True, **ENGINE)
    # calibration is no longer refused: the calibrated INT engine serves
    out = tserve.serve_engine(arch, mode="int", calibrate=True,
                              device="cpu", n_requests=1)
    assert out["report"]["completed"] == 1
    assert out["ctx"].mode is TMode.INT and "lm_head" in out["ctx"].table


def _round_trip(rec_mod, rec):
    return rec_mod.WorkloadRecord.from_json(
        json.loads(json.dumps(rec.to_json())))


@pytest.mark.parametrize("way", ["jax->torch", "torch->jax"])
def test_zamba2_record_replays_across_packages(way):
    name = "zamba fp preempt"
    jo, to = _runs(name)
    if way == "jax->torch":
        arch, kw = _kw(name)
        tcfg, tp = _tparams(arch, None, 8)
        rec = _round_trip(treplay, jo["record"])
        fresh = tserve.serve_engine(arch, requests=treplay.build_requests(
            rec), params=tp, device="cpu", **kw)["engine"]
        res = treplay.replay_workload(rec, fresh)
    else:
        arch, kw = _kw(name)
        rec = _round_trip(jreplay, to["record"])
        with _jax_weights(arch):
            fresh = jserve.serve_engine(
                arch, requests=jreplay.build_requests(rec), **kw)["engine"]
        res = jreplay.replay_workload(rec, fresh)
    assert res.token_identical and res.decision_diff == [] and res.ok
    assert res.outputs == jo["record"].outputs


# ---------------------------------------------------------------------------
# the recurrent key through the compiled step's bookkeeping
# ---------------------------------------------------------------------------

class SlabRestoringStub(StubGraph):
    """The stand-in graph for a step that advances state in place: a CUDA
    graph's capture runs the step's Python (its kernel wrappers count
    their launches) but executes no kernel, so the stand-in's capture,
    which runs the step for its output, puts the engine's slabs and pool
    back as they were."""

    def __init__(self, generator, pool, stream, cache):
        super().__init__(generator, pool, stream)
        self.state = list(_leaves(cache).values())

    def capture(self, fn):
        saved = [t.clone() for t in self.state]
        super().capture(fn)
        for t, v in zip(self.state, saved):
            t.copy_(v)


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_key_through_stand_in_graphs(arch, monkeypatch):
    """The step function counts, per dispatch, the launches its kernel
    wrappers would make on the card (one K2 per projection and the head,
    one K4 per group): the eager first call counts them, the capture
    takes them back out, each replay adds them."""
    tcfg, tp = _tparams(arch, None, 8)
    ctx = TCtx(mode=TMode.INT)
    tp = quantize_weight_tree(tp, ctx, name_fn=TM.qlinear_weight)
    vocab = tcfg.vocab_size
    eager = tengine.ServingEngine(tcfg, tp, ctx, device="cpu", **ENGINE)
    with torch.no_grad():
        eager.run(_workload(TRequest, vocab))
    if arch == "rwkv6_3b":
        per = {"int8_matmul": 8 * tcfg.n_layers + 1}
    else:
        groups = tcfg.n_layers // tcfg.hybrid.attn_every
        per = {"int8_matmul": 2 * tcfg.n_layers + 8 * groups + 1,
               "paged_attention": groups}
    real = tengine.build_recurrent_step

    def counting_build(cfg, ctx):
        step = real(cfg, ctx)

        def counted(*a, **k):
            for name, n in per.items():
                tops.LAUNCHES[name] += n
            return step(*a, **k)
        return counted

    monkeypatch.setattr(tengine, "build_recurrent_step", counting_build)
    monkeypatch.setattr(tengine.ServingEngine, "_plans_work",
                        lambda self: True)
    staged = tengine.ServingEngine(tcfg, tp, ctx, device="cpu", **ENGINE)
    staged.graphs = StepGraphs(
        "cpu", staged.generator, capture=True,
        graph_factory=lambda g, p, st: SlabRestoringStub(g, p, st,
                                                         staged.cache))
    tops.reset_launch_counts()
    with torch.no_grad():
        rep = staged.run(_workload(TRequest, vocab))
    for rid, toks in eager.outputs().items():
        assert np.array_equal(toks, staged.outputs()[rid]), rid
    n = rep["recurrent_steps"]
    assert rep["step_graphs"] == {"enabled": True, "keys": 1,
                                  "first_calls": 1, "captures": 1,
                                  "replays": n - 1}
    assert staged.graphs.keys == [("recurrent", 2, 8, None, False, False)]
    assert rep["kernel_launches"] == {k: v * n for k, v in per.items()}
    assert {k: tops.LAUNCHES[k] for k in per} == rep["kernel_launches"]
    tops.reset_launch_counts()
