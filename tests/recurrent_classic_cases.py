"""The recurrent families' classic path against the JAX package: the
cases both archs share, imported by ``test_torch_recurrent_classic_rwkv.py``
(rwkv6_3b, family ``ssm``) and ``test_torch_recurrent_classic_zamba.py``
(zamba2_2_7b, family ``hybrid``), each of which gives the module-scoped
``arch`` fixture these cases and the ``calibrated`` fixture read, so that
each file holds one JAX calibration and the two files run on separate
workers.  On the smoke weights carried over by ``from_jax_params``, fp32
unless stated:

* ``init_cache`` (bf16 and fp32, ``kv_cache_bits`` 8 and None): shapes and
  dtypes; after ``prefill`` the cache's dtypes, component by component;
* ``forward``, ``prefill`` and ``decode_step`` in FP (logits within
  1e-5; the cache's states after the steps within 1e-5 of each tensor's
  largest |value|, as ``tests/test_torch_recurrent_serving.py`` holds
  the slabs: the wkv state reaches 8 here and differs by up to 3e-5
  where the two packages sum in other orders) and uncalibrated INT
  (identical), and the counterpart of the JAX
  ``test_models_smoke.py::test_prefill_decode_consistency`` (rel < 1e-3);
* ``calibrate_lm``: the same module names in the same order, layer 0
  captured first, the dataflow edges under ``shared/``, and tables
  identical to the JAX package's;
* ``quantize_params``' converted leaves are the JAX list with the stacked
  paths unstacked;
* classic ``serve`` (FP and calibrated INT) token-identical to the JAX
  package's prefill + decode loop (``tests/test_recurrent_serving.py::
  _dense_oracle``'s) under the JAX package's calibrated context, and
  through a stand-in graph (the recurrent key captured once, then
  replayed) token-identical to eager;
* ``serve_engine(calibrate=True)`` and ``serve_engine(w8a8=True)`` token-
  identical to the JAX ``serve_engine`` with the same arguments;
* the port's classic tokens equal to the port's engine's on the JAX
  recurrent tests' workload (the counterpart of ``_check_vs_oracle``).

The JAX ``serve`` / ``serve_engine`` calibrate on the same 4 x 32 batch as
the ``calibrated`` fixture, and take its calibration from there.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.core.lm_calibrate import calibrate_lm as jcalibrate  # noqa: E402
from repro.core.qmodel import QuantContext as JCtx  # noqa: E402
from repro.core.qmodel import QuantMode as JMode  # noqa: E402
from repro.core.qmodel import quantize_params as jquantize_params  # noqa
from repro.core.qscheme import quant as jquant  # noqa: E402
from repro.data import SyntheticLMStream  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import attention as jatt  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch.configs import get_smoke_config as tsmoke  # noqa: E402
from repro_torch.core import qmodel as tqmodel  # noqa: E402
from repro_torch.core.lm_calibrate import calibrate_lm  # noqa: E402
from repro_torch.core.qmodel import ModuleBits  # noqa: E402
from repro_torch.core.qmodel import QuantContext as TCtx  # noqa: E402
from repro_torch.core.qmodel import QuantMode as TMode  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import attention as tatt  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.common import rope_tables  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving.scheduler import Request as TRequest  # noqa: E402
from tests.test_torch_recurrent_blocks import tcfg_of  # noqa: E402
from tests.test_torch_recurrent_serving import ENGINE, _workload  # noqa
from tests.test_torch_step_capture import StubGraph  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
NKV = 4                      # the smoke configs' kv_cache_frac_bits
PROMPT, BATCH, GEN = 32, 4, 8
# the one-step code flips phase 20 documents (ROADMAP Queue 3)
FLIP_SHARE = 1e-3


def _kv_bits(arch):
    """The int8 dense cache on zamba2 (its calibration attends over the
    codes); RWKV6 keeps no KV."""
    return 8 if arch.startswith("zamba") else None


def _cfgs(arch, **kw):
    jcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw)
    return jcfg, tcfg_of(jcfg)


@functools.lru_cache(maxsize=None)
def _weights(arch):
    jcfg, _ = _cfgs(arch)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jp, jax.tree.map(np.asarray, jp)


def _tparams(arch, tcfg):
    return TM.from_jax_params(_weights(arch)[1], tcfg, device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, what, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), err_msg=what,
                               **(tol or TOL))


def _codes_match(got, want, what):
    """int8 codes identical, or one-step flips on at most FLIP_SHARE."""
    d = np.abs(got.numpy().astype(np.int32) - np.asarray(want, np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= FLIP_SHARE, \
        f"{what}: {(d > 0).sum()} codes differ, by up to {d.max()}"


def _calib_tokens():
    """The calibration batch of the JAX ``serve`` (4 x 32 prompt, seed 0)
    and ``serve_engine`` (4 rows of max(prompt_lens) = 32)."""
    return SyntheticLMStream(256, PROMPT, BATCH, seed=0).batch(0)["tokens"]


@pytest.fixture(scope="module")
def calibrated(arch):
    """(JAX calibrated context, its report, the port's context and
    report) for the file's arch, on its smoke config with ``_kv_bits``."""
    jcfg, tcfg = _cfgs(arch, kv_cache_bits=_kv_bits(arch))
    jp, _ = _weights(arch)
    tokens = _calib_tokens()
    jctx, jrep = jcalibrate(lambda p, b, c: JM.forward(p, b, jcfg, c),
                            jp, {"tokens": jnp.asarray(tokens)})
    tctx, trep = calibrate_lm(
        lambda p, b, c: TM.forward(p, b, tcfg, c),
        _tparams(arch, tcfg), {"tokens": _t(tokens)})
    return jctx, jrep, tctx, trep


@pytest.fixture
def shared_jax_calibration(calibrated, monkeypatch):
    """The JAX ``serve`` / ``serve_engine`` take the fixture's calibration
    instead of running their own on the same batch (asserted)."""
    def cached(forward_fn, params, batch):
        assert np.array_equal(np.asarray(batch["tokens"]), _calib_tokens())
        return calibrated[:2]
    monkeypatch.setattr(jserve, "calibrate_lm", cached)


def _table(ctx):
    return {k: dataclasses.astuple(v) for k, v in ctx.table.items()}


def _port_ctx(jctx, mode):
    return TCtx(mode=TMode(mode), table={
        k: ModuleBits(**dataclasses.asdict(v)) for k, v in jctx.table.items()})


# ---------------------------------------------------------------------------
# the decode recurrences and the blocks
# ---------------------------------------------------------------------------

def _rwkv_state(rng, cfg, b):
    h = cfg.d_model // trwkv.HEAD_DIM
    return [rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32),
            rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32),
            (rng.standard_normal((b, h, 64, 64)) * 0.5).astype(np.float32)]


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


# ---------------------------------------------------------------------------
# the cache and the model entry points
# ---------------------------------------------------------------------------

def _named(tree):
    return {jax.tree_util.keystr(p): a
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def _tnamed(cache):
    return {f"['{k}'].{f}": t for k, part in cache.items()
            for f, t in zip(part._fields, part)}


def _same_layout(tcache, jcache, values=False):
    jn, tn = _named(jcache), _tnamed(tcache)
    assert sorted(jn) == sorted(tn)
    for name, a in jn.items():
        t = tn[name]
        assert tuple(t.shape) == a.shape, name
        assert str(t.dtype).split(".")[-1] == str(a.dtype), name
        if values:
            assert not t.any(), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_bits", [None, 8])
def test_init_cache_matches_jax(arch, dtype, kv_bits):
    jcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype,
                               kv_cache_bits=kv_bits)
    _same_layout(TM.init_cache(tcfg_of(jcfg), 3, 10, device="cpu"),
                 JM.init_cache(jcfg, 3, 10), values=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_cache_dtypes_match_jax(arch, dtype):
    jcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype,
                               kv_cache_bits=_kv_bits(arch))
    tcfg = tcfg_of(jcfg)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TM.from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    toks = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, size=(2, 9)).astype(np.int32)
    _, jc = JM.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, JCtx(),
                       max_seq=12)
    with torch.no_grad():
        _, tc = TM.prefill(tp, {"tokens": _t(toks)}, tcfg, TCtx(),
                           max_seq=12)
    _same_layout(tc, jc)


@pytest.mark.parametrize("mode", ["fp", "int"])
def test_forward_prefill_decode_match_jax(arch, mode):
    """FP within 1e-5; uncalibrated INT identical (logits and caches)."""
    jcfg, tcfg = _cfgs(arch, kv_cache_bits=_kv_bits(arch))
    jp, _ = _weights(arch)
    tp = _tparams(arch, tcfg)
    jctx, tctx = JCtx(mode=JMode(mode)), TCtx(mode=TMode(mode))
    if mode == "int":
        tp = tqmodel.quantize_weight_tree(tp, tctx, name_fn=TM.qlinear_weight)
    tol = TOL if mode == "fp" else dict(atol=0, rtol=0)
    toks = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, size=(2, 14)).astype(np.int32)
    jfwd, jpre, jdec = _jax_steps(jcfg, jctx, 14)
    jl, _ = jfwd(jp, jnp.asarray(toks))
    with torch.no_grad():
        tl, _ = TM.forward(tp, {"tokens": _t(toks)}, tcfg, tctx)
    _close(tl, jl, "forward", **tol)
    jl, jc = jpre(jp, jnp.asarray(toks[:, :10]))
    with torch.no_grad():
        tl, tc = TM.prefill(tp, {"tokens": _t(toks[:, :10])}, tcfg, tctx,
                            max_seq=14)
        static = {k: t.data_ptr() for k, t in _tnamed(tc).items()}
        _close(tl, jl, "prefill", **tol)
        for i in range(10, 14):
            jl, jc = jdec(jp, jnp.asarray(toks[:, i:i + 1]), jc,
                          jnp.asarray(i, jnp.int32))
            tl, tc = TM.decode_step(tp, _t(toks[:, i:i + 1]), tc,
                                    torch.tensor(i, dtype=torch.int32),
                                    tcfg, tctx)
            _close(tl, jl, f"decode {i}", **tol)
    # the states and K/V were written into the tensors prefill allocated
    assert {k: t.data_ptr() for k, t in _tnamed(tc).items()} == static
    jn = _named(jc)
    for name, t in _tnamed(tc).items():
        want = np.asarray(jn[name], np.float32)
        if t.dtype == torch.int8 and mode == "int":
            assert np.array_equal(t.numpy(), want), name
        elif t.dtype == torch.int8:
            _codes_match(t, want, name)
        else:       # the recurrences run in float in both modes
            _close(t, want, name, atol=1e-5 * np.abs(want).max(), rtol=0)


def test_prefill_decode_consistency(arch):
    """decode(t | prefill(0..t-1)) == forward(0..t)[-1], as the JAX
    package's ``test_models_smoke.py::test_prefill_decode_consistency``."""
    cfg = dataclasses.replace(tsmoke(arch), dtype="float32")
    params = TM.init_params(cfg, 0, device="cpu")
    toks = _t(np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=(2, 64)).astype(np.int32))
    with torch.no_grad():
        full, _ = TM.forward(params, {"tokens": toks}, cfg, TCtx())
        _, cache = TM.prefill(params, {"tokens": toks[:, :63]}, cfg, TCtx(),
                              max_seq=64)
        dec, _ = TM.decode_step(params, toks[:, 63:], cache, 63, cfg, TCtx())
    ref = full[:, -1]
    rel = float((dec - ref).abs().max() / (ref.abs().max() + 1e-9))
    assert rel < 1e-3


# ---------------------------------------------------------------------------
# calibration and the weight conversions
# ---------------------------------------------------------------------------

def test_calibrate_matches_jax(arch, calibrated):
    jctx, jrep, tctx, trep = calibrated
    assert list(tctx.table) == list(jctx.table)
    assert list(trep.results) == list(jrep.results)
    assert _table(tctx) == _table(jctx)
    want = (["rwkv/wr", "rwkv/wk", "rwkv/wv", "rwkv/wg", "rwkv/wo",
             "rwkv_ffn/wk", "rwkv_ffn/wv", "rwkv_ffn/wr"]
            if arch == "rwkv6_3b" else
            ["ssm/w_in", "ssm/w_out", "shared/in_proj", "shared/attn/wq",
             "shared/attn/wk", "shared/attn/wv", "shared/attn/wo",
             "shared/mlp/w1", "shared/mlp/w3", "shared/mlp/w2"])
    assert list(tctx.table) == want + ["lm_head"]
    if arch == "zamba2_2_7b":     # the dataflow edges under shared/
        t = tctx.table
        assert t["shared/attn/wo"].n_x == t["shared/attn/wv"].n_o
        assert t["shared/mlp/w2"].n_x == t["shared/mlp/w1"].n_o
    # the first occurrence of a module is layer 0 (group 0, block 0)
    _, tcfg = _cfgs(arch, kv_cache_bits=_kv_bits(arch))
    tp = _tparams(arch, tcfg)
    with tqmodel.capture_activations() as store, torch.no_grad():
        TM.forward(tp, {"tokens": _t(_calib_tokens())}, tcfg, TCtx())
    first = tp["blocks"][0]
    leaves = ({"rwkv/wr": first["rwkv"]["wr"],
               "rwkv_ffn/wk": first["rwkv"]["wk_ffn"]}
              if arch == "rwkv6_3b" else
              {"ssm/w_in": first["ssm"]["w_in"],
               "ssm/w_out": first["ssm"]["w_out"]})
    for name, w in leaves.items():
        assert store[name][1] is w, name


def test_quantize_params_converts_the_jax_leaves(arch, calibrated):
    jctx = calibrated[0]
    jcfg, tcfg = _cfgs(arch)
    jq = jquantize_params(_weights(arch)[0],
                          dataclasses.replace(jctx, mode=JMode.INT))
    tq = tqmodel.quantize_params(_tparams(arch, tcfg), _port_ctx(jctx, "int"))
    n = tcfg.n_layers if arch == "rwkv6_3b" else len(tq.tree["blocks"])
    want = []
    for path in jq.converted:
        if path.startswith("blocks/"):
            rest = path.split("/", 2)[-1] if arch == "zamba2_2_7b" \
                else path.split("/", 1)[-1]
            want += [f"blocks/{i}/{rest}" for i in range(n)]
        else:
            want.append(path)
    assert sorted(tq.converted) == sorted(want)
    # the channel mix stays float, as in the reference
    assert not any("_ffn" in p for p in tq.converted)


# ---------------------------------------------------------------------------
# classic serve and the engine
# ---------------------------------------------------------------------------

def _jax_loop(jcfg, jp, jctx, prompt, gen):
    """The JAX package's prefill + greedy decode loop
    (``tests/test_recurrent_serving.py::_dense_oracle``'s), batched, its
    steps compiled."""
    _, prefill, decode = _jax_steps(jcfg, jctx, prompt.shape[1] + gen)
    logits, cache = prefill(jp, jnp.asarray(prompt))
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    out = [np.asarray(tok)]
    for i in range(gen - 1):
        logits, cache = decode(jp, tok, cache,
                               jnp.asarray(prompt.shape[1] + i, jnp.int32))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        out.append(np.asarray(tok))
    return np.concatenate(out, axis=1)


def _jax_steps(jcfg, jctx, max_seq):
    """The JAX package's ``forward``, ``prefill`` (a cache of ``max_seq``)
    and ``decode_step``, each ``jax.jit``-compiled."""
    return (jax.jit(lambda p, t: JM.forward(p, {"tokens": t}, jcfg, jctx)),
            jax.jit(lambda p, t: JM.prefill(p, {"tokens": t}, jcfg, jctx,
                                            max_seq=max_seq)),
            jax.jit(lambda p, t, c, pos: JM.decode_step(p, t, c, pos, jcfg,
                                                        jctx)))


def _serve_kw(arch):
    return dict(gen=GEN, batch=BATCH, prompt_len=PROMPT,
                cfg_overrides={"dtype": "float32",
                               "kv_cache_bits": _kv_bits(arch)})


@pytest.mark.parametrize("mode", ["fp", "int"])
def test_serve_matches_jax_loop(arch, mode, calibrated):
    jcfg, tcfg = _cfgs(arch, kv_cache_bits=_kv_bits(arch))
    jctx = JCtx() if mode == "fp" else dataclasses.replace(
        calibrated[0], mode=JMode.INT)
    want = _jax_loop(jcfg, _weights(arch)[0], jctx, _calib_tokens(), GEN)
    o = tserve.serve(arch, mode=mode, params=_tparams(arch, tcfg),
                     device="cpu", **_serve_kw(arch))
    assert np.array_equal(o["tokens"], want)
    if mode == "int":
        assert _table(o["ctx"]) == _table(calibrated[0])


class StateRestoringStub(StubGraph):
    """The stand-in graph for the classic decode step, which advances the
    cache's states in place: a CUDA graph's capture executes no kernel, so
    the stand-in's capture, which runs the step for its output, puts the
    cache back as it was."""

    cache = None

    def capture(self, fn):
        saved = [t.clone() for t in _tnamed(self.cache).values()]
        super().capture(fn)
        for t, v in zip(_tnamed(self.cache).values(), saved):
            t.copy_(v)


def test_serve_through_stand_in_graph(arch, monkeypatch):
    _, tcfg = _cfgs(arch, kv_cache_bits=_kv_bits(arch))
    tp = _tparams(arch, tcfg)
    real = tsteps.build_prefill_step

    def recording(cfg, ctx, max_seq=None):
        step = real(cfg, ctx, max_seq=max_seq)

        def prefill(params, batch):
            logits, cache = step(params, batch)
            StateRestoringStub.cache = cache
            return logits, cache
        return prefill

    monkeypatch.setattr(tsteps, "build_prefill_step", recording)
    kw = dict(mode="int", calibrate=False, params=tp, device="cpu",
              **_serve_kw(arch))
    eager = tserve.serve(arch, graphs=False, **kw)
    keys = []
    real_run = tsteps.StepGraphs.run

    def run(self, key, fn, arrays):
        keys.append(key)
        return real_run(self, key, fn, arrays)

    monkeypatch.setattr(tsteps.StepGraphs, "run", run)
    o = tserve.serve(arch, graphs=True, _graph_factory=StateRestoringStub,
                     **kw)
    assert np.array_equal(o["tokens"], eager["tokens"])
    assert o["graphs"] == dict(enabled=True, first_calls=1, captures=1,
                               replays=GEN - 2)
    assert len(set(keys)) == 1 and keys[0][:2] == ("decode", BATCH)
    assert keys[0] == tsteps.serve_step_key(np.zeros((BATCH, 1)),
                                            StateRestoringStub.cache)


@pytest.mark.parametrize("w8a8", [False, True])
def test_serve_engine_calibrated_matches_jax(arch, w8a8,
                                             shared_jax_calibration):
    """``calibrate=True`` (INT) and ``w8a8=True`` on the JAX recurrent
    tests' workload: the port's tokens equal the JAX engine's."""
    jcfg, tcfg = _cfgs(arch, kv_cache_bits=8)
    kw = dict(mode="int", calibrate=True, w8a8=w8a8, seed=0,
              cfg_overrides={"dtype": "float32"}, **ENGINE)
    jo = jserve.serve_engine(arch, requests=_workload(
        JRequest, jcfg.vocab_size), **kw)
    to = tserve.serve_engine(arch, requests=_workload(
        TRequest, jcfg.vocab_size), params=_tparams(arch, tcfg),
        device="cpu", **kw)
    assert to["report"]["completed"] == 4
    assert sorted(to["outputs"]) == sorted(jo["outputs"])
    for rid, toks in jo["outputs"].items():
        assert np.array_equal(np.asarray(toks), to["outputs"][rid]), rid
    assert _table(to["ctx"]) == _table(jo["ctx"])
    if w8a8:
        assert to["quantized"] is not None
        assert to["engine"].launches["int8_matmul"] == 0    # the CPU


def test_classic_tokens_equal_engine_tokens(arch):
    """The port's prefill + decode loop and the port's engine (fp32 slabs,
    FP) give the same greedy tokens on every request of the JAX recurrent
    tests' workload."""
    jcfg, tcfg = _cfgs(arch, kv_cache_bits=_kv_bits(arch))
    tp = _tparams(arch, tcfg)
    reqs = _workload(TRequest, jcfg.vocab_size)
    eng = tengine.ServingEngine(tcfg, tp, TCtx(), device="cpu", **ENGINE)
    with torch.no_grad():
        eng.run(reqs)
        outs = eng.outputs()
        for r in reqs:
            logits, cache = TM.prefill(tp, {"tokens": _t(r.prompt[None])},
                                       tcfg, TCtx(), max_seq=len(r.prompt)
                                       + r.max_new_tokens)
            tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
            got = [int(tok)]
            for i in range(r.max_new_tokens - 1):
                logits, cache = TM.decode_step(
                    tp, tok, cache, len(r.prompt) + i, tcfg, TCtx())
                tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
                got.append(int(tok))
            assert outs[r.rid].tolist() == got, r.rid
