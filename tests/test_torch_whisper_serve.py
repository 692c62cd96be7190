"""whisper_large_v3 through the port's classic ``serve`` against the JAX
package, on the fp32 smoke config with the JAX weights (attention biases
drawn from a seed, ``tests/test_torch_whisper.py``'s ``weights``):

* Algorithm 1 on the serve prompt (tokens and stub frame embeddings):
  the port's table identical to the reference's, all 11 modules, in the
  reference's order (the encoder's layer 0 sets the ``attn/*`` and
  ``mlp/*`` grids the decoder shares; ``attn/wo`` and ``mlp/w2`` chained,
  ``cross/wo`` not);
* ``serve`` greedy tokens identical to the JAX prefill + decode loop in
  FP and calibrated INT (INT with the reference's attention patched into
  the port's plain versions, ``test_torch_whisper.reference_attention``),
  and through the stand-in graph identical to eager, the decode step
  keyed on the audio cache's shapes;
* a calibrated INT forward over the pre-quantized tree
  (``quantize_weight_tree(name_fn=qlinear_weight)``) equal to the
  on-the-fly forward bit for bit, and broken when ``cross/*`` takes the
  ``attn/*`` grids;
* the engines' entry points refuse the audio family, naming the classic
  path.

The JAX calibration runs once, in the module-scoped ``calibrated``
fixture, and each JAX loop once per context (``functools.lru_cache``).
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core.lm_calibrate import calibrate_lm as jcalibrate  # noqa: E402
from repro.core.qmodel import QuantContext as JCtx  # noqa: E402
from repro.core.qmodel import QuantMode as JMode  # noqa: E402
from repro.data import SyntheticLMStream  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.core import qmodel as tqmodel  # noqa: E402
from repro_torch.core.lm_calibrate import calibrate_lm  # noqa: E402
from repro_torch.core.qmodel import ModuleBits  # noqa: E402
from repro_torch.core.qmodel import QuantContext as TCtx  # noqa: E402
from repro_torch.core.qmodel import QuantMode as TMode  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from tests.test_torch_step_capture import StubGraph  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401
from tests.test_torch_whisper import (ARCH, cfgs, reference_attention,  # noqa: E402
                                      t_, tparams, weights)

BATCH, PROMPT, GEN = 2, 8, 6
NAMES = ["attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/w1", "mlp/w2",
         "cross/wq", "cross/wk", "cross/wv", "cross/wo", "lm_head"]


def prompt():
    """The serve prompt of both packages (seed 0): tokens and features."""
    jcfg, _ = cfgs()
    return SyntheticLMStream(jcfg.vocab_size, PROMPT, BATCH, seed=0,
                             encoder_seq=jcfg.encdec.encoder_seq,
                             d_model=jcfg.d_model).batch(0)


def table(ctx):
    return {k: dataclasses.astuple(v) for k, v in ctx.table.items()}


@pytest.fixture(scope="module")
def calibrated():
    """(JAX context, report, port context, report) on the serve prompt."""
    jcfg, tcfg = cfgs()
    b = {k: v for k, v in prompt().items()
         if k in ("tokens", "encoder_features")}
    jctx, jrep = jcalibrate(lambda p, b, c: JM.forward(p, b, jcfg, c),
                            weights()[0], {k: jnp.asarray(v)
                                           for k, v in b.items()})
    with torch.no_grad():
        tctx, trep = calibrate_lm(lambda p, b, c: TM.forward(p, b, tcfg, c),
                                  tparams(tcfg), {k: t_(v)
                                                  for k, v in b.items()})
    return jctx, jrep, tctx, trep


@functools.lru_cache(maxsize=None)
def jax_loop(mode, jtable=()):
    """The JAX package's prefill + greedy decode loop (compiled) on the
    serve prompt, over ``attn_kernel='flash'``; INT on ``jtable``."""
    from repro.core.qmodel import ModuleBits as JBits
    jcfg, _ = cfgs(attn_kernel="flash")
    jctx = JCtx(mode=JMode(mode), table={n: JBits(*v) for n, v in jtable})
    jp = weights()[0]
    b = {k: jnp.asarray(v) for k, v in prompt().items()
         if k in ("tokens", "encoder_features")}
    prefill = jax.jit(lambda p, b: JM.prefill(p, b, jcfg, jctx,
                                              max_seq=PROMPT + GEN))
    decode = jax.jit(lambda p, t, c, pos: JM.decode_step(p, t, c, pos, jcfg,
                                                         jctx))
    logits, cache = prefill(jp, b)
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    out = [np.asarray(tok)]
    for i in range(GEN - 1):
        logits, cache = decode(jp, tok, cache, jnp.asarray(PROMPT + i,
                                                           jnp.int32))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        out.append(np.asarray(tok))
    return np.concatenate(out, axis=1)


def serve_kw(**kw):
    _, tcfg = cfgs()
    return dict(gen=GEN, batch=BATCH, prompt_len=PROMPT, device="cpu",
                params=tparams(tcfg), attn_kernel="flash",
                cfg_overrides={"dtype": "float32"}, **kw)


def test_calibrate_matches_jax(calibrated):
    jctx, jrep, tctx, trep = calibrated
    assert list(tctx.table) == list(jctx.table) == NAMES
    assert list(trep.results) == list(jrep.results)
    assert table(tctx) == table(jctx)
    t = tctx.table
    assert t["attn/wo"].n_x == t["attn/wv"].n_o
    assert t["mlp/w2"].n_x == t["mlp/w1"].n_o
    # the attention biases take their own grid
    assert all(t[n].n_b is not None for n in NAMES if n[-2:] in
               ("wq", "wk", "wv"))


@pytest.mark.parametrize("mode", ["fp", "int"])
def test_serve_matches_jax_loop(mode, calibrated, monkeypatch):
    jctx = calibrated[0]
    if mode == "int":
        reference_attention(monkeypatch)
        want = jax_loop("int", tuple((n, dataclasses.astuple(v))
                                     for n, v in jctx.table.items()))
    else:
        want = jax_loop("fp")
    o = tserve.serve(ARCH, mode=mode, **serve_kw())
    assert o["tokens"].shape == (BATCH, GEN)
    assert np.array_equal(o["tokens"], want)
    if mode == "int":
        assert table(o["ctx"]) == table(jctx)
        assert o["calibrate_s"] > 0
    assert not any(tops.LAUNCHES.values())


def test_serve_through_stand_in_graph():
    """Classic ``serve`` (INT, uncalibrated) through the stand-in graph:
    the decode key, naming the cache's ``memory`` tensor beside ``kv``,
    captured once and replayed, tokens equal to eager."""
    kw = serve_kw(mode="int", calibrate=False)
    eager = tserve.serve(ARCH, graphs=False, **kw)
    o = tserve.serve(ARCH, graphs=True, _graph_factory=StubGraph, **kw)
    assert np.array_equal(o["tokens"], eager["tokens"])
    assert o["graphs"] == dict(enabled=True, first_calls=1, captures=1,
                               replays=GEN - 2)
    assert not any(tops.LAUNCHES.values())
    _, tcfg = cfgs()
    cache = TM.init_cache(tcfg, BATCH, PROMPT + GEN, device="cpu")
    kv = (BATCH, PROMPT + GEN, tcfg.n_kv_heads, tcfg.resolved_head_dim)
    assert tsteps.serve_step_key(np.zeros((BATCH, 1)), cache) == (
        "decode", BATCH, (("kv.k", (2,) + kv), ("kv.v", (2,) + kv),
                          ("memory", (BATCH, 64, tcfg.d_model))))


def _forward(tree, tcfg, ctx):
    b = prompt()
    with torch.no_grad():
        return TM.forward(tree, {"tokens": t_(b["tokens"]),
                                 "encoder_features": t_(b["encoder_features"])},
                          tcfg, ctx)[0]


def test_prequantized_tree_equals_on_the_fly(calibrated):
    """The pre-quantized tree (every weight on its module's grid, biases
    float) gives the on-the-fly forward bit for bit; mapping ``cross/*``
    onto the ``attn/*`` grids breaks it.  The default rule (``name_fn=
    None``: each 2-D leaf on its longest table suffix) names whisper's
    leaves as ``qlinear_weight`` does, so it gives the same tree."""
    _, tcfg = cfgs()
    # the calibrated table, each cross module's weight grid one bit
    # coarser than its attn twin's (calibration gives both the same n_w
    # here: the weights are drawn at one scale), so that a leaf on the
    # wrong module's grid shows
    ctx = TCtx(mode=TMode.INT, table={
        k: dataclasses.replace(
            ModuleBits(**dataclasses.asdict(v)),
            n_w=v.n_w - int(k.startswith("cross/")))
        for k, v in calibrated[0].table.items()})
    assert ctx.table["cross/wq"].n_w != ctx.table["attn/wq"].n_w
    tp = tparams(tcfg)
    name_fn = functools.partial(TM.qlinear_weight, cfg=tcfg)
    pre = tqmodel.quantize_weight_tree(tp, ctx, name_fn=name_fn)
    blk, enc = pre["blocks"][0], pre["enc_blocks"][0]
    assert blk["cross"]["wk"].dtype == enc["attn"]["wq"].dtype == torch.int8
    assert blk["cross"]["bk"].dtype == enc["attn"]["bq"].dtype \
        == torch.float32
    want = _forward(tp, tcfg, ctx)
    assert torch.equal(_forward(pre, tcfg, ctx), want)
    default = tqmodel.quantize_weight_tree(tp, ctx)
    assert all(torch.equal(a, b) for a, b in zip(
        _leaves(default), _leaves(pre)))

    def as_attn(path, leaf):
        name = name_fn(path, leaf)
        return name.replace("cross/", "attn/") if name else name

    bad = tqmodel.quantize_weight_tree(tp, ctx, name_fn=as_attn)
    assert not torch.equal(_forward(bad, tcfg, ctx), want)


def _leaves(tree):
    out = []
    tqmodel._map_leaves(tree, lambda path, leaf: out.append(leaf))
    return out


def test_engines_refuse_audio():
    _, tcfg = cfgs()
    for fn, args in ((TM.init_paged_cache, (tcfg, 4, 16)),
                     (TM.init_paged_state, (tcfg, 4))):
        with pytest.raises(NotImplementedError, match="classic path"):
            fn(*args, device="cpu")
    for fn in (TM.ragged_step, TM.paged_step):
        with pytest.raises(NotImplementedError, match="classic path"):
            fn({}, None, None, None, None, tcfg, None)
