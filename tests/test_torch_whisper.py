"""Differential tests of the audio family (whisper_large_v3) against the
JAX package, module by module, on the fp32 smoke config with the JAX
weights carried over by ``from_jax_params`` (every attention bias drawn
from a numpy seed: the reference initialises them to zero, which would
leave the biased products untested):

* K5's non-causal plain version (``ops.flash_attention(causal=False)`` on
  CPU tensors) against the reference's ``chunked_attention(causal=False)``
  with Sq != Skv, fp32 q within 1e-5 and bf16 q within 2e-2, over float
  and int8 K/V, one and two query heads per KV head; and against the JAX
  ``ops.flash_attention(causal=False)`` (the Pallas body interpreted) at
  a shape that launches it, within 1e-5;
* gelu against ``jax.nn.gelu`` (fp32 within 1e-6 absolute; the recorded
  delta in ROADMAP Queue 3) and the encoder's sinusoid table against the
  reference's (fp32 angles identical, entries within one fp32 ulp);
* the stream's tokens and ``encoder_features`` identical to the
  reference's;
* ``gqa_attention`` with ``kv_x`` (cross-attention, one query and
  several) and with ``causal=False``, ``encoder_block`` and
  ``decoder_block`` on identical inputs: FP within 1e-5, INT identical;
* ``init_cache`` (layout and dtypes), ``forward`` / ``prefill`` /
  ``decode_step`` in FP (logits within 1e-5) and INT (identical, with the
  reference's attention patched into the port's plain versions: see
  ``reference_attention``), the cache written in the tensors prefill
  allocated;
* ``qlinear_weight`` on every leaf.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.core.qmodel import QuantContext as JCtx  # noqa: E402
from repro.core.qmodel import QuantMode as JMode  # noqa: E402
from repro.core.qscheme import quant as jquant  # noqa: E402
from repro.data import SyntheticLMStream as JStream  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import attention as jatt  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.core import qmodel as tqmodel  # noqa: E402
from repro_torch.core.qmodel import QuantContext as TCtx  # noqa: E402
from repro_torch.core.qmodel import QuantMode as TMode  # noqa: E402
from repro_torch.data import SyntheticLMStream as TStream  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import attention as tatt  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.common import rope_tables  # noqa: E402
from tests.test_torch_recurrent_blocks import tcfg_of  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

ARCH = "whisper_large_v3"
TOL = dict(atol=1e-5, rtol=1e-5)
EXACT = dict(atol=0, rtol=0)
NKV = 4


def cfgs(**kw):
    jcfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32", **kw)
    return jcfg, tcfg_of(jcfg)


def _with_biases(tree, rng):
    """Every attention bias leaf (``bq`` / ``bk`` / ``bv``) drawn from
    ``rng`` (scale 0.1), the rest as given."""
    if isinstance(tree, dict):
        return {k: (rng.standard_normal(v.shape).astype(v.dtype) * 0.1
                    if k in ("bq", "bk", "bv") else _with_biases(v, rng))
                for k, v in tree.items()}
    return tree


@functools.lru_cache(maxsize=None)
def weights():
    """The JAX smoke weights, fp32, biases drawn from a seed: (jax tree,
    numpy tree).  Both packages take these numbers, so the init runs
    compiled (one compile, not one per primitive)."""
    jcfg, _ = cfgs()
    npt = _with_biases(jax.tree.map(np.asarray, jax.jit(
        JM.init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(0))),
        np.random.default_rng(3))
    return jax.tree.map(jnp.asarray, npt), npt


def tparams(tcfg):
    return TM.from_jax_params(weights()[1], tcfg, device="cpu")


def t_(a):
    return torch.from_numpy(np.array(a, copy=True))


def close(got, want, what, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), err_msg=what,
                               **(tol or TOL))


def layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def ctxs(mode, seed=0):
    """A JAX and a port context of ``mode`` over one table: the INT grids
    drawn from ``seed`` for every module of the arch (the biases on
    their own grid)."""
    from repro.core.qmodel import ModuleBits as JBits
    from repro_torch.core.qmodel import ModuleBits as TBits
    rng = np.random.default_rng(seed)
    names = ["attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/w1", "mlp/w2",
             "cross/wq", "cross/wk", "cross/wv", "cross/wo", "lm_head"]
    table = {n: tuple(int(v) for v in (rng.integers(3, 6), rng.integers(6, 9),
                                       rng.integers(5, 9), rng.integers(3, 6)))
             for n in names}
    return (JCtx(mode=JMode(mode), table={n: JBits(*v)
                                          for n, v in table.items()}),
            TCtx(mode=TMode(mode), table={n: TBits(*v)
                                          for n, v in table.items()}))


# ---------------------------------------------------------------------------
# K5's non-causal form
# ---------------------------------------------------------------------------

def _qkv(seed, b, sq, skv, h, kvh, d, int8_kv, dtype):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, kvh, d)).astype(np.float32)
    if int8_kv:
        k = np.asarray(jquant(jnp.asarray(k), NKV, 8))
        v = np.asarray(jquant(jnp.asarray(v), NKV, 8))
    jq = jnp.asarray(q).astype(dtype)
    return jq, jnp.asarray(k), jnp.asarray(v)


@functools.partial(jax.jit, static_argnames=("nkv",))
def _jax_chunked(q, k, v, nkv):
    from repro.core.qscheme import dequant
    if k.dtype == jnp.int8:
        k = dequant(k, nkv, out_dtype=q.dtype)
        v = dequant(v, nkv, out_dtype=q.dtype)
    g = q.shape[2] // k.shape[2]
    return jatt.chunked_attention(q, jatt._repeat_kv(k, g).astype(q.dtype),
                                  jatt._repeat_kv(v, g).astype(q.dtype),
                                  causal=False)


def _port(a):
    a = np.asarray(a.astype(jnp.float32)) if a.dtype == jnp.bfloat16 \
        else np.asarray(a)
    return t_(a)


# (Sq, Skv, H, KVH, q type, int8 K/V): Sq below and above Skv, GQA 2, one
# row, each q type over float and int8 K/V
K5_CASES = [(5, 37, 4, 4, "float32", False), (5, 37, 4, 4, "bfloat16", True),
            (32, 64, 4, 2, "float32", True), (32, 64, 4, 2, "bfloat16", False),
            (1, 1, 2, 2, "float32", False), (40, 7, 4, 4, "bfloat16", True),
            (40, 7, 4, 4, "float32", True)]


@pytest.mark.parametrize("sq,skv,h,kvh,dtype,int8_kv", K5_CASES)
def test_noncausal_plain_k5_matches_chunked(sq, skv, h, kvh, dtype, int8_kv):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    q, k, v = _qkv(sq * skv + h, 2, sq, skv, h, kvh, 16, int8_kv, jdt)
    nkv = NKV if int8_kv else None
    want = _jax_chunked(q, k, v, nkv)
    tq = _port(q).to(getattr(torch, dtype))
    got = tops.flash_attention(tq, _port(k), _port(v), kv_frac_bits=nkv,
                               causal=False)
    assert got.dtype == tq.dtype and got.shape == (2, sq, h, 16)
    tol = TOL if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    close(got, np.asarray(want.astype(jnp.float32)), "non-causal K5", **tol)
    # the causal form differs wherever a query sees fewer rows
    if skv > 1:
        causal = tops.flash_attention(tq, _port(k), _port(v),
                                      kv_frac_bits=nkv)
        assert not torch.equal(causal, got)
    assert not any(tops.LAUNCHES.values())


@pytest.mark.parametrize("int8_kv", [False, True])
def test_noncausal_plain_k5_matches_interpreted_pallas(int8_kv):
    """At a shape the JAX wrapper launches its kernel for (Sq >= 16, Skv
    >= 128): the Pallas body interpreted, ``causal=False``."""
    q, k, v = _qkv(11, 1, 24, 150, 4, 2, 16, int8_kv, jnp.float32)
    nkv = NKV if int8_kv else None
    want = jops.flash_attention(q, k, v, causal=False, kv_frac_bits=nkv)
    got = tops.flash_attention(_port(q), _port(k), _port(v),
                               kv_frac_bits=nkv, causal=False)
    close(got, want, "non-causal K5 vs Pallas")


# ---------------------------------------------------------------------------
# gelu, the sinusoid, the stream
# ---------------------------------------------------------------------------

def test_gelu_matches_jax():
    """The port's float64 round-once gelu against ``jax.nn.gelu`` (its tanh
    approximation) in fp32: within 1e-6 absolute.  XLA's fp32 gelu is off
    by up to 5.5e-7 near 0 and flushes ``0.5 x (1 + tanh(..))`` to 0 below
    about x = -5.5, where the port keeps values near 1e-9; so neither a
    relative bound nor a bound in ulps holds."""
    x = (np.random.default_rng(4).standard_normal(1 << 16) * 3).astype(
        np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = tmlp._act(t_(x), "gelu")
    assert got.dtype == torch.float32
    close(got, want, "gelu", atol=1e-6, rtol=0)


def test_sinusoid_matches_jax():
    """At smoke width (64 frames of 64) the fp32 angles are the
    reference's and the table is within one fp32 ulp of 1 (34 of 4096
    entries differ, XLA's sin / cos against float64's rounded once); at
    full width (1500 x 1280) torch's fp32 ``pow`` differs from XLA's in
    the last bit for some frequencies, and the table moves by up to 3.1e-5
    (the angle's ulp at position 1499), in bf16 by one bf16 ulp in 31 of
    1.92 M entries (ROADMAP Queue 3)."""
    want = np.asarray(JM._sinusoid(64, 64, jnp.float32))
    got = TM._sinusoid(64, 64, torch.float32, torch.device("cpu"))
    assert got.shape == (1, 64, 64) and got.dtype == torch.float32
    close(got, want, "sinusoid", atol=6e-8, rtol=0)
    want = np.asarray(JM._sinusoid(1500, 1280, jnp.float32))
    got = TM._sinusoid(1500, 1280, torch.float32, torch.device("cpu"))
    close(got, want, "sinusoid at full width", atol=3.1e-5, rtol=0)
    want = np.asarray(JM._sinusoid(1500, 1280, jnp.bfloat16).astype(
        jnp.float32))
    got = TM._sinusoid(1500, 1280, torch.bfloat16,
                       torch.device("cpu")).float().numpy()
    assert np.abs(got - want).max() <= 2.0 ** -8
    assert (got != want).sum() <= 31


def test_stream_matches_jax():
    js = JStream(256, 12, 3, seed=5, encoder_seq=20, d_model=8).batch(2)
    ts = TStream(256, 12, 3, seed=5, encoder_seq=20, d_model=8).batch(2)
    assert set(ts) == set(js) == {"tokens", "labels", "mask",
                                  "encoder_features"}
    for key in ("tokens", "labels", "mask"):
        assert ts[key].dtype == js[key].dtype
        assert np.array_equal(ts[key], js[key])
    assert ts["encoder_features"].dtype == np.float32
    assert np.array_equal(ts["encoder_features"], js["encoder_features"])
    # the features are drawn after the tokens: the tokens do not move
    assert np.array_equal(TStream(256, 12, 3, seed=5).batch(2)["tokens"],
                          js["tokens"])


# ---------------------------------------------------------------------------
# attention and blocks
# ---------------------------------------------------------------------------

MODES = ["fp", "int"]


def _tol(mode):
    return TOL if mode == "fp" else EXACT


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# one kernel setting: at smoke size both packages' attention here is the
# plain one under either (the reference falls back to chunked_attention
# below 16 queries or 128 kv rows)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("s", [1, 6])
def test_cross_attention_matches_jax(mode, s):
    """``gqa_attention(kv_x=memory)``: wq on x, wk / wv on the memory; one
    query (a decode step: K6 at the memory's last row) or several (K5's
    non-causal form)."""
    jcfg, tcfg = cfgs(attn_kernel="flash")
    jp = layer(weights()[0]["blocks"], 0)["cross"]
    tp = tparams(tcfg)["blocks"][0]["cross"]
    jctx, tctx = ctxs(mode)
    x, mem = _x(1, 2, s, jcfg.d_model), _x(2, 2, 64, jcfg.d_model)
    jo, _ = jax.jit(lambda p, x, m: jatt.gqa_attention(
        jctx, p, x, jcfg, positions=jnp.arange(s)[None], kv_x=m,
        use_rope=False, name="cross"))(jp, jnp.asarray(x), jnp.asarray(mem))
    with torch.no_grad():
        to, _ = tatt.gqa_attention(tctx, tp, t_(x), tcfg, rope=None,
                                   kv_x=t_(mem), name="cross")
    close(to, jo, f"cross {mode}", **_tol(mode))


@pytest.mark.parametrize("mode", MODES)
def test_noncausal_attention_matches_jax(mode):
    jcfg, tcfg = cfgs(attn_kernel="flash")
    jp = layer(weights()[0]["enc_blocks"], 1)["attn"]
    tp = tparams(tcfg)["enc_blocks"][1]["attn"]
    jctx, tctx = ctxs(mode, seed=1)
    x = _x(3, 2, 40, jcfg.d_model)
    jo, _ = jax.jit(lambda p, x: jatt.gqa_attention(
        jctx, p, x, jcfg, positions=jnp.arange(40)[None], causal=False,
        use_rope=False))(jp, jnp.asarray(x))
    with torch.no_grad():
        to, _ = tatt.gqa_attention(tctx, tp, t_(x), tcfg, rope=None,
                                   causal=False)
    close(to, jo, f"non-causal {mode}", **_tol(mode))


@pytest.mark.parametrize("mode", MODES)
def test_encoder_block_matches_jax(mode):
    jcfg, tcfg = cfgs(attn_kernel="flash")
    jp = layer(weights()[0]["enc_blocks"], 0)
    tp = tparams(tcfg)["enc_blocks"][0]
    jctx, tctx = ctxs(mode, seed=2)
    x = _x(4, 2, 64, jcfg.d_model)
    jo = jax.jit(lambda p, x: jtfm.encoder_block(jctx, p, x, jcfg))(
        jp, jnp.asarray(x))
    with torch.no_grad():
        to = ttfm.encoder_block(tctx, tp, t_(x), tcfg)
    close(to, jo, f"encoder_block {mode}", **_tol(mode))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("cached", [False, True])
def test_decoder_block_matches_jax(mode, cached):
    """Without a cache over 7 tokens; with one, a 5-token prefill into a
    7-position cache, then a decode step at position 5."""
    jcfg, tcfg = cfgs(attn_kernel="flash")
    jp = layer(weights()[0]["blocks"], 1)
    tp = tparams(tcfg)["blocks"][1]
    jctx, tctx = ctxs(mode, seed=3)
    x, mem = _x(5, 2, 7, jcfg.d_model), _x(6, 2, 64, jcfg.d_model)
    hd, kvh = tcfg.resolved_head_dim, tcfg.n_kv_heads

    def jrun(p, x, m, c, pos, start):
        positions = jnp.arange(x.shape[1])[None] + start
        return jtfm.decoder_block(jctx, p, x, m, jcfg, positions=positions,
                                  cache=c, cache_pos=pos)

    def trun(x, c, pos, start):
        positions = torch.arange(x.shape[1])[None] + start
        rope = rope_tables(positions, hd, tcfg.rope_theta, torch.float32)
        with torch.no_grad():
            return ttfm.decoder_block(tctx, tp, x, t_(mem), tcfg, rope=rope,
                                      cache=c, cache_pos=pos)

    if not cached:
        jo, _ = jax.jit(lambda p, x, m: jrun(p, x, m, None, None, 0))(
            jp, jnp.asarray(x), jnp.asarray(mem))
        to, _ = trun(t_(x), None, None, 0)
        close(to, jo, f"decoder_block {mode}", **_tol(mode))
        return
    jc = jatt.KVCache(jnp.zeros((2, 7, kvh, hd)), jnp.zeros((2, 7, kvh, hd)))
    tc = tatt.KVCache(torch.zeros((2, 7, kvh, hd)),
                      torch.zeros((2, 7, kvh, hd)))
    jo, jc = jax.jit(lambda p, x, m, c: jrun(p, x, m, c, 0, 0))(
        jp, jnp.asarray(x[:, :5]), jnp.asarray(mem), jc)
    to, tc = trun(t_(x[:, :5]), tc, 0, 0)
    close(to, jo, f"decoder_block prefill {mode}", **_tol(mode))
    jo, jc = jax.jit(lambda p, x, m, c, pos: jrun(p, x, m, c, pos, pos))(
        jp, jnp.asarray(x[:, 5:6]), jnp.asarray(mem), jc,
        jnp.asarray(5, jnp.int32))
    to, tc = trun(t_(x[:, 5:6]), tc, torch.tensor(5, dtype=torch.int32), 5)
    close(to, jo, f"decoder_block decode {mode}", **_tol(mode))
    close(tc.k, jc.k, "cache k", **TOL)
    close(tc.v, jc.v, "cache v", **TOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("causal", "nkv"))
def _jax_attention(q, k, v, q_offset, causal, nkv):
    from repro.kernels.ops import _dequant_then_repeat
    kr, vr = _dequant_then_repeat(q, k, v, nkv)
    return jatt.chunked_attention(q, kr, vr, causal=causal,
                                  q_offset=q_offset)


def _xla_flash_attention(q, k, v, *, kv_frac_bits=None, causal=True):
    return t_(_jax_attention(*(jnp.asarray(a.numpy()) for a in (q, k, v)),
                             jnp.int32(0), causal, kv_frac_bits or 0))


def _xla_flash_decode(q, k, v, *, pos, kv_frac_bits=None):
    return t_(_jax_attention(*(jnp.asarray(a.numpy()) for a in (q, k, v)),
                             jnp.int32(int(pos)), True, kv_frac_bits or 0))


def reference_attention(monkeypatch):
    """The reference's attention patched into the port's plain K5 / K6
    versions: ``chunked_attention`` as the JAX package runs it at smoke
    size under ``attn_kernel='flash'`` (its wrappers fall back to it below
    128 kv rows and for head dims off 128; the cross decode's one query
    over all S_enc rows is its causal form at q_offset S_enc - 1).  The
    port's plain attention sums in another fp32 order: on the same
    inputs its outputs differ in the last bit (within 1e-5 in FP), and in
    INT a last bit that crosses a rounding boundary moves an Eq.-1 code
    of wo's input; through whisper's encoder such flips reach every row of
    the memory (2225 of 6144 INT logits move, by up to 0.31, on this
    forward).  Each module's integer arithmetic is held to the reference's
    on identical inputs by the block tests above, unpatched; with this
    patch the whole INT forward is identical (ROADMAP Queue 3)."""
    monkeypatch.setattr(tref, "flash_attention_ref", _xla_flash_attention)
    monkeypatch.setattr(tref, "flash_decode_ref", _xla_flash_decode)

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_matches_jax(dtype):
    jcfg = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)
    tc = TM.init_cache(tcfg_of(jcfg), 3, 10, device="cpu")
    jc = JM.init_cache(jcfg, 3, 10)
    assert set(tc) == set(jc) == {"kv", "memory"}
    for name in ("k", "v"):
        t, a = getattr(tc["kv"], name), getattr(jc["kv"], name)
        assert tuple(t.shape) == a.shape and not t.any()
        assert str(t.dtype).split(".")[-1] == str(a.dtype)
    assert tuple(tc["memory"].shape) == jc["memory"].shape == (3, 64, 64)
    assert str(tc["memory"].dtype).split(".")[-1] == str(jc["memory"].dtype)
    assert int(tatt.last_row(64, torch.device("cpu"))) == 63


def _batch(seed, b, s, jcfg):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, jcfg.vocab_size, size=(b, s)).astype(np.int32),
            rng.standard_normal((b, jcfg.encdec.encoder_seq, jcfg.d_model)
                                ).astype(np.float32))


# INT runs once, under 'flash': with the reference's attention patched in,
# both kernels' plain versions are that one function
@pytest.mark.parametrize("mode,attn_kernel", [("fp", "chunked"),
                                              ("fp", "flash"),
                                              ("int", "flash")])
def test_forward_prefill_decode_match_jax(mode, attn_kernel, monkeypatch):
    """``forward`` of (2, 12) tokens, ``prefill`` of the first 8 into a
    12-position cache and 4 ``decode_step`` calls (the position a 0-d
    tensor), both packages: FP logits within 1e-5, INT identical with the
    reference's attention patched in (:func:`reference_attention`); the
    cache written in the tensors prefill allocated, K/V and the memory
    within 1e-5."""
    if mode == "int":
        reference_attention(monkeypatch)
    jcfg, tcfg = cfgs(attn_kernel=attn_kernel)
    jp = weights()[0]
    tp = tparams(tcfg)
    jctx, tctx = ctxs(mode, seed=4)
    if mode == "int":
        tp = tqmodel.quantize_weight_tree(
            tp, tctx, name_fn=functools.partial(TM.qlinear_weight, cfg=tcfg))
    toks, feats = _batch(7, 2, 12, jcfg)
    jf = jnp.asarray(feats)

    def jb(t):
        return {"tokens": jnp.asarray(t), "encoder_features": jf}

    def tb(t):
        return {"tokens": t_(t), "encoder_features": t_(feats)}

    jl, _ = jax.jit(lambda p, b: JM.forward(p, b, jcfg, jctx))(jp, jb(toks))
    with torch.no_grad():
        tl, _ = TM.forward(tp, tb(toks), tcfg, tctx)
    close(tl, jl, "forward", **_tol(mode))
    jl, jc = jax.jit(lambda p, b: JM.prefill(p, b, jcfg, jctx, max_seq=12))(
        jp, jb(toks[:, :8]))
    jdec = jax.jit(lambda p, t, c, pos: JM.decode_step(p, t, c, pos, jcfg,
                                                       jctx))
    with torch.no_grad():
        tl, tc = TM.prefill(tp, tb(toks[:, :8]), tcfg, tctx, max_seq=12)
        close(tl, jl, "prefill", **_tol(mode))
        static = [tc["kv"].k.data_ptr(), tc["kv"].v.data_ptr(),
                  tc["memory"].data_ptr()]
        for i in range(8, 12):
            jl, jc = jdec(jp, jnp.asarray(toks[:, i:i + 1]), jc,
                          jnp.asarray(i, jnp.int32))
            tl, tc = TM.decode_step(tp, t_(toks[:, i:i + 1]), tc,
                                    torch.tensor(i, dtype=torch.int32),
                                    tcfg, tctx)
            close(tl, jl, f"decode {i}", **_tol(mode))
    assert [tc["kv"].k.data_ptr(), tc["kv"].v.data_ptr(),
            tc["memory"].data_ptr()] == static
    close(tc["kv"].k, jc["kv"].k, "cache k")
    close(tc["kv"].v, jc["kv"].v, "cache v")
    # a float after ln_enc: the rms statistic's last bit (ROADMAP Queue 3)
    close(tc["memory"], jc["memory"], "memory")
    assert not any(tops.LAUNCHES.values())


WANT_NAMES = {"attn/wq": "attn/wq", "attn/wo": "attn/wo",
              "cross/wq": "cross/wq", "cross/wk": "cross/wk",
              "cross/wv": "cross/wv", "cross/wo": "cross/wo",
              "mlp/w1": "mlp/w1", "mlp/w2": "mlp/w2"}


def test_qlinear_weight_on_every_leaf():
    _, tcfg = cfgs()
    got = {}
    tqmodel._map_leaves(tparams(tcfg), lambda path, leaf: got.setdefault(
        path, TM.qlinear_weight(path, leaf, cfg=tcfg)))
    assert got["lm_head"] == "lm_head"
    n_seen = 0
    for path, name in got.items():
        parts = path.split("/")
        if parts[0] in ("blocks", "enc_blocks"):
            rest = "/".join(parts[2:])
            if rest in WANT_NAMES:
                assert name == WANT_NAMES[rest], path
                n_seen += 1
            else:
                # biases, norm gains, the encoder's and decoder's other
                # weights by the same rule
                leaf = parts[-1]
                assert name == (rest if leaf in ("wk", "wv") else None), path
        elif path != "lm_head":
            assert name is None, path      # embed, ln_f, ln_enc
    # 4 encoder names a layer, 8 decoder names a layer, 2 layers each
    assert n_seen == 2 * 4 + 2 * 8
    assert "enc_blocks/0/cross/wq" not in got
