"""Differential tests of the mixture-of-experts family against the JAX
package: the MoE layer of both smoke archs (granite_moe_3b_a800m: 8
experts top-2, GQA; deepseek_v3_671b: a shared expert, a leading dense
layer, MLA) and granite's classic path, on the JAX smoke weights carried
over by ``from_jax_params``, fp32 unless stated:

* ``moe_capacity`` equal to the reference's;
* the routing: ``top_e``, each pair's rank and ``keep`` identical to the
  reference's lines (``repro/models/mlp.py:141-156``), ``top_p`` within
  1e-6; and a capacity overflow (a router column scaled from the seed
  sends every token to one expert) drops exactly the reference's pairs,
  the layer's FP outputs within atol 1e-4 (they reach 12 there);
* ``_qexpert`` in FP and FAKE within 1e-5, INT and FAKE_SF (the integer
  branch in both packages) identical, on three grids and on int8
  weights; K2's grouped plain version against the reference's int8
  ``dot_general`` + ``shift_requant`` bit for bit, rows past each
  expert's count 0;
* ``moe`` and ``moe_block`` on identical inputs: FP within 1e-5; INT,
  FAKE and FAKE_SF within 2e-6 (the expert products are identical; the
  router's fp32 probabilities may differ in the last bit, the two
  packages summing their softmax in other orders); bf16 FP, the
  reference's bf16 silu patched in, within one bf16 ulp of 1 + |y| (the
  combine's bf16 terms summed over k in fp32 and rounded once);
* granite's ``init_cache`` (layout and dtypes), ``forward`` / ``prefill``
  / ``decode_step`` in FP (logits within 1e-5) and INT (identical),
  calibration tables identical (no expert captured), classic ``serve``
  token-identical to the JAX prefill + decode loop in FP and calibrated
  INT, and through the stand-in graph token-identical to eager;
* ``qlinear_weight`` on every leaf of both trees (the router and MLA's
  ``wkv_b`` stay float, ``attn/wq_a`` -> ``mla/wq_a``), and a calibrated
  INT forward over the pre-quantized tree equal to the on-the-fly one bit
  for bit, where the default rule (``name_fn=None``) breaks it.

The JAX calibration of granite is held by the module-scoped ``calibrated``
fixture (the JAX ``serve`` calibrates on the same 4 x 32 batch).
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
from repro.core.qmodel import ModuleBits as JBits  # noqa: E402
from repro.core.qmodel import QuantContext as JCtx  # noqa: E402
from repro.core.qmodel import QuantMode as JMode  # noqa: E402
from repro.core.qscheme import quant as jquant  # noqa: E402
from repro.core.qscheme import shift_requant as jshift_requant  # noqa: E402
from repro.data import SyntheticLMStream  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.configs import get_config as tconfig  # noqa: E402
from repro_torch.core import qmodel as tqmodel  # noqa: E402
from repro_torch.core.lm_calibrate import calibrate_lm  # noqa: E402
from repro_torch.core.qmodel import ModuleBits  # noqa: E402
from repro_torch.core.qmodel import QuantContext as TCtx  # noqa: E402
from repro_torch.core.qmodel import QuantMode as TMode  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.common import rope_tables  # noqa: E402
from tests.test_torch_recurrent_blocks import tcfg_of  # noqa: E402
from tests.test_torch_step_capture import StubGraph  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

ARCHS = ["granite_moe_3b_a800m", "deepseek_v3_671b"]
GRANITE = "granite_moe_3b_a800m"
TOL = dict(atol=1e-5, rtol=1e-5)
# INT / FAKE / FAKE_SF layer outputs: one or two fp32 ulps of the combine
INT_TOL = dict(atol=2e-6, rtol=2e-6)
PROMPT, BATCH, GEN = 32, 4, 8
MODES = ["fp", "fake", "int", "fake_sf"]


def cfgs(arch, **kw):
    jcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw)
    return jcfg, tcfg_of(jcfg)


@functools.lru_cache(maxsize=None)
def weights(arch, dtype="float32"):
    jcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jp, jax.tree.map(np.asarray, jp)


def tparams(arch, tcfg):
    return TM.from_jax_params(weights(arch, tcfg.dtype)[1], tcfg,
                              device="cpu")


def t_(a):
    return torch.from_numpy(np.array(a, copy=True))


def close(got, want, what, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), err_msg=what,
                               **(tol or TOL))


def layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def calib_tokens():
    """The calibration batch of the JAX ``serve`` (4 x 32, seed 0)."""
    return SyntheticLMStream(256, PROMPT, BATCH, seed=0).batch(0)["tokens"]


def table(ctx):
    return {k: dataclasses.astuple(v) for k, v in ctx.table.items()}


def port_ctx(jctx, mode):
    return TCtx(mode=TMode(mode), table={
        k: ModuleBits(**dataclasses.asdict(v)) for k, v in jctx.table.items()})


def jax_steps(jcfg, jctx, max_seq):
    """The JAX package's ``forward``, ``prefill`` and ``decode_step``,
    each compiled."""
    return (jax.jit(lambda p, t: JM.forward(p, {"tokens": t}, jcfg, jctx)),
            jax.jit(lambda p, t: JM.prefill(p, {"tokens": t}, jcfg, jctx,
                                            max_seq=max_seq)),
            jax.jit(lambda p, t, c, pos: JM.decode_step(p, t, c, pos, jcfg,
                                                        jctx)))


def jax_loop(jcfg, jp, jctx, prompt, gen):
    """The JAX package's prefill + greedy decode loop, batched."""
    _, prefill, decode = jax_steps(jcfg, jctx, prompt.shape[1] + gen)
    logits, cache = prefill(jp, jnp.asarray(prompt))
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    out = [np.asarray(tok)]
    for i in range(gen - 1):
        logits, cache = decode(jp, tok, cache,
                               jnp.asarray(prompt.shape[1] + i, jnp.int32))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        out.append(np.asarray(tok))
    return np.concatenate(out, axis=1)


def named(tree):
    return {jax.tree_util.keystr(p): a
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def tnamed(cache):
    return {f"['{k}'].{f}": t for k, part in cache.items()
            for f, t in zip(part._fields, part)}


def same_layout(tcache, jcache, values=False):
    jn, tn = named(jcache), tnamed(tcache)
    assert sorted(jn) == sorted(tn)
    for name, a in jn.items():
        t = tn[name]
        assert tuple(t.shape) == a.shape, name
        assert str(t.dtype).split(".")[-1] == str(a.dtype), name
        if values:
            assert not t.any(), name


def forward_prefill_decode(arch, jcfg, tcfg, mode, tp=None):
    """``forward`` of (2, 14) tokens, ``prefill`` of the first 10 into a
    14-position cache and 4 ``decode_step`` calls, both packages: FP
    logits within 1e-5, INT identical, and the cache written in the
    tensors prefill allocated, int8 codes identical in INT, float entries
    within 1e-5."""
    jp, _ = weights(arch)
    tp = tparams(arch, tcfg) if tp is None else tp
    jctx, tctx = JCtx(mode=JMode(mode)), TCtx(mode=TMode(mode))
    if mode == "int":
        tp = tqmodel.quantize_weight_tree(
            tp, tctx, name_fn=functools.partial(TM.qlinear_weight, cfg=tcfg))
    tol = TOL if mode == "fp" else dict(atol=0, rtol=0)
    toks = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, size=(2, 14)).astype(np.int32)
    jfwd, jpre, jdec = jax_steps(jcfg, jctx, 14)
    jl, _ = jfwd(jp, jnp.asarray(toks))
    with torch.no_grad():
        tl, _ = TM.forward(tp, {"tokens": t_(toks)}, tcfg, tctx)
    close(tl, jl, "forward", **tol)
    jl, jc = jpre(jp, jnp.asarray(toks[:, :10]))
    with torch.no_grad():
        tl, tc = TM.prefill(tp, {"tokens": t_(toks[:, :10])}, tcfg, tctx,
                            max_seq=14)
        static = {k: t.data_ptr() for k, t in tnamed(tc).items()}
        close(tl, jl, "prefill", **tol)
        for i in range(10, 14):
            jl, jc = jdec(jp, jnp.asarray(toks[:, i:i + 1]), jc,
                          jnp.asarray(i, jnp.int32))
            tl, tc = TM.decode_step(tp, t_(toks[:, i:i + 1]), tc,
                                    torch.tensor(i, dtype=torch.int32),
                                    tcfg, tctx)
            close(tl, jl, f"decode {i}", **tol)
    assert {k: t.data_ptr() for k, t in tnamed(tc).items()} == static
    jn = named(jc)
    for name, t in tnamed(tc).items():
        # float K/V and latents after rope: within 1e-5 in both modes (the
        # rope tables' cos / sin round in other places)
        close(t, jn[name], name, **(tol if t.dtype == torch.int8 else TOL))


def calibrate_both(arch, jcfg, tcfg):
    """(JAX context, report, port context, report) on the serve batch."""
    jp, _ = weights(arch)
    tokens = calib_tokens()
    jctx, jrep = jcalibrate(lambda p, b, c: JM.forward(p, b, jcfg, c), jp,
                            {"tokens": jnp.asarray(tokens)})
    tctx, trep = calibrate_lm(lambda p, b, c: TM.forward(p, b, tcfg, c),
                              tparams(arch, tcfg), {"tokens": t_(tokens)})
    return jctx, jrep, tctx, trep


def serve_kw(kv_bits=None):
    return dict(gen=GEN, batch=BATCH, prompt_len=PROMPT,
                cfg_overrides={"dtype": "float32", "kv_cache_bits": kv_bits})


def serve_against_jax_loop(arch, jcfg, tcfg, mode, jctx_cal, kv_bits=None):
    jctx = JCtx() if mode == "fp" else dataclasses.replace(jctx_cal,
                                                          mode=JMode.INT)
    want = jax_loop(jcfg, weights(arch)[0], jctx, calib_tokens(), GEN)
    o = tserve.serve(arch, mode=mode, params=tparams(arch, tcfg),
                     device="cpu", **serve_kw(kv_bits))
    assert np.array_equal(o["tokens"], want)
    if mode == "int":
        assert table(o["ctx"]) == table(jctx_cal)


def serve_through_stand_in_graph(arch, tcfg, kv_bits=None):
    """Classic ``serve`` (INT, uncalibrated) through the stand-in graph:
    the decode key captured once and replayed, tokens equal to eager
    (the step rewrites the same K/V at the same position, so rerunning
    it in the stand-in's capture changes nothing)."""
    kw = dict(mode="int", calibrate=False, params=tparams(arch, tcfg),
              device="cpu", **serve_kw(kv_bits))
    eager = tserve.serve(arch, graphs=False, **kw)
    o = tserve.serve(arch, graphs=True, _graph_factory=StubGraph, **kw)
    assert np.array_equal(o["tokens"], eager["tokens"])
    assert o["graphs"] == dict(enabled=True, first_calls=1, captures=1,
                               replays=GEN - 2)
    assert not any(tops.LAUNCHES.values())


def prequantized_equals_on_the_fly(arch, tcfg, jctx_cal, toks):
    """A calibrated INT forward over ``quantize_weight_tree(name_fn=
    qlinear_weight)`` equals the forward over float weights bit for bit;
    the default rule (``name_fn=None``: every 2-D+ leaf, the router and
    MLA's ``wkv_b`` too, on its longest table suffix) does not."""
    ctx = port_ctx(jctx_cal, "int")
    tp = tparams(arch, tcfg)
    pre = tqmodel.quantize_weight_tree(
        tp, ctx, name_fn=functools.partial(TM.qlinear_weight, cfg=tcfg))
    blk = pre["blocks"][0]
    assert blk["moe"]["router"].dtype == torch.float32
    assert blk["moe"]["w1"].dtype == torch.int8
    if tcfg.mla is not None:
        assert blk["attn"]["wkv_b"].dtype == torch.float32
        assert blk["attn"]["wq_a"].dtype == torch.int8
    with torch.no_grad():
        want, _ = TM.forward(tp, toks, tcfg, ctx)
        got, _ = TM.forward(pre, toks, tcfg, ctx)
        assert torch.equal(got, want)
        default = tqmodel.quantize_weight_tree(tp, ctx)
        assert default["blocks"][0]["moe"]["router"].dtype == torch.int8
        bad, _ = TM.forward(default, toks, tcfg, ctx)
    assert not torch.equal(bad, want)


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def test_configs_registered():
    for arch in ARCHS:
        assert arch in ARCH_IDS
        jcfg = get_smoke_config(arch)
        assert tcfg_of(jcfg) == tcfg_of(jcfg)       # hashable, frozen
        full = tconfig(arch)
        assert full.family == "moe"
    g, d = tconfig(GRANITE), tconfig("deepseek_v3_671b")
    assert (g.moe.n_experts, g.moe.e_padded, g.moe.top_k) == (40, 48, 8)
    assert (d.moe.e_padded, d.moe.n_shared, d.moe.n_dense_layers) \
        == (256, 1, 3)
    assert d.mla.kv_lora_rank == 512 and g.mla is None


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_capacity_matches_jax(arch):
    jm = get_smoke_config(arch).moe
    tm = tcfg_of(get_smoke_config(arch)).moe
    for full in (False, True):
        if full:
            from repro.configs import get_config as jget
            jm, tm = jget(arch).moe, tconfig(arch).moe
        for t in (1, 4, 17, 128, 511, 4096, 131072):
            assert tmlp.moe_capacity(t, tm) == jmlp.moe_capacity(t, jm), t


@functools.partial(jax.jit, static_argnums=(2, 3))
def jax_routing(xt, router, m, cap):
    """The reference's routing and ranking lines (``repro/models/mlp.py``
    :141-156, one data shard)."""
    logits = xt.astype(jnp.float32) @ router
    probs = jax.nn.softmax(logits, axis=-1)
    top_p, top_e = jax.lax.top_k(probs, m.top_k)
    top_p = top_p / jnp.sum(top_p, axis=-1, keepdims=True)
    flat_e = top_e.reshape(1, -1)
    one_hot = jax.nn.one_hot(flat_e, m.e_padded, dtype=jnp.int32)
    rank = jnp.sum(jnp.cumsum(one_hot, axis=1) * one_hot, axis=-1) - 1
    return top_p, top_e, rank[0], rank[0] < cap


def routing_case(arch, x, router):
    jcfg, tcfg = cfgs(arch)
    t = x.shape[0]
    cap = jmlp.moe_capacity(t, jcfg.moe)
    jp_, je, jr, jk = jax_routing(jnp.asarray(x), jnp.asarray(router),
                                  jcfg.moe, cap)
    jp_, je, jr, jk = (np.asarray(a) for a in (jp_, je, jr, jk))
    tp_, te = tmlp.route(t_(x), t_(router), tcfg.moe.top_k)
    assert np.array_equal(te.numpy(), je)
    close(tp_, jp_, "top_p", atol=1e-6, rtol=1e-6)
    rank, keep, counts = tmlp.rank_pairs(te.reshape(-1), tcfg.moe.e_padded,
                                         cap)
    assert np.array_equal(rank.numpy(), jr)
    assert np.array_equal(keep.numpy(), jk)
    want_counts = np.minimum(np.bincount(je.reshape(-1),
                                         minlength=tcfg.moe.e_padded), cap)
    assert np.array_equal(counts.numpy(), want_counts)
    return jk


@pytest.mark.parametrize("arch", ARCHS)
def test_routing_matches_jax(arch):
    jp, _ = weights(arch)
    router = np.asarray(layer(jp["blocks"], 0)["moe"]["router"])
    x = np.random.default_rng(11).standard_normal(
        (200, router.shape[0])).astype(np.float32)
    keep = routing_case(arch, x, router)
    assert keep.all()
    # ties: equal probabilities take the lower expert first (lax.top_k)
    tied = np.zeros_like(router)
    keep = routing_case(arch, x[:8], tied)
    assert keep.all()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["fp", "int"])
def test_capacity_overflow_drops_the_reference_pairs(arch, mode):
    """Every token's top choice is expert ``j`` (its router column scaled
    from the seed): 256 tokens overflow j's 128 slots, and the pairs past
    them drop exactly as in the reference; the layer's outputs agree (FP
  within atol 1e-4: the offset inputs give outputs up to 12)."""
    jcfg, tcfg = cfgs(arch)
    jp, _ = weights(arch)
    rng = np.random.default_rng(12)
    p = jax.tree.map(np.asarray, layer(jp["blocks"], 0)["moe"])
    j = int(rng.integers(jcfg.moe.n_experts))
    p["router"] = p["router"].copy()
    p["router"][:, j] = np.abs(rng.standard_normal(jcfg.d_model)) * 0.5
    x = (rng.standard_normal((4, 64, jcfg.d_model)) + 1.0).astype(np.float32)
    keep = routing_case(arch, x.reshape(256, -1), p["router"])
    dropped = int((~keep).sum())
    assert dropped == 256 - jmlp.moe_capacity(256, jcfg.moe) > 0
    jo = jax.jit(lambda p, x: jmlp.moe(JCtx(mode=JMode(mode)), p, x, jcfg))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = jax.tree.map(t_, p)
    with torch.no_grad():
        to = tmlp.moe(TCtx(mode=TMode(mode)), tp, t_(x), tcfg)
    # its inputs are offset by 1, so its outputs reach 12: FP at atol 1e-4
    close(to, jo, "overflowing moe",
          **(dict(atol=1e-4, rtol=1e-5) if mode == "fp" else INT_TOL))


GRIDS = [None, ModuleBits(n_x=2, n_w=9, n_o=5),
         ModuleBits(n_x=0, n_w=1, n_o=6)]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("grid", range(len(GRIDS)))
def test_qexpert_matches_jax(arch, mode, grid):
    jcfg, _ = cfgs(arch)
    jp, _ = weights(arch)
    w = np.asarray(layer(jp["blocks"], 0)["moe"]["w1"])
    e = w.shape[0]
    rng = np.random.default_rng(13)
    a = (rng.standard_normal((e, 24, jcfg.d_model)) * 2).astype(np.float32)
    table = {} if GRIDS[grid] is None else {"moe/w1": GRIDS[grid]}
    jctx = JCtx(mode=JMode(mode), table={
        k: JBits(**dataclasses.asdict(v)) for k, v in table.items()})
    tctx = TCtx(mode=TMode(mode), table=table)
    want = jax.jit(lambda a, w: jmlp._qexpert(jctx, "moe/w1", a, w))(
        jnp.asarray(a), jnp.asarray(w))
    with torch.no_grad():
        got = tmlp._qexpert(tctx, "moe/w1", t_(a), t_(w))
    if mode in ("int", "fake_sf"):
        assert np.array_equal(got.numpy(), np.asarray(want))
        # int8 weight codes pass through untouched
        n_w = tctx.bits_for("moe/w1").n_w
        w_int = np.asarray(jquant(jnp.asarray(w), n_w, 8))
        got_c = tmlp._qexpert(tctx, "moe/w1", t_(a), t_(w_int))
        assert np.array_equal(got_c.numpy(), np.asarray(want))
    else:
        close(got, want, f"_qexpert {mode}")


@pytest.mark.parametrize("shift", [8, 3, -5])
def test_grouped_plain_matches_jax_dot_general(shift):
    """K2's grouped plain version against the reference's integer branch
    (``lax.dot_general`` int8 -> int32, ``shift_requant``), bit for bit;
    rows at or past an expert's count are 0; the wrapper on CPU tensors
    takes the plain version and launches nothing."""
    rng = np.random.default_rng(14)
    e, c, k, n = 6, 20, 48, 24
    x = rng.integers(-128, 128, (e, c, k), dtype=np.int8)
    w = rng.integers(-128, 128, (e, k, n), dtype=np.int8)
    dn = (((2,), (1,)), ((0,), (0,)))
    acc = jax.lax.dot_general(jnp.asarray(x), jnp.asarray(w), dn,
                              preferred_element_type=jnp.int32)
    want = np.asarray(jshift_requant(acc, shift, bits=8))
    counts = np.array([c, 0, 1, 7, c, 19], dtype=np.int32)
    for rows_cap in (c, 5):
        got = tref.int8_matmul_grouped_ref(t_(x), t_(w), t_(counts),
                                           rows_cap=rows_cap, shift=shift)
        for i in range(e):
            r = min(counts[i], rows_cap)
            assert np.array_equal(got[i, :r].numpy(), want[i, :r]), i
            assert not got[i, r:].any(), i
    from repro_torch.core.integer_ops import LinearQuantSpec
    tops.reset_launch_counts()
    spec = LinearQuantSpec(n_x=4, n_w=4 + shift, n_b=4 + shift, n_o=4 + 4)
    got = tops.int8_matmul_grouped(t_(x), t_(w), t_(counts), spec,
                                   out_float=torch.float32)
    full = np.asarray(jshift_requant(acc, spec.requant_shift, bits=8))
    live = np.arange(c)[None, :] < counts[:, None]
    assert np.array_equal(got.numpy(), np.where(live[..., None], full, 0)
                          .astype(np.float32) * 2.0 ** -spec.n_o)
    assert not any(tops.LAUNCHES.values())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", MODES)
def test_moe_and_moe_block_match_jax(arch, mode):
    jcfg, tcfg = cfgs(arch)
    jp, _ = weights(arch)
    tp = tparams(arch, tcfg)
    jpl = layer(jp["blocks"], 0)
    x = np.random.default_rng(15).standard_normal(
        (4, 16, jcfg.d_model)).astype(np.float32)
    jctx, tctx = JCtx(mode=JMode(mode)), TCtx(mode=TMode(mode))
    tol = TOL if mode == "fp" else INT_TOL
    jo = jax.jit(lambda p, x: jmlp.moe(jctx, p, x, jcfg))(jpl["moe"],
                                                         jnp.asarray(x))
    with torch.no_grad():
        to = tmlp.moe(tctx, tp["blocks"][0]["moe"], t_(x), tcfg)
    close(to, jo, "moe", **tol)
    pos = jnp.broadcast_to(jnp.arange(16)[None], (4, 16))
    jb, _ = jax.jit(lambda p, x: jtfm.moe_block(jctx, p, x, jcfg,
                                                positions=pos))(
        jpl, jnp.asarray(x))
    width = tcfg.mla.qk_rope_head_dim if tcfg.mla else \
        tcfg.resolved_head_dim
    rope = rope_tables(torch.arange(16).expand(4, 16), width,
                       tcfg.rope_theta, torch.float32)
    with torch.no_grad():
        tb, cache = ttfm.moe_block(tctx, tp["blocks"][0], t_(x), tcfg,
                                   rope=rope)
    assert cache is None
    close(tb, jb, "moe_block", **tol)


def _xla_silu(x):
    """The reference's bf16 ``jax.nn.silu`` (XLA rounds its steps to bf16
    one by one; the port's ``mlp._silu`` rounds once, from float64)."""
    y = jax.nn.silu(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
    return t_(np.asarray(y.astype(jnp.float32))).to(x.dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_bf16_combine(arch, monkeypatch):
    """bf16 FP with the reference's silu patched in: the combine's bf16
    terms summed over k in fp32 and rounded once give the reference's
    output within one bf16 ulp (2^-8 of (1 + |y|); identical at this
    seed)."""
    monkeypatch.setattr(tmlp, "_silu", _xla_silu)
    jcfg = get_smoke_config(arch)
    tcfg = tcfg_of(jcfg)
    jp, npt = weights(arch, "bfloat16")
    tp = TM.from_jax_params(npt, tcfg, device="cpu")
    x = jnp.asarray(np.random.default_rng(16).standard_normal(
        (4, 16, jcfg.d_model)), jnp.bfloat16)
    jo = jax.jit(lambda p, x: jmlp.moe(JCtx(), p, x, jcfg))(
        layer(jp["blocks"], 0)["moe"], x)
    with torch.no_grad():
        to = tmlp.moe(TCtx(), tp["blocks"][0]["moe"],
                      t_(np.asarray(x.astype(jnp.float32))).to(
                          torch.bfloat16), tcfg)
    assert to.dtype == torch.bfloat16
    want = np.asarray(jo.astype(jnp.float32))
    rel = np.abs(to.float().numpy() - want) / (1 + np.abs(want))
    assert rel.max() <= 2 ** -8, rel.max()


# ---------------------------------------------------------------------------
# granite's classic path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def calibrated():
    """granite's (JAX context, report, port context, report)."""
    jcfg, tcfg = cfgs(GRANITE)
    return calibrate_both(GRANITE, jcfg, tcfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_bits", [None, 8])
def test_init_cache_matches_jax(dtype, kv_bits):
    jcfg = dataclasses.replace(get_smoke_config(GRANITE), dtype=dtype,
                               kv_cache_bits=kv_bits)
    tc = TM.init_cache(tcfg_of(jcfg), 3, 10, device="cpu")
    assert set(tc) == {"kv"}
    same_layout(tc, JM.init_cache(jcfg, 3, 10), values=True)


@pytest.mark.parametrize("mode", ["fp", "int"])
def test_forward_prefill_decode_match_jax(mode):
    jcfg, tcfg = cfgs(GRANITE)
    forward_prefill_decode(GRANITE, jcfg, tcfg, mode)


def test_calibrate_matches_jax(calibrated):
    jctx, jrep, tctx, trep = calibrated
    assert list(tctx.table) == list(jctx.table)
    assert list(trep.results) == list(jrep.results)
    assert table(tctx) == table(jctx)
    assert list(tctx.table) == ["attn/wq", "attn/wk", "attn/wv", "attn/wo",
                                "lm_head"]
    assert tctx.table["attn/wo"].n_x == tctx.table["attn/wv"].n_o


@pytest.mark.parametrize("mode", ["fp", "int"])
def test_serve_matches_jax_loop(mode, calibrated):
    jcfg, tcfg = cfgs(GRANITE)
    serve_against_jax_loop(GRANITE, jcfg, tcfg, mode, calibrated[0])


def test_serve_int8_cache_matches_jax_loop(calibrated):
    """Over an int8 KV cache (K3's quantize-and-scatter plain version);
    calibration's forward keeps no cache, so its table is the fixture's."""
    jcfg, tcfg = cfgs(GRANITE, kv_cache_bits=8)
    serve_against_jax_loop(GRANITE, jcfg, tcfg, "int", calibrated[0],
                           kv_bits=8)


def test_serve_through_stand_in_graph():
    _, tcfg = cfgs(GRANITE)
    serve_through_stand_in_graph(GRANITE, tcfg)
    assert tsteps.serve_step_key(
        np.zeros((BATCH, 1)), TM.init_cache(tcfg, BATCH, PROMPT + GEN,
                                            device="cpu")) \
        == ("decode", BATCH, PROMPT + GEN)


WANT_NAMES = {
    GRANITE: {"attn/wq": "attn/wq", "attn/wo": "attn/wo",
              "moe/router": None, "moe/w1": "moe/w1", "moe/w2": "moe/w2",
              "ln1": None},
    "deepseek_v3_671b": {
        "attn/wq_a": "mla/wq_a", "attn/wq_b": "mla/wq_b",
        "attn/wkv_a": "mla/wkv_a", "attn/wkv_b": None, "attn/wo": "mla/wo",
        "attn/q_norm": None, "attn/kv_norm": None, "moe/router": None,
        "moe/w3": "moe/w3", "moe/shared/w1": "moe/shared/w1",
        "moe/shared/w2": "moe/shared/w2"},
}


@pytest.mark.parametrize("arch", ARCHS)
def test_qlinear_weight_on_every_leaf(arch):
    _, tcfg = cfgs(arch)
    tp = tparams(arch, tcfg)
    got = {}
    tqmodel._map_leaves(tp, lambda path, leaf: got.setdefault(
        path, TM.qlinear_weight(path, leaf, cfg=tcfg)))
    want = WANT_NAMES[arch]
    for path, name in got.items():
        parts = path.split("/")
        rest = "/".join(parts[2:]) if parts[0] in ("blocks",
                                                   "dense_blocks") else path
        if rest in want:
            assert name == want[rest], path
        elif path in ("embed", "ln_f") or "norm" in rest or "ln" in rest:
            assert name is None, path
        elif parts[0] == "dense_blocks":
            assert name == rest.replace("attn/", "mla/"), path
        else:
            assert name == rest, path
    assert got["lm_head" if not tcfg.tie_embeddings else "embed"] == (
        None if tcfg.tie_embeddings else "lm_head")


def test_prequantized_tree_equals_on_the_fly(calibrated):
    _, tcfg = cfgs(GRANITE)
    prequantized_equals_on_the_fly(GRANITE, tcfg, calibrated[0],
                                   {"tokens": t_(calib_tokens()[:, :12])})
