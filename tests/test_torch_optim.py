"""The port's optimizers, schedules, gradient codec and straight-through
fake quantization against the JAX package's, on the same numpy inputs:

* ``adamw`` (three updates, an fp32 and a bf16 leaf), ``adafactor``
  (factored and full leaves; layers the reference stacks into one leaf
  sharing one update RMS) and ``clip_by_global_norm`` (clipping and not):
  fp32 values within 2e-6 relative to each leaf's largest, bf16 params
  within one bf16 ulp;
* ``warmup_cosine`` / ``warmup_linear`` at every step, host ints and
  device tensors, within 1 fp32 ulp of the reference's;
* ``quantize_grads_po2`` codes and grids identical,
  ``dequantize_grads_po2`` within 1e-7; ``compressed_psum`` on one rank
  and on 2 (over ``data``) and 4 (over ``model``) spawned gloo ranks
  against the reference's under ``jax.vmap(axis_name=...)`` on the same
  per-rank numpy gradients (its ``pmax`` / ``psum`` over the mapped
  axis), within 1e-7;
* ``fake_quant_ste``: the value ``fake_quant``'s, the gradient the
  reference's ``custom_vjp`` (1 inside the range, 0 where clipped),
  exactly;
* a property over leaf shapes: one AdamW and one Adafactor update on a
  random leaf agree with the reference's.

About 25 s on one thread, most of it the JAX package's eager updates
and the spawned ranks.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # the tier-1 container ships no hypothesis
    from tests._hyp_stub import given, settings, st

from repro.core import qscheme as jq  # noqa: E402
from repro.optim import compression as jc  # noqa: E402
from repro.optim import optimizers as jo  # noqa: E402
from repro.optim import schedule as js  # noqa: E402
from repro_torch.core import qscheme as tq  # noqa: E402
from repro_torch.core.tree import leaves  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.optim import compression as tc  # noqa: E402
from repro_torch.optim import optimizers as to  # noqa: E402
from repro_torch.optim import schedule as ts  # noqa: E402
from tests import train_mesh_cases as cases_lib  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401


def _np_tree(seed, shapes):
    rng = np.random.default_rng(seed)
    return {name: rng.standard_normal(shape).astype(np.float32)
            for name, shape in shapes.items()}


def _j(tree, bf16=()):
    return {k: jnp.asarray(v, jnp.bfloat16 if k in bf16 else jnp.float32)
            for k, v in tree.items()}


def _t(tree, bf16=()):
    return {k: torch.from_numpy(v.copy()).to(
        torch.bfloat16 if k in bf16 else torch.float32)
        for k, v in tree.items()}


def _close(got, want, rel=2e-6):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= rel * scale, \
        np.abs(got - want).max() / scale


SHAPES = {"w": (130, 128), "b": (17,), "e": (3, 5, 7)}


def test_adamw_matches_jax():
    params = _np_tree(0, SHAPES)
    jopt, topt = jo.adamw(), to.adamw()
    jp, tp = _j(params, bf16=("e",)), _t(params, bf16=("e",))
    jst, tst = jopt.init(jp), topt.init(tp)
    for i in range(3):
        grads = _np_tree(10 + i, SHAPES)
        lr = 1e-2 * (i + 1)
        jp, jst = jopt.update(_j(grads, ("e",)), jst, jp, lr)
        tp2, tst2 = topt.update(_t(grads, ("e",)), tst, tp, lr)
        assert tp2 is tp and tst2 is tst     # updated in place
    assert int(tst.step) == int(jst.step) == 3
    for k in SHAPES:
        if k == "e":            # bf16: within one ulp of the value
            d = (tp[k].float().numpy()
                 - np.asarray(jp[k].astype(jnp.float32)))
            assert np.all(np.abs(d) <= 2.0 ** -7 * np.abs(
                np.asarray(jp[k].astype(jnp.float32))) + 1e-30)
            assert tp[k].dtype == torch.bfloat16
        else:
            _close(tp[k], jp[k])
        _close(tst.m[k], jst.m[k])
        _close(tst.v[k], jst.v[k])


def test_adafactor_matches_jax_and_shares_stacked_rms():
    """A factored leaf (>= 128 both ways), a full one, and two layers that
    the reference stacks into one (L, 128, 128) leaf: the port's per-layer
    leaves take the stacked leaf's one update RMS."""
    rng = np.random.default_rng(1)
    stacked = rng.standard_normal((2, 128, 128)).astype(np.float32)
    flat = _np_tree(2, {"w": (130, 128), "b": (17,)})
    jp = dict(_j(flat), blocks={"wq": jnp.asarray(stacked)})
    tp = dict(_t(flat), blocks=[{"wq": torch.from_numpy(stacked[i].copy())}
                                for i in range(2)])
    jopt, topt = jo.adafactor(weight_decay=0.01), to.adafactor(
        weight_decay=0.01)
    jst, tst = jopt.init(jp), topt.init(tp)
    assert isinstance(tst.v["w"], tuple) and not isinstance(tst.v["b"],
                                                            tuple)
    for i in range(2):
        g_st = rng.standard_normal((2, 128, 128)).astype(np.float32)
        # one layer's gradient 10x the other's: a per-layer RMS would
        # clip them differently
        g_st[1] *= 10
        g_flat = _np_tree(20 + i, {"w": (130, 128), "b": (17,)})
        jg = dict(_j(g_flat), blocks={"wq": jnp.asarray(g_st)})
        tg = dict(_t(g_flat), blocks=[{"wq": torch.from_numpy(
            g_st[j].copy())} for j in range(2)])
        jp, jst = jopt.update(jg, jst, jp, 0.1)
        topt.update(tg, tst, tp, 0.1)
    _close(tp["w"], jp["w"])
    _close(tp["b"], jp["b"])
    for j in range(2):
        _close(tp["blocks"][j]["wq"], jp["blocks"]["wq"][j])
        for a, b in zip(tst.v["blocks"][j]["wq"], jst.v["blocks"]["wq"]):
            _close(a, b[j])
    _close(tst.v["w"][0], jst.v["w"][0])
    _close(tst.v["w"][1], jst.v["w"][1])
    _close(tst.v["b"], jst.v["b"])
    assert tst.m is None and jst.m is None


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    grads = _np_tree(3, SHAPES)
    jg, jn = jo.clip_by_global_norm(_j(grads, ("e",)), max_norm)
    tg, tn = to.clip_by_global_norm(_t(grads, ("e",)), max_norm)
    assert abs(float(tn) - float(jn)) <= 2e-6 * float(jn)
    for k in SHAPES:
        assert tg[k].dtype == (torch.bfloat16 if k == "e" else
                               torch.float32)
        _close(tg[k], jg[k], rel=2e-6 if k != "e" else 2.0 ** -8)


@pytest.mark.parametrize("name", ["warmup_cosine", "warmup_linear"])
def test_schedules_match_jax(name):
    jf, tf = getattr(js, name)(3e-3, 7, 50), getattr(ts, name)(3e-3, 7, 50)
    wants = np.asarray(jf(jnp.arange(60)), np.float32)   # elementwise
    for step in range(0, 60):
        want = wants[step]
        for s in (step, torch.tensor(step, dtype=torch.int32)):
            got = tf(s)
            assert got.dtype == torch.float32 and got.ndim == 0
            assert abs(float(got) - float(want)) <= \
                float(np.spacing(np.abs(want))), (step, s)
    assert float(ts.warmup_cosine(3e-3, 5, 50)(0)) == 0.0


def test_grad_codec_matches_jax():
    grads = _np_tree(4, SHAPES)
    grads["z"] = np.zeros((4,), np.float32)
    jcodes, jns = jc.quantize_grads_po2(_j(grads))
    tcodes, tns = tc.quantize_grads_po2(_t(grads))
    for k in grads:
        assert tcodes[k].dtype == torch.int32
        assert np.array_equal(tcodes[k].numpy(), np.asarray(jcodes[k]))
        assert float(tns[k]) == float(jns[k])
        assert int(tcodes[k].abs().max()) <= 128
    jd = jc.dequantize_grads_po2(jcodes, jns, count=3)
    td = tc.dequantize_grads_po2(tcodes, tns, count=3)
    for k in grads:
        np.testing.assert_allclose(td[k].numpy(), np.asarray(jd[k]),
                                   atol=1e-7, rtol=1e-7)
    # compressed_psum over a one-rank axis: the grid is the rank's own
    want = jax.vmap(lambda g: jc.compressed_psum(g, "r"), axis_name="r")(
        {k: jnp.asarray(v)[None] for k, v in grads.items()})
    got = tc.compressed_psum(_t(grads), "data",
                             mesh=tmesh.RankMesh(1, 1))
    for k in grads:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k][0]),
                                   atol=1e-7, rtol=0)


PSUM_SHAPES = {"a": (3, 130), "b": (7,), "c": (2, 4, 5), "z": (4,)}


@pytest.mark.parametrize("shape,axis", [((2, 1), "data"),
                                        ((1, 4), "model")],
                         ids=["2 ranks over data", "4 ranks over model"])
def test_compressed_psum_matches_jax(shape, axis, tmp_path):
    """Each rank's own gradients (their maxima apart, a zero leaf, a bf16
    leaf), the shared coarsest grid, the int32 sum and the mean."""
    n = shape[0] * shape[1]
    per_rank = []
    for r in range(n):
        g = _np_tree(100 + r, PSUM_SHAPES)
        g["a"] *= 4.0 ** r
        g["z"][:] = 0.0
        per_rank.append(g)
    want = jax.vmap(lambda g: jc.compressed_psum(g, "r"), axis_name="r")(
        {k: jnp.asarray(np.stack([g[k] for g in per_rank]),
                        jnp.bfloat16 if k == "c" else jnp.float32)
         for k in PSUM_SHAPES})
    got = tmesh.run_ranks(cases_lib.psum_case, shape, device="cpu",
                          backend="gloo", workdir=str(tmp_path), threads=1,
                          kwargs={"per_rank": per_rank, "axis": axis,
                                  "bf16": ("c",)})
    for r, res in enumerate(got):
        for k in PSUM_SHAPES:
            w = np.asarray(want[k][r].astype(jnp.float32))
            assert res[k].dtype == (torch.bfloat16 if k == "c"
                                    else torch.float32)
            np.testing.assert_allclose(res[k].float().numpy(), w, atol=1e-7,
                                       rtol=0)
            assert torch.equal(res[k], got[0][k])


@pytest.mark.parametrize("bits,unsigned,n", [(8, False, 4), (4, False, 2),
                                             (8, True, 5)])
def test_fake_quant_ste_matches_jax(bits, unsigned, n):
    rng = np.random.default_rng(bits + n)
    r = (rng.standard_normal(500) * 2 ** (bits - n)).astype(np.float32)
    w = rng.standard_normal(500).astype(np.float32)
    want_v = jq.fake_quant_ste(jnp.asarray(r), n, bits, unsigned)
    want_g = jax.grad(lambda x: jnp.sum(
        jq.fake_quant_ste(x, n, bits, unsigned) * w))(jnp.asarray(r))
    tr = torch.from_numpy(r).requires_grad_()
    got_v = tq.fake_quant_ste(tr, n, bits, unsigned)
    (got_g,) = torch.autograd.grad((got_v * torch.from_numpy(w)).sum(),
                                   (tr,))
    assert np.array_equal(got_v.detach().numpy(), np.asarray(want_v))
    assert torch.equal(got_v.detach(), tq.fake_quant(tr.detach(), n, bits,
                                                      unsigned))
    assert np.array_equal(got_g.numpy(), np.asarray(want_g))
    clipped = got_g.numpy() == 0
    assert 0 < clipped.sum() < clipped.size
    # fake_quant itself has no gradient (its trunc has none)
    (g0,) = torch.autograd.grad(tq.fake_quant(tr, n, bits, unsigned).sum(),
                                (tr,))
    assert not torch.any(g0)


@settings(max_examples=8, deadline=None)
@given(rows=st.sampled_from([1, 3, 127, 128, 130]),
       cols=st.sampled_from([1, 5, 128, 129]),
       lead=st.sampled_from([0, 2]), seed=st.integers(0, 1000))
def test_update_property_over_leaf_shapes(rows, cols, lead, seed):
    shape = ((lead,) if lead else ()) + (rows, cols)
    p = _np_tree(seed, {"x": shape})
    g = _np_tree(seed + 1, {"x": shape})
    for jopt, topt in ((jo.adamw(), to.adamw()),
                       (jo.adafactor(), to.adafactor())):
        jp, tp = _j(p), _t(p)
        jst, tst = jopt.init(jp), topt.init(tp)
        jp, jst = jopt.update(_j(g), jst, jp, 0.05)
        topt.update(_t(g), tst, tp, 0.05)
        _close(tp["x"], jp["x"], rel=4e-6)
        assert len(leaves(tst.v)) == len(jax.tree.leaves(jst.v))
