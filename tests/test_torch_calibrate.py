"""Differential tests: the port's Algorithm-1 calibration (``repro_torch.core``
``qscheme`` / ``calibrate`` / ``lm_calibrate`` / ``qmodel``) against the JAX
package's, on the same numpy inputs and the JAX package's own weights.

* ``fake_quant``, ``max_frac_bits`` and ``search_window`` bit-exact,
  .5 ties and the unsigned grid included;
* ``calibrate_linear_module`` picks the same (n_w, n_b, n_o), errors within
  1e-5 relative (the port sums squared errors in float64, XLA in fp32), on
  the signed output grid the port's LM modules use;
* ``capture_activations`` records the same module names in the same order,
  weights identical, inputs within 1e-5 (the rms statistic departs in the
  last bit, see ``repro_torch.models.common.inv_rms``);
* ``calibrate_lm`` on the fp32 qwen3 smoke model gives an identical table,
  threaded edges included;
* ``quantize_params`` converts the same modules to the same codes.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.core import calibrate as jcal  # noqa: E402
from repro.core import qmodel as jqm  # noqa: E402
from repro.core import qscheme as jqs  # noqa: E402
from repro.core.lm_calibrate import calibrate_lm as jcalibrate_lm  # noqa: E402
from repro.data import make_calibration_batch as jbatch  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import calibrate as tcal  # noqa: E402
from repro_torch.core import qmodel as tqm  # noqa: E402
from repro_torch.core import qscheme as tqs  # noqa: E402
from repro_torch.core.lm_calibrate import calibrate_lm as tcalibrate_lm  # noqa: E402
from repro_torch.data import make_calibration_batch as tbatch  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

jnp = jax.numpy


def _vals(seed, shape=(64, 48), scale=3.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    # exact .5 ties on the grids below, both signs
    x.flat[:8] = np.asarray([0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 0.25, -0.75])
    return x


@pytest.mark.parametrize("n", [-2, 0, 3, 7])
@pytest.mark.parametrize("unsigned", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_quant_bit_exact(n, unsigned, dtype):
    x = _vals(n + 10)
    xj = jnp.asarray(x).astype(dtype)
    want = np.asarray(jqs.fake_quant(xj, n, 8, unsigned).astype(jnp.float32))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = tqs.fake_quant(xt, n, 8, unsigned)
    assert got.dtype == xt.dtype
    assert np.array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("m", [0.0, 1.0, 3.0, 7.0, 0.5, 2.0 ** -30, 127.0,
                               2.0 ** 20 - 1, 1.0000001, 2.9999998, 1e5])
def test_max_frac_bits_and_window(m):
    x = np.asarray([m, -m / 2, m / 3], np.float32)
    assert tqs.max_frac_bits(torch.from_numpy(x)) == \
        int(jqs.max_frac_bits(jnp.asarray(x)))
    for tau in (0, 4):
        assert tqs.search_window(torch.from_numpy(x), tau) == \
            jqs.search_window(jnp.asarray(x), tau)


def test_search_window_random():
    for seed in range(20):
        x = _vals(seed, scale=10.0 ** (seed % 5 - 2))
        assert tqs.search_window(torch.from_numpy(x)) == \
            jqs.search_window(jnp.asarray(x))


@pytest.mark.parametrize("has_bias", [False, True])
@pytest.mark.parametrize("rows,k,n", [(96, 64, 40), (33, 128, 24)])
def test_calibrate_linear_module_matches_jax(has_bias, rows, k, n):
    rng = np.random.default_rng(3 + 2 * has_bias + k)
    x = rng.standard_normal((rows, k)).astype(np.float32) * 2
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(n) * 0.3).astype(np.float32) if has_bias \
        else None
    n_x = 4
    xq = np.array(jqs.fake_quant(jnp.asarray(x), n_x))
    o_ref = x @ w + (b if b is not None else 0)

    def apply(xx, wq, bq):
        return xx @ wq + (bq if bq is not None else 0)

    jr = jcal.calibrate_linear_module(
        jnp.asarray(xq), jnp.asarray(w), None if b is None else jnp.asarray(b),
        jnp.asarray(o_ref), apply)
    tr = tcal.calibrate_linear_module(
        torch.from_numpy(xq), torch.from_numpy(w),
        None if b is None else torch.from_numpy(b), torch.from_numpy(o_ref),
        apply, bits=8, tau=4)
    assert (tr.n_w, tr.n_b, tr.n_o) == (jr.n_w, jr.n_b, jr.n_o)
    assert tr.error == pytest.approx(jr.error, rel=1e-5)


# --- the LM: one calibration of each package, shared by the tests below ---

@pytest.fixture(scope="module")
def lm():
    jcfg = dataclasses.replace(get_smoke_config("qwen3_1_7b"),
                               dtype="float32")
    tcfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    npt = jax.tree.map(np.asarray, jparams)
    tparams = TM.from_jax_params(npt, tcfg, device="cpu")
    batch = jbatch(jcfg.vocab_size, 32, 4)
    assert np.array_equal(batch["tokens"],
                          tbatch(tcfg.vocab_size, 32, 4)["tokens"])
    jctx, jrep = jcalibrate_lm(
        lambda p, b, c: JM.forward(p, b, jcfg, c), jparams,
        {"tokens": jnp.asarray(batch["tokens"])})
    tctx, trep = tcalibrate_lm(
        lambda p, b, c: TM.forward(p, b, tcfg, c), tparams,
        {"tokens": torch.from_numpy(batch["tokens"])})
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                batch=batch, jctx=jctx, jrep=jrep, tctx=tctx, trep=trep)


def test_capture_activations_matches_jax(lm):
    with jqm.capture_activations() as jstore:
        JM.forward(lm["jparams"], {"tokens": jnp.asarray(lm["batch"]["tokens"])},
                   lm["jcfg"], jqm.QuantContext())
        jax.effects_barrier()
    with tqm.capture_activations() as tstore:
        TM.forward(lm["tparams"],
                   {"tokens": torch.from_numpy(lm["batch"]["tokens"])},
                   lm["tcfg"], tqm.QuantContext())
    assert list(tstore) == list(jstore)
    assert list(tstore) == ["attn/wq", "attn/wk", "attn/wv", "attn/wo",
                            "mlp/w1", "mlp/w3", "mlp/w2", "lm_head"]
    for name, (jx, jw, jb) in jstore.items():
        tx, tw, tb = tstore[name]
        assert np.array_equal(tw.numpy(), np.asarray(jw)[0]
                              if np.ndim(jw) == 3 else np.asarray(jw))
        assert tb is None and (jb is None or np.ndim(jb) == 0)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5,
                                   atol=1e-5)
    # outside the context nothing is recorded
    TM.forward(lm["tparams"], {"tokens": torch.from_numpy(
        lm["batch"]["tokens"])}, lm["tcfg"], tqm.QuantContext())
    assert len(tstore) == 8


def test_calibrate_lm_table_identical(lm):
    jt, tt = lm["jctx"].table, lm["tctx"].table
    assert list(tt) == list(jt)
    for name in jt:
        assert dataclasses.astuple(tt[name]) == dataclasses.astuple(jt[name]), name
        # the captured inputs differ in the last bit now and then (the rms
        # statistic), which can move a code of the module's output grid
        jr, tr = lm["jrep"].results[name], lm["trep"].results[name]
        assert tr.error == pytest.approx(jr.error, rel=1e-3), name
    assert lm["tctx"].mode is tqm.QuantMode.FAKE
    # the threaded edges: wo <- wv, w2 <- w1
    assert tt["attn/wo"].n_x == tt["attn/wv"].n_o
    assert tt["mlp/w2"].n_x == tt["mlp/w1"].n_o
    assert lm["trep"].shift_histogram() == lm["jrep"].shift_histogram()


def test_quantize_params_matches_jax(lm):
    jctx = dataclasses.replace(lm["jctx"], mode=jqm.QuantMode.INT)
    tctx = dataclasses.replace(lm["tctx"], mode=tqm.QuantMode.INT)
    jq = jqm.quantize_params(lm["jparams"], jctx)
    tq = tqm.quantize_params(lm["tparams"], tctx)
    # the port keeps one leaf per layer where JAX stacks them
    L = lm["tcfg"].n_layers
    want = sorted(p.replace("blocks/", f"blocks/{i}/", 1)
                  if p.startswith("blocks/") else p
                  for p in jq.converted
                  for i in (range(L) if p.startswith("blocks/") else [0]))
    assert sorted(tq.converted) == want
    jtree = jax.tree.map(np.asarray, jq.tree)
    for layer in range(L):
        for mod in ("attn", "mlp"):
            for k, codes in jtree["blocks"][mod].items():
                got = tq.tree["blocks"][layer][mod][k]
                assert got.dtype == (torch.int8 if codes.dtype == np.int8
                                     else got.dtype)
                assert np.array_equal(got.numpy(), codes[layer])
    assert np.array_equal(tq.tree["lm_head"].numpy(), jtree["lm_head"])
    assert tq.tree["embed"].dtype == torch.float32      # stays float
    # INT forward over the codes equals INT over the float weights
    tokens = torch.from_numpy(lm["batch"]["tokens"][:, :8])
    a, _ = TM.forward(tq.tree, {"tokens": tokens}, lm["tcfg"], tctx)
    b, _ = TM.forward(lm["tparams"], {"tokens": tokens}, lm["tcfg"], tctx)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="INT mode"):
        TM.forward(tq.tree, {"tokens": tokens}, lm["tcfg"], lm["tctx"])


def test_fake_sf_raises_naming_roadmap():
    """FAKE_SF no longer raises: the scaling-factor baseline's ``qlinear``
    (``core.baselines.scale_quant`` on input, weight and bias) against the
    JAX one, with and without a bias, within 1e-5 (the fp32 products sum
    in other orders); the quantized operands themselves are bit-exact
    (``tests/test_torch_baselines.py``)."""
    rng = np.random.default_rng(21)
    x = (rng.standard_normal((16, 48)) * 3).astype(np.float32)
    w = (rng.standard_normal((48, 24)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(24) * 0.1).astype(np.float32)
    jctx = jqm.QuantContext(mode=jqm.QuantMode.FAKE_SF)
    tctx = tqm.QuantContext(mode=tqm.QuantMode.FAKE_SF)
    for bias in (None, b):
        want = jqm.qlinear(jctx, "m", jnp.asarray(x), jnp.asarray(w),
                           None if bias is None else jnp.asarray(bias))
        got = tqm.qlinear(tctx, "m", torch.from_numpy(x), torch.from_numpy(w),
                          None if bias is None else torch.from_numpy(bias))
        assert got.dtype == torch.float32 and got.shape == (16, 24)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    with pytest.raises(ValueError, match="INT mode"):
        tqm.qlinear(tctx, "m", torch.from_numpy(x),
                    torch.zeros((48, 24), dtype=torch.int8))
