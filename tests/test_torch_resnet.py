"""Differential tests: the port's ResNet path (``repro_torch.models.resnet``,
``core.dataflow``, ``core.calibrate``'s add module, ``core.hwcost``)
against the JAX package, on the JAX package's own weights and the same
numpy images.

* ``build_plan`` / ``count_quant_ops`` identical on the eight graphs of
  ``tests/test_dataflow.py`` and on ``build_resnet_plan`` at SMOKE and
  CONFIG width;
* ``fold_bn`` and ``resnet_forward`` (every captured module output)
  within 1e-5 relative, with BN statistics perturbed from a numpy seed so
  the folded biases are non-zero;
* ``quantize_resnet``: identical tables (n_w, n_b, n_o, grids of the
  adds), identical int8 codes, errors within 1e-5 relative (the port
  sums squared errors in float64, XLA in fp32), at SMOKE and CONFIG width;
* ``resnet_int_forward``: logits bit-identical on the JAX package's
  deploy artifact carried across (``from_jax_quantized_resnet``) and on
  the port's own calibration;
* ``hwcost`` values equal to the JAX package's.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import resnet_paper as jcfgs  # noqa: E402
from repro.core import dataflow as jdf  # noqa: E402
from repro.core import hwcost as jhw  # noqa: E402
from repro.models import resnet as JR  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.configs import resnet_paper as tcfgs  # noqa: E402
from repro_torch.core import dataflow as tdf  # noqa: E402
from repro_torch.core import hwcost as thw  # noqa: E402
from repro_torch.core.integer_ops import LinearQuantSpec  # noqa: E402
from repro_torch.models import resnet as TR  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

jnp = jax.numpy
WIDTHS = ("smoke", "config")
BATCH = 8


# --- dataflow ---------------------------------------------------------------

def _graphs(df):
    """The eight hand-built graphs of tests/test_dataflow.py."""
    K, N = df.OpKind, df.OpNode
    return {
        "b": [N("conv", K.LINEAR, ("in",), has_bias=True),
              N("relu", K.RELU, ("conv",))],
        "a": [N("conv", K.LINEAR, ("in",), has_bias=True)],
        "c": [N("conv", K.LINEAR, ("in",)), N("add", K.ADD, ("conv", "in")),
              N("relu", K.RELU, ("add",))],
        "d": [N("conv", K.LINEAR, ("in",)), N("add", K.ADD, ("conv", "in"))],
        "norm": [N("bn", K.NORM, ("in",)), N("conv", K.LINEAR, ("bn",))],
        "joint": [N("c1", K.LINEAR, ("in",), has_bias=True),
                  N("r1", K.RELU, ("c1",)),
                  N("c2", K.LINEAR, ("r1",), has_bias=True),
                  N("add", K.ADD, ("c2", "in")), N("r2", K.RELU, ("add",))],
        "multi_consumer": [N("conv", K.LINEAR, ("in",)),
                           N("relu", K.RELU, ("conv",)),
                           N("add", K.ADD, ("conv", "relu"))],
        "edges": [N("c1", K.LINEAR, ("in",)), N("r1", K.RELU, ("c1",)),
                  N("c2", K.LINEAR, ("r1",))],
    }


def _plan_tuple(plan):
    return ([dataclasses.astuple(m) for m in plan.modules],
            plan.n_naive_points, plan.n_joint_points)


@pytest.mark.parametrize("graph", list(_graphs(jdf)))
def test_build_plan_matches_jax(graph):
    jp = jdf.build_plan(_graphs(jdf)[graph])
    tp = tdf.build_plan(_graphs(tdf)[graph])
    assert _plan_tuple(tp) == _plan_tuple(jp)
    assert tdf.count_quant_ops(tp) == jdf.count_quant_ops(jp)


@pytest.mark.parametrize("width", WIDTHS)
def test_resnet_plan_matches_jax(width):
    jcfg, tcfg = _cfgs(width)
    jp, tp = JR.build_resnet_plan(jcfg), TR.build_resnet_plan(tcfg)
    assert _plan_tuple(tp) == _plan_tuple(jp)
    counts = tdf.count_quant_ops(tp)
    assert counts == jdf.count_quant_ops(jp)
    assert counts["joint_activation_points"] == len(tp.modules)
    if width == "config":      # 15 convolutions, 6 adds and the head
        assert len(tp.modules) == 22


def test_quantized_tensor_dequant():
    codes = torch.tensor([-128, -3, 0, 5, 127], dtype=torch.int8)
    qt = tdf.QuantizedTensor(codes, n=3)
    jq = jdf.QuantizedTensor(jnp.asarray(codes.numpy()), n=3)
    assert qt.shape == codes.shape
    assert np.array_equal(qt.dequant().numpy(), np.asarray(jq.dequant()))


# --- the model: one calibration per package and width, shared below --------

def _cfgs(width):
    if width == "smoke":
        return jcfgs.SMOKE_CONFIG, tcfgs.SMOKE_CONFIG
    return jcfgs.CONFIG, tcfgs.CONFIG


def _perturb_bn(params, seed):
    rng = np.random.default_rng(seed)
    convs = [params["stem"]] + [c for blk in params["blocks"]
                                for c in blk.values()]
    for c in convs:
        n = c["bn_gamma"].shape[0]
        c["bn_gamma"] = jnp.asarray(rng.uniform(0.5, 1.5, n), jnp.float32)
        c["bn_beta"] = jnp.asarray(rng.normal(0.0, 0.1, n), jnp.float32)
        c["bn_mean"] = jnp.asarray(rng.normal(0.0, 0.1, n), jnp.float32)
        c["bn_var"] = jnp.asarray(rng.uniform(0.5, 2.0, n), jnp.float32)


@pytest.fixture(scope="module", params=WIDTHS)
def net(request):
    """One JAX calibration per width; the JAX init and integer forward
    compiled (each once, where op-by-op dispatch compiled every primitive
    at every shape); both packages share the JAX weights, so the init's
    numbers need not be the eager ones."""
    jcfg, tcfg = _cfgs(request.param)
    jp = jax.jit(JR.init_resnet, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(0))
    _perturb_bn(jp, 5)
    tp = TR.from_jax_resnet_params(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    x = np.random.default_rng(1).uniform(
        0, 1, size=(BATCH, jcfg.img_size, jcfg.img_size, 3)).astype(np.float32)
    jq = JR.quantize_resnet(jp, jnp.asarray(x), jcfg)
    tq = TR.quantize_resnet(tp, torch.from_numpy(x), tcfg)
    jfwd = jax.jit(lambda x_: JR.resnet_int_forward(jq, x_, jcfg))
    return dict(width=request.param, jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp,
                x=x, jq=jq, tq=tq, jlogits=np.asarray(jfwd(jnp.asarray(x))))


def test_fold_bn_and_forward_match_jax(net):
    jp, tp = net["jp"], net["tp"]
    for jc, tc in [(jp["stem"], tp["stem"])] + [
            (jblk[k], tblk[k]) for jblk, tblk in zip(jp["blocks"],
                                                    tp["blocks"])
            for k in jblk]:
        for jv, tv in zip(JR.fold_bn(jc), TR.fold_bn(tc)):
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv),
                                       rtol=1e-5, atol=1e-7)
    assert any(float(np.abs(np.asarray(JR.fold_bn(c)[1])).max()) > 0.01
               for blk in jp["blocks"] for c in blk.values())
    jcol, tcol = {}, {}
    jl = JR.resnet_forward(jp, jnp.asarray(net["x"]), net["jcfg"], jcol)
    tl = TR.resnet_forward(tp, torch.from_numpy(net["x"]), net["tcfg"], tcol)
    assert list(tcol) == list(jcol)
    for name in jcol:
        want = np.asarray(jcol[name])
        got = tcol[name].numpy()
        assert got.shape == want.shape, name
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), name
    assert torch.equal(tl, tcol["head"])
    assert jl.shape == tl.shape


def _spec_tuple(s):
    return s if isinstance(s, tuple) else dataclasses.astuple(s)


def test_quantize_resnet_table_matches_jax(net):
    jq, tq = net["jq"], net["tq"]
    assert list(tq.specs) == list(jq.specs)
    for name, js in jq.specs.items():
        assert _spec_tuple(tq.specs[name]) == _spec_tuple(js), name
        jr, tr = jq.report.results[name], tq.report.results[name]
        assert tr.error == pytest.approx(jr.error, rel=1e-5), name
        assert tr.fp_norm == pytest.approx(jr.fp_norm, rel=1e-5), name
        assert tr.rel_error == pytest.approx(jr.rel_error, rel=1e-5), name
    assert tq.n_in == jq.n_in
    for name in jq.weights:
        for got, want in ((tq.weights[name], jq.weights[name]),
                          (tq.biases[name], jq.biases[name])):
            assert got.dtype == torch.int8
            assert np.array_equal(got.numpy(), np.asarray(want)), name
    assert tq.report.shift_histogram() == jq.report.shift_histogram()
    assert tq.report.total_s == pytest.approx(
        sum(r.elapsed_s for r in tq.report.results.values()))
    if net["width"] == "config":
        assert len(tq.report.results) == 22


def test_int_forward_bridged_artifact_bit_identical(net):
    tq = TR.from_jax_quantized_resnet(net["jq"], device="cpu")
    for name, s in tq.specs.items():
        assert isinstance(s, tuple if name.endswith("/add")
                          else LinearQuantSpec)
    logits = TR.resnet_int_forward(tq, torch.from_numpy(net["x"]),
                                   net["tcfg"])
    assert logits.dtype == torch.float32
    assert np.array_equal(logits.numpy(), net["jlogits"])


def test_int_forward_own_calibration_bit_identical(net):
    logits = TR.resnet_int_forward(net["tq"], torch.from_numpy(net["x"]),
                                   net["tcfg"])
    assert np.array_equal(logits.numpy(), net["jlogits"])
    # and it tracks the float forward (the reference's own smoke check)
    fp = TR.resnet_forward(net["tp"], torch.from_numpy(net["x"]),
                           net["tcfg"])
    assert float((fp.argmax(-1) == logits.argmax(-1)).float().mean()) >= 0.5


def test_init_resnet_shapes_match_jax():
    cfg = tcfgs.CONFIG
    gen = torch.Generator()
    gen.manual_seed(0)
    tp = TR.init_resnet(cfg, generator=gen, device="cpu")
    # shapes and dtypes only: traced, not run
    jp = jax.eval_shape(lambda k: JR.init_resnet(jcfgs.CONFIG, k),
                        jax.random.PRNGKey(0))
    jl, jt = jax.tree_util.tree_flatten_with_path(jp)
    tl = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), tp))[0]
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (_, a), (_, b) in zip(tl, jl):
        assert a.shape == b.shape and a.dtype == b.dtype


# --- hwcost -----------------------------------------------------------------

def test_hwcost_matches_jax():
    assert set(thw.TABLE5) == set(jhw.TABLE5)
    for kind in jhw.TABLE5:
        assert dataclasses.astuple(thw.estimate(kind, 123456)) == \
            dataclasses.astuple(jhw.estimate(kind, 123456))
        assert thw.energy_per_op_pj(kind) == jhw.energy_per_op_pj(kind)
        assert thw.energy_uj(kind, 98765) == jhw.energy_uj(kind, 98765)
        assert thw.estimate(kind, 7).row() == jhw.estimate(kind, 7).row()
    for n, bits in ((1000, 8), (4097, 4), (12, 32)):
        assert thw.memory_access_bytes(n, bits) == \
            jhw.memory_access_bytes(n, bits)
    assert thw.forward_quant_ops_per_token(tget_config("qwen3_1_7b")) == \
        jhw.forward_quant_ops_per_token(jget_config("qwen3_1_7b"))
    # the recurrent counters read config fields only: the JAX package's
    # recurrent configs give the same counts; the port's dense config none
    for arch in ("rwkv6_3b", "zamba2_2_7b", "qwen3_1_7b"):
        assert thw.state_quant_ops_per_step(jget_config(arch)) == \
            jhw.state_quant_ops_per_step(jget_config(arch))
    assert thw.state_quant_ops_per_step(tget_config("qwen3_1_7b")) == 0
