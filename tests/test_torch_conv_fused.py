"""Differential tests: the convolution kernel's plain version and the
fused conv2 + residual add of the ResNet path against the JAX package, on
the same numpy inputs, bit for bit.

* ``int_conv2d(..., residual=...)`` (``integer_ops``, ``ops`` and the
  kernel's plain version ``ref.int_conv2d_ref``) against the JAX
  ``int_conv2d`` (XLA's int32 convolution) followed by
  ``int_residual_add`` with ReLU: kernel 1 and 3, stride 1 and 2, Cin 3 /
  8 / 16, int8 and uint8 input, int8 and uint8 shortcut, the path's
  grids, a negative bias shift, negative requant shifts (the
  convolution's and the add's) that saturate, and a 7-bit convolution
  whose add still emits 8-bit codes.
* ``plan_int_conv`` at every convolution of CONFIG and SMOKE_CONFIG,
  batch 256 and 1: XLA's "SAME" padding and output size, tiles covering M
  and N, the narrow column tile.
* ``resnet_int_forward`` at SMOKE width with every convolution routed
  through the kernel wrapper (``ops.int_conv2d``, its plain version on the
  CPU) and no standalone residual add: logits identical to the JAX
  package's (``tests/test_torch_resnet.py``'s ``net`` fixture), and at
  the paper's Table 4 bit widths 7 and 6, where the add still requantizes
  to 8-bit codes (the reference's ``int_residual_add`` default).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.core import integer_ops as jio  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import resnet as JR  # noqa: E402
from repro_torch.configs import resnet_paper as tcfgs  # noqa: E402
from repro_torch.core import integer_ops as tio  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.int_conv import (CONV_TILES,  # noqa: E402
                                          plan_int_conv)
from repro_torch.models import resnet as TR  # noqa: E402
from tests.test_torch_resnet import (BATCH, _cfgs, _perturb_bn,  # noqa: E402
                                     net)  # noqa: F401
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

jnp = jax.numpy

DTYPES = {"int8": (np.int8, -128, 128), "uint8": (np.uint8, 0, 256)}
# (convolution spec, the add's (n_a, n_b, n_o)): the path's grids (the
# branch on the convolution's own grid); a negative bias shift with a
# finer shortcut; a negative requant shift in the convolution and an add
# whose shifted sum overflows int32, where saturation decides
CASES = {
    "path": (dict(n_x=4, n_w=5, n_b=3, n_o=2), (2, 3, 2)),
    "bias>>": (dict(n_x=4, n_w=5, n_b=13, n_o=3), (3, 6, 4)),
    "requant<0": (dict(n_x=1, n_w=2, n_b=1, n_o=6), (0, 20, 30)),
    # Table 4's 7 bits: the convolution clips to 7-bit codes, the add to
    # 8-bit ones (the reference's int_residual_add default)
    "bits7": (dict(n_x=4, n_w=5, n_b=3, n_o=2, bits=7), (2, 3, 3)),
}


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("cin", [3, 8, 16])
@pytest.mark.parametrize("x_dtype", ["int8", "uint8"])
@pytest.mark.parametrize("sc_dtype", ["int8", "uint8"])
@pytest.mark.parametrize("case", list(CASES))
def test_fused_residual_conv_bit_exact(k, stride, cin, x_dtype, sc_dtype,
                                       case):
    spec_kw, (n_a, n_b, n_o) = CASES[case]
    rng = np.random.default_rng(
        [k, stride, cin, len(x_dtype), len(sc_dtype), len(case)])
    size, cout = (7 if cin == 8 else 8), 8
    ho = -(-size // stride)
    tx, lx, hx = DTYPES[x_dtype]
    ts, ls, hs = DTYPES[sc_dtype]
    x = rng.integers(lx, hx, size=(2, size, size, cin)).astype(tx)
    w = rng.integers(-128, 128, size=(k, k, cin, cout)).astype(np.int8)
    b = rng.integers(-128, 128, size=(cout,)).astype(np.int8)
    sc = rng.integers(ls, hs, size=(2, ho, ho, cout)).astype(ts)
    h = jio.int_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                       jio.LinearQuantSpec(**spec_kw), stride=stride)
    want = jio.int_residual_add(h.astype(jnp.int32), n_a,
                                jnp.asarray(sc).astype(jnp.int32), n_b, n_o,
                                apply_relu=True)
    tx_, tw, tb, tsc = (torch.from_numpy(v) for v in (x, w, b, sc))
    spec = tio.LinearQuantSpec(**spec_kw)
    res = (tsc, n_a, n_b, n_o)
    _same(tio.int_conv2d(tx_, tw, tb, spec, stride=stride, residual=res),
          want)
    _same(tops.int_conv2d(tx_, tw, tb, spec, stride=stride, residual=res),
          want)
    _same(tref.int_conv2d_ref(tx_, tw, tb, spec, stride=stride,
                              residual=res), want)
    assert not any(tops.LAUNCHES.values())          # CPU: plain versions
    if case == "bits7":
        assert int(np.asarray(want).max()) > 127
    if case == "requant<0":
        # the add's int32 sum overflows under the left shift: saturating
        # (the path's) and wrapping (the TPU kernel's) differ
        wrap = jref.residual_requant_ref(h, jnp.asarray(sc), n_a=n_a,
                                         n_b=n_b, n_o=n_o, relu=True)
        assert not np.array_equal(np.asarray(wrap), np.asarray(want))


def _convs(cfg, batch):
    """(B, H, W, Cin, Cout, k, stride) of every convolution of the
    integer forward, from ``init_resnet``'s weights and the path's
    strides, in the forward's order."""
    gen = torch.Generator()
    gen.manual_seed(0)
    p = TR.init_resnet(cfg, generator=gen, device="cpu")
    side = cfg.img_size
    out = [(batch, side, side, *p["stem"]["w"].shape[2:], 3, 1)]
    bi = 0
    for si, _ in enumerate(cfg.stages):
        for blk_i in range(cfg.blocks_per_stage):
            blk, stride = p["blocks"][bi], TR._stride(si, blk_i)
            for name, s, hw in (("conv1", stride, side),
                                ("proj", stride, side),
                                ("conv2", 1, -(-side // stride))):
                if name in blk:
                    kh, _, cin, cout = blk[name]["w"].shape
                    out.append((batch, hw, hw, cin, cout, kh, s))
            side = -(-side // stride)
            bi += 1
    return out


PLAN_CASES = [(name, batch, i, conv)
              for name, cfg in (("config", tcfgs.CONFIG),
                                ("smoke", tcfgs.SMOKE_CONFIG))
              for batch in (256, 1)
              for i, conv in enumerate(_convs(cfg, batch))]


def test_plan_cases_cover_the_path():
    """15 convolutions at CONFIG width (the stem, two a block, two
    projections), 6 at SMOKE width."""
    assert sum(c[:2] == ("config", 1) for c in PLAN_CASES) == 15
    assert sum(c[:2] == ("smoke", 1) for c in PLAN_CASES) == 6


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("name,batch,i,conv", PLAN_CASES,
                         ids=[f"{c[0]}-b{c[1]}-{c[2]}" for c in PLAN_CASES])
def test_plan_int_conv(name, batch, i, conv, sms):
    b, h, w, cin, cout, k, stride = conv
    plan = plan_int_conv(b, h, w, cin, cout, k, k, stride, sms)
    pads = jax.lax.padtype_to_pads((h, w), (k, k), (stride, stride), "SAME")
    assert (tuple(plan.pad_h), tuple(plan.pad_w)) == tuple(map(tuple, pads))
    assert (tuple(plan.pad_h), tuple(plan.pad_w)) == (
        tio.same_padding(h, k, stride), tio.same_padding(w, k, stride))
    ho = (h + sum(pads[0]) - k) // stride + 1
    assert (plan.ho, plan.wo) == (ho, (w + sum(pads[1]) - k) // stride + 1)
    assert (plan.m, plan.n, plan.k) == (b * ho * plan.wo, cout, k * k * cin)
    # the tiles cover M and N, and no tile row or column is wholly idle
    assert (plan.bm, plan.bn) == CONV_TILES[plan.cfg]
    gm, gn = plan.grid
    assert (gm - 1) * plan.bm < plan.m <= gm * plan.bm
    assert (gn - 1) * plan.bn < plan.n <= gn * plan.bn
    # narrow N: the column tile is the smallest of 16 / 32 / 64 that holds
    # Cout (64 past it), and the taller of its two tiles only while that
    # gives every SM a block
    assert plan.bn == next(t for t in (16, 32, 64) if t >= min(cout, 64))
    tall, short = (row for row, col in CONV_TILES if col == plan.bn)
    assert short < tall
    blocks = -(-plan.m // tall) * -(-cout // plan.bn)
    assert plan.bm == (tall if blocks >= sms else short)


@pytest.mark.parametrize("artifact", ["own", "bridged"])
@pytest.mark.parametrize("net", ["smoke"], indirect=True)
def test_int_forward_through_fused_conv_bit_identical(net, artifact,
                                                      monkeypatch):
    """Every convolution through ``ops.int_conv2d`` (the route of the card,
    here its plain version), each block's conv2 carrying its residual add,
    and no standalone residual add: the JAX package's logits."""
    convs = []

    def routed(x, w, b, spec, stride=1, padding="SAME", apply_relu=False,
               residual=None):
        assert padding == "SAME"
        convs.append(residual is not None)
        return tops.int_conv2d(x, w, b, spec, stride=stride,
                               relu=apply_relu, residual=residual)

    def standalone_add(*args, **kw):
        raise AssertionError("the forward called int_residual_add alone")

    monkeypatch.setattr(tio, "int_conv2d", routed)
    monkeypatch.setattr(tio, "int_residual_add", standalone_add)
    q = (net["tq"] if artifact == "own"
         else TR.from_jax_quantized_resnet(net["jq"], device="cpu"))
    logits = TR.resnet_int_forward(q, torch.from_numpy(net["x"]),
                                   net["tcfg"])
    assert np.array_equal(logits.numpy(), net["jlogits"])
    cfg = net["tcfg"]
    assert convs.count(True) == len(cfg.stages) * cfg.blocks_per_stage
    assert len(convs) == len(_convs(cfg, 1))


@pytest.mark.parametrize("n_bits", [7, 6])
def test_int_forward_below_8_bits_bit_identical(n_bits, monkeypatch):
    """Table 4's widths: both packages calibrate at ``n_bits``, then run a
    batch wider than the calibration's (so block outputs pass the
    ``n_bits`` range); every convolution through ``ops.int_conv2d``,
    conv2 carrying the add, which requantizes to 8-bit codes as the
    reference's ``int_residual_add`` does at its default bits: some block
    output lies past the ``n_bits`` range, and the logits are the JAX
    package's."""
    jcfg, tcfg = _cfgs("smoke")
    jp = JR.init_resnet(jcfg, jax.random.PRNGKey(0))
    _perturb_bn(jp, 5)
    tp = TR.from_jax_resnet_params(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    x = np.random.default_rng(1).uniform(
        0, 1, size=(BATCH, jcfg.img_size, jcfg.img_size, 3)).astype(np.float32)
    jq = JR.quantize_resnet(jp, jnp.asarray(x), jcfg, n_bits=n_bits)
    tq = TR.quantize_resnet(tp, torch.from_numpy(x), tcfg, n_bits=n_bits)
    x = np.random.default_rng(3).normal(0.5, 1.0, size=x.shape).astype(
        np.float32)
    want = np.asarray(JR.resnet_int_forward(jq, jnp.asarray(x), jcfg))
    adds = []

    def routed(x, w, b, spec, stride=1, padding="SAME", apply_relu=False,
               residual=None):
        y = tops.int_conv2d(x, w, b, spec, stride=stride, relu=apply_relu,
                            residual=residual)
        if residual is not None:
            adds.append(int(y.max()))
        return y

    monkeypatch.setattr(tio, "int_conv2d", routed)
    logits = TR.resnet_int_forward(tq, torch.from_numpy(x), tcfg)
    assert np.array_equal(logits.numpy(), want)
    assert max(adds) > 2 ** n_bits - 1
