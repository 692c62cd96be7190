"""Differential tests: the ResNet path's integer ops in the port against
the JAX package, on the same numpy inputs, bit for bit.

* K3 ``quantize``: ``repro_torch.kernels.ref.quantize_ref`` (the plain
  version behind ``ops.quantize_act`` on CPU tensors) against
  ``repro.kernels.ref.quantize_ref``, the Pallas body run in interpret
  mode (``repro.kernels.ops.quantize_act``) and ``qscheme.quant``: .5 ties
  on each grid, clip edges, signed and unsigned, bits 6/7/8 and > 8,
  fp32 and bf16 inputs.
* K7 ``residual_requant``: the plain version against the JAX oracle and
  the interpreted Pallas body (the TPU kernel's wrapping left shift), and
  ``integer_ops.int_residual_add`` (and the plain version with
  ``saturate=True``) against the JAX ``int_residual_add`` (its saturating
  ``shift_requant``), over every operand dtype pair, ReLU on and off, and
  a negative requant shift whose int32 sum overflows, where the two
  semantics differ.
* ``int_conv2d`` (``integer_ops`` and ``ops``, whose CPU path is the
  convolution kernel's plain version: an im2col gather + the K2 plain
  version) against the JAX ``int_conv2d`` (an XLA int32
  convolution): kernel 1 and 3, stride 1 and 2 (XLA's "SAME" padding),
  odd and even sizes, int8 and uint8 inputs, both bias-shift signs, ReLU
  on and off.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.core import integer_ops as jio  # noqa: E402
from repro.core import qscheme as jqs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import integer_ops as tio  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

jnp = jax.numpy


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


# --- K3 ---------------------------------------------------------------------

def _quant_inputs(n, bits, unsigned, rows=16, cols=256):
    """Values on every kind of boundary of the 2^-n grid: exact .5 ties of
    both signs, one fp32 ulp either side of a tie, the clip edges and
    beyond, and random values spanning the range."""
    rng = np.random.default_rng(100 + 7 * n + bits + unsigned)
    lo, hi = jqs.int_bounds(bits, unsigned)
    scale = 2.0 ** -n
    x = rng.uniform(2 * lo - 4, 2 * hi + 4, size=(rows, cols)) * scale
    k = rng.integers(lo - 3, hi + 3, size=rows * cols // 4)
    ties = (k + 0.5) * scale
    special = np.concatenate([
        ties, np.nextafter(ties.astype(np.float32), np.float32(np.inf)),
        np.nextafter(ties.astype(np.float32), np.float32(-np.inf)),
        np.asarray([lo, hi, lo - 0.5, hi + 0.5, lo - 0.51, hi + 0.49, 0.0,
                    -0.0, 0.5, -0.5, 0.49999997, -0.49999997]) * scale])
    x = x.reshape(-1).astype(np.float32)
    x[:special.size] = special.astype(np.float32)
    return x.reshape(rows, cols)


@pytest.mark.parametrize("n", [-2, 0, 3, 7])
@pytest.mark.parametrize("bits", [6, 7, 8, 12])
@pytest.mark.parametrize("unsigned", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_bit_exact(n, bits, unsigned, dtype):
    xj = jnp.asarray(_quant_inputs(n, bits, unsigned)).astype(dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    want = jref.quantize_ref(xj, n=n, bits=bits, unsigned=unsigned)
    got = tref.quantize_ref(xt, n=n, bits=bits, unsigned=unsigned)
    _same(got, want)
    _same(tops.quantize_act(xt, n, bits, unsigned), want)
    # the Pallas body (interpreted) and the path's jnp quant agree
    assert np.array_equal(np.asarray(jops.quantize_act(xj, n, bits,
                                                       unsigned)),
                          np.asarray(want))
    assert np.array_equal(
        np.asarray(jqs.quant(xj, n, bits, unsigned)).astype(np.int64),
        np.asarray(want).astype(np.int64))


# --- K7 ---------------------------------------------------------------------

DTYPES = {"int8": (np.int8, -128, 128), "uint8": (np.uint8, 0, 256)}
# (n_a, n_b, n_o): the path's grids (requant shift >= 0), a negative
# requant shift inside int32, and one whose shifted sum overflows int32
GRIDS = [(5, 3, 4), (3, 5, 1), (4, 4, 6), (0, 20, 30)]


def _add_operands(da, db, seed, shape=(16, 256)):
    rng = np.random.default_rng(seed)
    ta, la, ha = DTYPES[da]
    tb, lb, hb = DTYPES[db]
    a = rng.integers(la, ha, size=shape).astype(ta)
    b = rng.integers(lb, hb, size=shape).astype(tb)
    a.flat[:4] = [la, ha - 1, 0, ha - 1]
    b.flat[:4] = [lb, hb - 1, hb - 1, 0]
    return a, b


@pytest.mark.parametrize("da", ["int8", "uint8"])
@pytest.mark.parametrize("db", ["int8", "uint8"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: "-".join(map(str, g)))
def test_residual_requant_bit_exact(da, db, relu, grid):
    n_a, n_b, n_o = grid
    a, b = _add_operands(da, db, sum(grid) + 2 * relu)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    kw = dict(n_a=n_a, n_b=n_b, n_o=n_o, relu=relu)
    # K7's contract: the TPU kernel's wrapping left shift
    wrap = jref.residual_requant_ref(jnp.asarray(a), jnp.asarray(b), **kw)
    _same(tref.residual_requant_ref(ta, tb, **kw), wrap)
    _same(tops.residual_requant(ta, tb, **kw), wrap)
    assert np.array_equal(np.asarray(jops.residual_requant(
        jnp.asarray(a), jnp.asarray(b), **kw)), np.asarray(wrap))
    # the path's op: shift_requant's saturating left shift
    sat = jio.int_residual_add(jnp.asarray(a).astype(jnp.int32), n_a,
                               jnp.asarray(b).astype(jnp.int32), n_b, n_o,
                               apply_relu=relu)
    _same(tio.int_residual_add(ta, n_a, tb, n_b, n_o, apply_relu=relu), sat)
    _same(tref.residual_requant_ref(ta, tb, saturate=True, **kw), sat)
    _same(tops.residual_requant(ta, tb, saturate=True, **kw), sat)
    if grid == (0, 20, 30):
        # the int32 sum overflows under the left shift: the two differ
        assert not np.array_equal(np.asarray(wrap), np.asarray(sat))


# --- int_conv2d -------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("size", [7, 8])
@pytest.mark.parametrize("x_dtype", ["int8", "uint8"])
@pytest.mark.parametrize("n_b", [3, 13], ids=["bias<<", "bias>>"])
@pytest.mark.parametrize("relu", [False, True])
def test_int_conv2d_bit_exact(k, stride, size, x_dtype, n_b, relu):
    rng = np.random.default_rng(k + 3 * stride + size + n_b + relu)
    cin, cout = 5, 6
    t, lo, hi = DTYPES[x_dtype]
    x = rng.integers(lo, hi, size=(2, size, size, cin)).astype(t)
    w = rng.integers(-128, 128, size=(k, k, cin, cout)).astype(np.int8)
    b = rng.integers(-128, 128, size=(cout,)).astype(np.int8)
    spec = dict(n_x=4, n_w=5, n_b=n_b, n_o=2, out_unsigned=relu)
    assert (spec["n_x"] + spec["n_w"] - n_b > 0) == (n_b == 3)
    want = jio.int_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                          jio.LinearQuantSpec(**spec), stride=stride,
                          apply_relu=relu)
    tx, tw, tb = (torch.from_numpy(v) for v in (x, w, b))
    tspec = tio.LinearQuantSpec(**spec)
    _same(tio.int_conv2d(tx, tw, tb, tspec, stride=stride, apply_relu=relu),
          want)
    _same(tops.int_conv2d(tx, tw, tb, tspec, stride=stride, relu=relu), want)


@pytest.mark.parametrize("size,k,stride,want", [
    (32, 3, 2, (0, 1)), (32, 1, 2, (0, 0)), (32, 3, 1, (1, 1)),
    (7, 3, 2, (1, 1)), (16, 1, 1, (0, 0))])
def test_same_padding_is_xlas(size, k, stride, want):
    """XLA's "SAME" rule, not symmetric ``padding=k // 2``: a stride-2
    3x3 convolution on an even size pads (0, 1)."""
    assert tio.same_padding(size, k, stride) == want


def test_cuda_paths_take_no_plain_fallback(monkeypatch):
    """On a CUDA tensor the wrappers reach the kernel binding (here a
    stand-in that records the call) and count the launch; a convolution,
    with or without the residual epilogue, reaches the convolution
    kernel's binding, never K2's over an im2col gather."""
    calls = []

    def fake(name):
        def f(*args, **kw):
            calls.append(name)
            raise RuntimeError(f"{name} reached")
        return f

    for mod, name in ((tops, "quantize_multi_cuda"),
                      (tops, "residual_requant_cuda"),
                      (tops, "int8_matmul_cuda"),
                      (tops, "int_conv_cuda")):
        monkeypatch.setattr(mod, name, fake(name))
    monkeypatch.setattr(tops, "_on_cuda", lambda t, what: True)
    x = torch.zeros((2, 4, 4, 3))
    with pytest.raises(RuntimeError, match="quantize_multi_cuda reached"):
        tops.quantize_act(x, 3)
    codes = torch.zeros((2, 4, 4, 3), dtype=torch.int8)
    with pytest.raises(RuntimeError, match="residual_requant_cuda reached"):
        tops.residual_requant(codes, codes, n_a=1, n_b=2, n_o=3)
    w = torch.zeros((3, 3, 3, 4), dtype=torch.int8)
    spec = tio.LinearQuantSpec(1, 2, 3, 4)
    with pytest.raises(RuntimeError, match="int_conv_cuda reached"):
        tops.int_conv2d(codes, w, None, spec)
    shortcut = torch.zeros((2, 4, 4, 4), dtype=torch.uint8)
    with pytest.raises(RuntimeError, match="int_conv_cuda reached"):
        tops.int_conv2d(codes, w, None, spec, residual=(shortcut, 4, 3, 5))
    assert calls == ["quantize_multi_cuda", "residual_requant_cuda",
                     "int_conv_cuda", "int_conv_cuda"]
