"""Differential tests: the port's quantization math against the JAX
package's, bit for bit (``repro_torch.core`` vs ``repro.core``).

Inputs are made from a seed with numpy and handed to both packages.
Covers exact .5 ties (round half AWAY from zero, not torch.round's half
to even), both bias-shift signs, fused ReLU with unsigned output, and
negative requant shifts with accumulators at and past 2^31 / 2^|s|."""
import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")
import torch  # noqa: E402

from repro.core import integer_ops as jio  # noqa: E402
from repro.core import qscheme as jq  # noqa: E402
from repro_torch.core import integer_ops as tio  # noqa: E402
from repro_torch.core import qscheme as tq  # noqa: E402


def _same(t: torch.Tensor, j) -> None:
    a = np.asarray(j)
    assert t.dtype == {np.dtype(np.int8): torch.int8,
                       np.dtype(np.uint8): torch.uint8,
                       np.dtype(np.int32): torch.int32,
                       np.dtype(np.float32): torch.float32}[a.dtype]
    assert np.array_equal(t.numpy(), a)


def _floats(seed, shape=(64, 96)):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32) * 6
    # exact ties at every grid used below: (k + 0.5) * 2^-n for n in 0..6
    ties = ((rng.integers(-200, 200, size=shape) + 0.5)
            / 2.0 ** rng.integers(0, 7, size=shape)).astype(np.float32)
    return np.where(rng.random(shape) < 0.3, ties, x)


def test_round_half_away_ties():
    x = np.asarray([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.49999997], np.float32)
    got = tq.round_half_away(torch.from_numpy(x))
    _same(got, jq.round_half_away(jnp.asarray(x)))
    assert got.tolist() == [-3.0, -2.0, -1.0, 1.0, 2.0, 3.0, 1.0]


@pytest.mark.parametrize("n", [-2, 0, 1, 4, 6])
@pytest.mark.parametrize("unsigned", [False, True])
def test_quant_dequant_bit_exact(n, unsigned):
    x = _floats(n + 10)
    q = tq.quant(torch.from_numpy(x), n, 8, unsigned)
    _same(q, jq.quant(jnp.asarray(x), n, 8, unsigned))
    _same(tq.dequant(q, n), jq.dequant(jnp.asarray(q.numpy()), n))


def test_quant_bf16_input():
    x = _floats(3)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    jx = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    _same(tq.quant(xb, 4), jq.quant(jx, 4))
    got = tq.dequant(tq.quant(xb, 4), 4, out_dtype=torch.bfloat16)
    want = jq.dequant(jq.quant(jx, 4), 4, out_dtype=jnp.bfloat16)
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("shift", [-5, -3, -1, 0, 1, 7, 12, 31])
@pytest.mark.parametrize("unsigned", [False, True])
def test_shift_requant_bit_exact(shift, unsigned):
    rng = np.random.default_rng(shift + 40)
    acc = rng.integers(-2**31, 2**31, size=4096, dtype=np.int64)
    if shift < 0:
        # straddle the saturation bound (2^31 - 1) >> |s| on both signs
        b = (2**31 - 1) >> -shift
        near = b + rng.integers(-3, 4, size=4096)
        acc = np.where(rng.random(4096) < 0.5, near, -near)
    acc = np.concatenate([acc, [0, 1, -1, 2**31 - 1, -2**31]]).astype(np.int32)
    for bits in (8,) if unsigned else (8, 32):     # 32: bias alignment
        got = tq.shift_requant(torch.from_numpy(acc), shift, bits, unsigned)
        _same(got, jq.shift_requant(jnp.asarray(acc), shift, bits, unsigned))


@pytest.mark.parametrize("bias_shift", [-9, -4, -1, 0, 3, 11])
def test_bias_align_bit_exact(bias_shift):
    b = np.random.default_rng(7).integers(-128, 128, size=512).astype(np.int8)
    _same(tio.bias_align(torch.from_numpy(b), bias_shift),
          jio.bias_align(jnp.asarray(b), bias_shift))


@pytest.mark.parametrize("n_b", [3, 9, 14])       # bias shift +, -, -
@pytest.mark.parametrize("relu,unsigned", [(False, False), (True, False),
                                           (True, True)])
@pytest.mark.parametrize("n_o", [4, 16])          # requant shift +, -
def test_int_linear_bit_exact(n_b, relu, unsigned, n_o):
    rng = np.random.default_rng(n_b * 100 + n_o)
    x = rng.integers(-128, 128, size=(3, 7, 200)).astype(np.int8)
    w = rng.integers(-128, 128, size=(200, 130)).astype(np.int8)
    b = rng.integers(-128, 128, size=(130,)).astype(np.int8)
    spec_t = tio.LinearQuantSpec(n_x=4, n_w=6, n_b=n_b, n_o=n_o,
                                 out_unsigned=unsigned)
    spec_j = jio.LinearQuantSpec(n_x=4, n_w=6, n_b=n_b, n_o=n_o,
                                 out_unsigned=unsigned)
    got = tio.int_linear(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b), spec_t, apply_relu=relu)
    _same(got, jio.int_linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              spec_j, apply_relu=relu))


def test_int_linear_negative_shift_saturates():
    """Accumulators past 2^31 / 2^|s| must saturate, not wrap through the
    clip: K = 16384 rows of +-127 x 127 codes reach |acc| ~ 2.6e8 > 2^27."""
    k = 16384
    x = np.full((2, k), 127, np.int8)
    x[1] = -127
    w = np.full((k, 3), 127, np.int8)
    spec_t = tio.LinearQuantSpec(n_x=0, n_w=0, n_b=0, n_o=4)   # shift -4
    spec_j = jio.LinearQuantSpec(n_x=0, n_w=0, n_b=0, n_o=4)
    got = tio.int_linear(torch.from_numpy(x), torch.from_numpy(w), None,
                         spec_t)
    _same(got, jio.int_linear(jnp.asarray(x), jnp.asarray(w), None, spec_j))
    assert got[0].tolist() == [127] * 3 and got[1].tolist() == [-128] * 3
