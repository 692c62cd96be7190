"""K2's tensor-core launch on the CPU: the host-side planner and the
split-K arithmetic.

* ``plan_int8_matmul`` (tile and K splits, from the shapes alone): the
  block tiles cover every output once, one block row covers every stream
  row up to 128 rows, the splits partition K into nonempty whole pipeline
  steps, shapes the tensor-core kernel does not take go to the dp4a tile,
  and the serving shapes get the splits that fill the card;
* ``ref.int8_matmul_split_ref`` (per-split int32 partials, added, then one
  epilogue) bit-exact against the unsplit ``ref.int8_matmul_ref`` and the
  JAX package's ``ops.int8_matmul`` (its Pallas body interpreted where the
  JAX wrapper takes it, ``int_linear`` for uint8 activations), over odd K
  and N, uint8 activations, both ``bias_shift`` signs and a negative
  requant shift; tolerance 0 (integer sums are exact in any order).
"""
import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")
import torch  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # the tier-1 container ships no hypothesis
    from tests._hyp_stub import given, settings, st

from repro.core.integer_ops import LinearQuantSpec as JSpec  # noqa: E402
from repro.core.integer_ops import int_linear  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core.integer_ops import LinearQuantSpec as TSpec  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.int8_matmul import (  # noqa: E402
    DP4A_TILE, K_STEP, MMA_TILES, plan_int8_matmul)

SERVING = {(2048, 2048): 8, (2048, 1024): 8, (2048, 6144): 6,
           (6144, 2048): 16, (2048, 151936): 1}


def _k_ranges(plan, k):
    return [(i * plan.k_chunk, min(k, (i + 1) * plan.k_chunk))
            for i in range(plan.splits)]


@settings(max_examples=300, deadline=None)
@given(m=st.integers(1, 300000), k=st.integers(1, 8192),
       n=st.integers(1, 160000), aligned=st.booleans())
def test_plan_tiles_cover_outputs_and_splits_partition_k(m, k, n, aligned):
    plan = plan_int8_matmul(m, k, n, aligned=aligned)
    mma = k % 16 == 0 and n % 8 == 0 and aligned
    assert (plan.cfg >= 0) == mma
    assert (plan.bm, plan.bn) == (MMA_TILES[plan.cfg] if mma else DP4A_TILE)
    # block (x, y) covers rows [bm y, bm y + bm) and columns [bn x, ...):
    # the grid's tiles cover each output exactly once
    rows = np.zeros(m, np.int64)
    cols = np.zeros(n, np.int64)
    for y in range(-(-m // plan.bm)):
        rows[y * plan.bm:(y + 1) * plan.bm] += 1
    for x in range(-(-n // plan.bn)):
        cols[x * plan.bn:(x + 1) * plan.bn] += 1
    assert (rows == 1).all() and (cols == 1).all()
    if mma and m <= 128:
        assert plan.bm >= m                # the weights are read once
    bounds = _k_ranges(plan, k)
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    assert all(lo < hi for lo, hi in bounds)                 # none empty
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    if plan.splits > 1:
        assert mma and m <= 128 and plan.k_chunk % K_STEP == 0


@pytest.mark.parametrize("k,n", list(SERVING))
@pytest.mark.parametrize("m", [1, 24, 128])
def test_plan_serving_shapes(m, k, n):
    """At the engine's 24-row bucket the narrow projections split K so
    the grid fills the card; the LM head needs no split; at 128 rows the
    int32 partials are held to half the weight bytes (two splits)."""
    plan = plan_int8_matmul(m, k, n)
    assert plan.cfg >= 0 and plan.bm >= m and plan.bn == 128
    if m == 24:
        assert plan.splits == SERVING[(k, n)]
    if m <= 32 and n < 100000:
        assert -(-n // plan.bn) * plan.splits >= 64
    if plan.splits > 1:        # partials (splits x bm x n int32) <= k n / 2
        assert plan.splits * 8 * plan.bm <= k


def _ref_kw(spec_kw, relu):
    spec = TSpec(**spec_kw)
    unsigned = relu and spec.out_unsigned
    kw = dict(shift=spec.requant_shift, bias_shift=spec.bias_shift,
              relu=relu, lo=0 if unsigned else -128,
              hi=255 if unsigned else 127,
              out_dtype=torch.uint8 if unsigned else torch.int8)
    return kw


@pytest.mark.parametrize("m,k,n", [(24, 2048, 256), (7, 300, 130),
                                   (150, 600, 640), (33, 144, 16),
                                   (5, 27, 10)])
@pytest.mark.parametrize("x_dtype", ["int8", "uint8"])
@pytest.mark.parametrize("spec_kw,relu", [
    (dict(n_x=4, n_w=8, n_b=7, n_o=4), False),                  # bias <<
    (dict(n_x=2, n_w=3, n_b=9, n_o=4, out_unsigned=True), True),  # bias >>
    (dict(n_x=0, n_w=1, n_b=1, n_o=4), False),                  # shift < 0
], ids=["bias<<", "bias>>-relu", "shift<0"])
def test_split_ref_bit_exact(m, k, n, x_dtype, spec_kw, relu):
    rng = np.random.default_rng(m + k + n)
    lo, hi = (0, 256) if x_dtype == "uint8" else (-128, 128)
    x = rng.integers(lo, hi, size=(m, k)).astype(x_dtype)
    w = rng.integers(-128, 128, size=(k, n)).astype(np.int8)
    b = rng.integers(-128, 128, size=(n,)).astype(np.int8)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    kw = _ref_kw(spec_kw, relu)
    want = ref.int8_matmul_ref(tx, tw, tb, **kw)
    plan = plan_int8_matmul(m, k, n)
    for chunk in {plan.k_chunk, K_STEP, 16}:
        got = ref.int8_matmul_split_ref(tx, tw, tb, k_chunk=chunk, **kw)
        assert got.dtype == want.dtype
        assert torch.equal(got, want), chunk
    jspec = JSpec(**spec_kw)
    if x_dtype == "int8":
        jax_out = jops.int8_matmul(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b), jspec, relu=relu,
                                   force_kernel=True)
    else:
        jax_out = int_linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             jspec, apply_relu=relu)
    assert np.array_equal(want.numpy(), np.asarray(jax_out))
