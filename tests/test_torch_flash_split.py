"""K6's split-KV decode on the CPU: the host-side planner and the
split-and-combine arithmetic.

* ``plan_decode_splits`` (the chunks K6's blocks take, planned for the
  cache's rows): over caches of 1 to 65536 rows, batch {1, 4, 8} and KV
  heads {1, 8}, the chunks cover the rows exactly once, none is empty,
  there is one split below 64 rows, and chunks are whole multiples of a
  block's 128-row pass;
* ``ref.flash_decode_split_ref`` (the kernel's partials (m, l, acc) per
  chunk of the cache, the chunks past ``pos`` empty, then the combine
  pass, in plain PyTorch) against the unsplit ``ref.flash_decode_ref`` and
  the JAX package's ``ops.flash_decode`` with its Pallas body interpreted,
  in fp32 within 2e-5 (fp32 sums in other orders), at positions on and
  beside split boundaries, over an int8 and a float cache.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # the tier-1 container ships no hypothesis
    from tests._hyp_stub import given, settings, st

from repro.core.qscheme import quant as jquant  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    SPLIT_ROW_ALIGN, plan_decode_splits)

jnp = jax.numpy
NKV = 4


@settings(max_examples=200, deadline=None)
@given(pos=st.integers(0, 65535), batch=st.sampled_from([1, 4, 8]),
       kv_heads=st.sampled_from([1, 8]))
def test_plan_covers_rows_once_without_empty_split(pos, batch, kv_heads):
    # a cache of pos + 1 rows
    splits, chunk = plan_decode_splits(pos + 1, batch, kv_heads)
    assert splits >= 1 and chunk % SPLIT_ROW_ALIGN == 0
    bounds = [(i * chunk, min((i + 1) * chunk, pos + 1))
              for i in range(splits)]
    assert all(lo < hi for lo, hi in bounds), bounds          # none empty
    assert bounds[0][0] == 0 and bounds[-1][1] == pos + 1
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    if pos < 64:
        assert splits == 1


@pytest.mark.parametrize("pos,batch,kv_heads,want", [
    (0, 4, 8, 1), (63, 4, 8, 1), (255, 4, 8, 1), (256, 4, 8, 2),
    (32767, 4, 8, 32), (65535, 1, 1, 256)])
def test_plan_split_counts(pos, batch, kv_heads, want):
    """The serving shape's long cache fills the card (32 splits x 32
    (batch, KV head) pairs = 1024 blocks on 132 SMs); short caches take
    one split and no combine pass (caches of pos + 1 rows)."""
    assert plan_decode_splits(pos + 1, batch, kv_heads)[0] == want


def _cache(seed, b, s_max, h, kvh, d, int8_kv):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s_max, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, s_max, kvh, d)).astype(np.float32)
    if int8_kv:
        k = np.array(jquant(jnp.asarray(k), NKV, 8))
        v = np.array(jquant(jnp.asarray(v), NKV, 8))
    return q, k, v


# chunk 128: positions at the end of a split (127, 383), one and two rows
# into the next (128, 129, 384, 385), the first row and the last
@pytest.mark.parametrize("pos", [0, 127, 128, 129, 383, 384, 385, 511])
@pytest.mark.parametrize("int8_kv", [False, True])
def test_split_combine_matches_unsplit_and_pallas(pos, int8_kv):
    b, s_max, h, kvh, d = 2, 512, 8, 2, 128
    q, k, v = _cache(100 + pos, b, s_max, h, kvh, d, int8_kv)
    nkv = NKV if int8_kv else None
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = ref.flash_decode_split_ref(tq, tk, tv, pos=pos, chunk=128,
                                     kv_frac_bits=nkv)
    plain = ref.flash_decode_ref(tq, tk, tv, pos=pos, kv_frac_bits=nkv)
    want = jops.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             pos=jnp.asarray(pos, jnp.int32),
                             kv_frac_bits=nkv)
    assert got.shape == plain.shape == want.shape == (b, 1, h, d)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("pos", [255, 256, 257, 1023, 1024, 1025, 4095])
@pytest.mark.parametrize("int8_kv", [False, True])
def test_split_combine_at_planned_chunks(pos, int8_kv):
    """The planner's own chunks for a (2, KVH 2) batch, where positions
    from 256 rows on split, held against the unsplit plain version."""
    b, h, kvh, d = 2, 4, 2, 64
    splits, chunk = plan_decode_splits(pos + 1, b, kvh)
    assert splits == -(-(pos + 1) // chunk) and (pos < 256) == (splits == 1)
    q, k, v = (torch.from_numpy(a) for a in _cache(pos, b, pos + 1, h, kvh,
                                                    d, int8_kv))
    nkv = NKV if int8_kv else None
    got = ref.flash_decode_split_ref(q, k, v, pos=pos, chunk=chunk,
                                     kv_frac_bits=nkv)
    want = ref.flash_decode_ref(q, k, v, pos=pos, kv_frac_bits=nkv)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                               rtol=2e-5)
