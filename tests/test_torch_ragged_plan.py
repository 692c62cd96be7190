"""K1's work list on the CPU: the host-side planner and the
split-and-combine arithmetic.

* ``plan_ragged_work`` (the items K1's blocks take): over random mixed
  steps (prefill chunks, decode rows, padding slots, contexts up to
  3000 rows) and GQA groups {1, 2, 3, 4, 16}, every (sequence, token) row — and with it each of its group's heads — is in exactly one
  q tile of at most 16 (token, head) rows; a tile seeing at most
  SPLIT_ROWS rows is one item over [0, its visible rows), a longer one is cut
  into chunks that partition that range, none empty, whose partial slots
  one combine entry lists (at most MAX_SPLITS of them); the items come
  longest kv range first;
* ``ref.ragged_attention_split_ref`` (each item's partials, then the
  combine, in plain PyTorch) against the unsplit ``ref.ragged_attention_ref``
  and the JAX package's ``ops.ragged_attention`` with its Pallas body
  interpreted, in fp32 within atol = rtol = 2e-5 (fp32 sums in other
  orders), at kv lengths on and beside split boundaries, over an int8 and
  a float pool; padding rows exactly 0.
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
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.ragged_flash import (  # noqa: E402
    MAX_SPLITS, ROWS_PER_ITEM, SPLIT_ROWS, STAGE_ROWS, plan_from_descriptors,
    plan_ragged_work)

jnp = jax.numpy
NKV, DK, BS = 4, 128, 128
TOL = dict(atol=2e-5, rtol=2e-5)
# (q_len, kv_len): visible rows on and one past the 512-row split
# threshold, past and on its multiples, a prefill chunk across it, a fresh
# prefill, a one-row context
ITEMS = ((1, 512), (1, 513), (2, 1025), (16, 527), (1, 1024), (3, 1030),
         (16, 16), (1, 1))
N_PAD_ROWS = 6


def _descriptors(rng, n_seq, n_pad):
    q_len = rng.integers(0, 40, size=n_seq)
    q_len[rng.random(n_seq) < 0.4] = 1                       # decode rows
    kv_len = q_len + rng.integers(0, 3000, size=n_seq)
    q_len = np.concatenate([q_len, np.zeros(n_pad, np.int64)])
    kv_len = np.concatenate([kv_len, np.zeros(n_pad, np.int64)])
    q_start = np.concatenate([[0], np.cumsum(q_len)[:-1]])
    return q_start, q_len, kv_len


@settings(max_examples=100, deadline=None)
@given(seed=st.integers(0, 10**6), n_seq=st.integers(1, 9),
       n_pad=st.integers(0, 2), groups=st.sampled_from([1, 2, 3, 4, 16]))
def test_plan_covers_rows_once_and_splits_partition(seed, n_seq, n_pad,
                                                    groups):
    q_start, q_len, kv_len = _descriptors(np.random.default_rng(seed),
                                          n_seq, n_pad)
    work = plan_ragged_work(q_start, q_len, kv_len, groups=groups)
    table = work.table
    assert table.shape == (work.n_items + work.n_combine, 8)
    items, combines = table[:work.n_items], table[work.n_items:]
    lengths = items[:, 4] - items[:, 3]
    assert (lengths > 0).all() and (np.diff(lengths) <= 0).all()
    tiles = {}
    for s, t0, nt, c0, c1, part, row0, lim0 in items.tolist():
        assert 1 <= nt and nt * groups <= ROWS_PER_ITEM
        assert row0 == q_start[s] + t0 and lim0 == kv_len[s] - q_len[s] + t0
        tiles.setdefault((s, t0, nt), []).append((c0, c1, part))
    covered = {s: np.zeros(int(q_len[s]), np.int64) for s in range(len(q_len))}
    slots = []
    comb = {(s, t0, nt): (first, n) for s, t0, nt, first, n, _, _, _ in
            combines.tolist()}
    assert len(comb) == work.n_combine
    for (s, t0, nt), pieces in tiles.items():
        covered[s][t0:t0 + nt] += 1
        vis = int(kv_len[s] - q_len[s]) + t0 + nt
        assert vis <= kv_len[s]
        pieces.sort()
        assert pieces[0][0] == 0 and pieces[-1][1] == vis
        assert all(a[1] == b[0] for a, b in zip(pieces, pieces[1:]))
        if vis <= SPLIT_ROWS:
            assert pieces == [(0, vis, -1)] and (s, t0, nt) not in comb
        else:
            assert all(c0 % STAGE_ROWS == 0 for c0, _, _ in pieces)
            first, n = comb[(s, t0, nt)]
            assert sorted(p for _, _, p in pieces) == list(
                range(first, first + n))
            slots += [p for _, _, p in pieces]
    assert all((c == 1).all() for c in covered.values())
    assert sorted(slots) == list(range(work.n_parts))
    assert work.max_rows == (lengths.max() if len(lengths) else 0)
    assert work.max_splits == max((n for _, n in comb.values()), default=0)


def test_plan_caps_splits_on_long_contexts():
    """A 1M-row context is cut into MAX_SPLITS chunks, not 2048: the
    combine's weights stay in a block's shared memory."""
    work = plan_ragged_work([0], [1], [1 << 20], groups=2)
    assert work.n_combine == 1 and work.max_splits == MAX_SPLITS
    assert work.max_rows == (1 << 20) // MAX_SPLITS


def test_plan_from_tensors_is_the_host_plan():
    q_start, q_len, kv_len = _descriptors(np.random.default_rng(7), 6, 1)
    want = plan_ragged_work(q_start, q_len, kv_len, groups=2)
    got = plan_from_descriptors(*(torch.from_numpy(a.astype(np.int32))
                                  for a in (q_start, q_len, kv_len)), 2)
    assert np.array_equal(got.table, want.table)
    assert got[1:] == want[1:]


def _build(seed, kvh, groups, kv):
    """ITEMS packed into one stream over a shuffled pool of BS-row blocks,
    padding rows at the end of the stream and a trailing padding slot."""
    rng = np.random.default_rng(seed)
    h = kvh * groups
    ns = len(ITEMS)
    nbmax = -(-max(kl for _, kl in ITEMS) // BS)
    t_real = sum(ql for ql, _ in ITEMS)
    t = t_real + N_PAD_ROWS
    q = rng.normal(size=(t, h, DK)).astype(np.float32)
    kf = rng.normal(size=(ns, nbmax * BS, kvh, DK)).astype(np.float32)
    vf = rng.normal(size=(ns, nbmax * BS, kvh, DK)).astype(np.float32)
    if kv == "int8":
        kc = np.asarray(jquant(jnp.asarray(kf), NKV, 8))
        vc = np.asarray(jquant(jnp.asarray(vf), NKV, 8))
        nkv = NKV
    else:
        kc, vc, nkv = kf, vf, None
    nb = 1 + ns * nbmax
    bt = np.zeros((ns + 1, nbmax), np.int32)                # slot ns: pad
    bt[:ns] = rng.permutation(np.arange(1, nb)).reshape(ns, nbmax)
    kp = np.zeros((nb, BS, kvh, DK), kc.dtype)
    vp = np.zeros_like(kp)
    for s in range(ns):
        for i in range(nbmax):
            kp[bt[s, i]] = kc[s, i * BS:(i + 1) * BS]
            vp[bt[s, i]] = vc[s, i * BS:(i + 1) * BS]
    q_len = np.asarray([ql for ql, _ in ITEMS] + [0], np.int32)
    kv_len = np.asarray([kl for _, kl in ITEMS] + [0], np.int32)
    q_start = np.concatenate([[0], np.cumsum(q_len[:ns])]).astype(np.int32)
    q_start[ns] = t
    return (q, kp, vp, bt, q_start, q_len, kv_len), nkv, t_real


@pytest.mark.parametrize("kv", ["int8", "fp32"])
@pytest.mark.parametrize("groups", [1, 2, 4, 16])
def test_split_ref_matches_unsplit_and_pallas(groups, kv):
    args, nkv, t_real = _build(groups, 2, groups, kv)
    targs = [torch.from_numpy(a) for a in args]
    work = plan_ragged_work(*args[4:7], groups=groups)
    assert work.n_combine > 0
    got = ref.ragged_attention_split_ref(*targs, work=work, kv_frac_bits=nkv)
    want = ref.ragged_attention_ref(*targs, kv_frac_bits=nkv)
    pallas = jops.ragged_attention(*(jnp.asarray(a) for a in args),
                                   kv_frac_bits=nkv, tq_max=32)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    assert torch.count_nonzero(got[t_real:]) == 0        # padding rows
    # on CPU tensors the wrapper takes the plain version, plan or none
    same = tops.ragged_attention(*targs, kv_frac_bits=nkv, work=work)
    assert torch.equal(same, want)
