"""K4's work list on the CPU: the host-side planner, the split-and-combine
arithmetic, and the legacy engine's plan.

* ``plan_paged_work`` (the items K4's blocks take): over random (B, C)
  position grids made of consecutive runs, repeated padded rows and the
  speculative step's trash column, GQA groups {1, 2, 3, 4, 16}: every
  (slot, token) row is in exactly one item of at most 16 (token, head)
  rows, whose positions rise by 0 or 1; an item sees [0, its largest
  position + 1) clipped to the table, at most SPLIT_ROWS rows as one item
  and past that as chunks that partition the range, none empty, each
  starting on a STAGE_ROWS multiple, at most MAX_SPLITS of them, listed by
  one combine entry; the items come longest kv range first; no row's range
  is widened by more than its item's other tokens, and a padded verify
  row never shares an item with a real row that is not its predecessor
  position; the plan from a tensor is the host plan.
* ``ref.paged_attention_split_ref`` (each item's partials, then the
  combine, in plain PyTorch) against the unsplit ``ref.paged_attention_ref``
  and the JAX package's ``ops.paged_attention`` (its gather path, and its
  Pallas body interpreted at C = 1, bs = D = 128), in fp32 within atol =
  rtol = 1e-5 (fp32 sums in other orders): C 1/4/16, GQA 1/2/4, int8 and
  fp32 pools, head dims 12/64/100/128, positions before, at and after the
  512-row split edge, a three-chunk range, the speculative table with its
  trash column and padded rows, a padded slot, and rows on both sides of a
  planned chunk edge (a partial that sees no row).
* The legacy engine on the CPU, its device check stubbed to plan: every
  dispatch hands ``paged_step`` the plan ``plan_paged_work`` builds from
  that dispatch's positions, and the tokens are those of an engine that
  plans nothing.
* The kernel build: a library's name covers the header K1 and K4 share.
"""
import shutil
from pathlib import Path

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
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    paged_plan_from_positions, plan_paged_work)
from repro_torch.kernels.ragged_flash import (  # noqa: E402
    MAX_SPLITS, ROWS_PER_ITEM, SPLIT_ROWS, STAGE_ROWS)
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.kv_pool import TRASH_BLOCK  # noqa: E402

jnp = jax.numpy
NKV = 4
TOL = dict(atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

def _positions(rng, b, c, nbmax, bs, spec):
    """(B, C) positions as the legacy engine makes them: a run of
    consecutive positions a slot (a decode row, a prefill chunk, a verify
    chunk), with ``spec`` the run's tail padded at ``nbmax * bs`` and some
    slots wholly padded; or a padded slot at position 0."""
    pos = np.zeros((b, c), np.int64)
    for s in range(b):
        if rng.random() < 0.15:
            pos[s] = nbmax * bs if spec else 0
            continue
        n_real = int(rng.integers(1, c + 1)) if spec else c
        start = int(rng.integers(0, nbmax * bs - n_real + 1))
        pos[s, :n_real] = start + np.arange(n_real)
        pos[s, n_real:] = nbmax * bs
    return pos


def _check_plan(pos, work, width, bs, groups):
    b, c = pos.shape
    table = work.table
    assert table.shape == (work.n_items + work.n_combine, 8)
    items, combines = table[:work.n_items], table[work.n_items:]
    lengths = items[:, 4] - items[:, 3]
    assert (lengths > 0).all() and (np.diff(lengths) <= 0).all()
    pieces, covered = {}, np.zeros((b, c), np.int64)
    for slot, t0, nt, c0, c1, part, row0, lim0 in items.tolist():
        assert 1 <= nt and nt * groups <= ROWS_PER_ITEM
        assert row0 == slot * c + t0 and lim0 == 0
        pieces.setdefault((slot, t0, nt), []).append((c0, c1, part))
    comb = {(s, t0, nt): (first, n) for s, t0, nt, first, n, _, _, _ in
            combines.tolist()}
    assert len(comb) == work.n_combine
    slots = []
    for (slot, t0, nt), ps in pieces.items():
        covered[slot, t0:t0 + nt] += 1
        p = pos[slot, t0:t0 + nt]
        assert set(np.diff(p).tolist()) <= {0, 1}
        vis = min(int(p.max()) + 1, width * bs)
        # no row of the item sees fewer than vis - (nt - 1) rows of it
        assert vis <= min(int(p.min()) + 1, width * bs) + nt - 1
        ps.sort()
        assert ps[0][0] == 0 and ps[-1][1] == vis
        assert all(x[1] == y[0] for x, y in zip(ps, ps[1:]))
        if vis <= SPLIT_ROWS:
            assert ps == [(0, vis, -1)] and (slot, t0, nt) not in comb
        else:
            assert all(c0 % STAGE_ROWS == 0 for c0, _, _ in ps)
            first, n = comb[(slot, t0, nt)]
            assert n == len(ps) <= MAX_SPLITS
            assert sorted(q for _, _, q in ps) == list(range(first, first + n))
            slots += [q for _, _, q in ps]
    assert (covered == 1).all()
    assert sorted(slots) == list(range(work.n_parts))
    assert work.max_rows == lengths.max()
    assert work.max_splits == max((n for _, n in comb.values()), default=0)


@settings(max_examples=100, deadline=None)
@given(seed=st.integers(0, 10**6), b=st.integers(1, 6),
       c=st.sampled_from([1, 2, 4, 5, 16]), spec=st.booleans(),
       groups=st.sampled_from([1, 2, 3, 4, 16]),
       bs=st.sampled_from([16, 128]))
def test_plan_covers_rows_once_and_splits_partition(seed, b, c, spec, groups,
                                                    bs):
    rng = np.random.default_rng(seed)
    nbmax = int(rng.integers(1, 200 if bs == 16 else 30))
    pos = _positions(rng, b, c, nbmax, bs, spec)
    width = nbmax + 1 if spec else nbmax
    work = plan_paged_work(pos, table_width=width, block_size=bs,
                           groups=groups)
    _check_plan(pos, work, width, bs, groups)


def test_padded_verify_rows_do_not_widen_real_rows():
    """The engine's verify step: slot 0 feeds a token at 40 and two
    drafts, slot 1 a token and no draft, slot 2 is empty, slot 3 sits on
    the table's last real row.  Real rows' items end at their own last
    position; the padded rows (at the trash column, nbmax * bs) go in
    items of their own, except behind slot 3's row at nbmax * bs - 1,
    which they extend by the one row a next token would."""
    nbmax, bs, pad = 5, 16, 80
    pos = np.array([[40, 41, 42, pad], [23, pad, pad, pad],
                    [pad, pad, pad, pad], [pad - 1, pad, pad, pad]])
    work = plan_paged_work(pos, table_width=nbmax + 1, block_size=bs,
                           groups=2)
    got = sorted((s, t0, nt, c1) for s, t0, nt, _, c1, *_ in
                 work.table[:work.n_items].tolist())
    assert got == [(0, 0, 3, 43), (0, 3, 1, pad + 1), (1, 0, 1, 24),
                   (1, 1, 3, pad + 1), (2, 0, 4, pad + 1), (3, 0, 4, pad + 1)]
    _check_plan(pos, work, nbmax + 1, bs, 2)


def test_plan_caps_splits_on_long_contexts():
    """A 1M-row cache is cut into MAX_SPLITS chunks, not 2048: the
    combine's weights stay in a block's shared memory."""
    work = plan_paged_work([[(1 << 20) - 1]], table_width=1 << 16,
                           block_size=16, groups=2)
    assert work.n_combine == 1 and work.max_splits == MAX_SPLITS
    assert work.max_rows == (1 << 20) // MAX_SPLITS


def test_plan_rejects_negative_positions():
    with pytest.raises(ValueError, match="positions >= 0"):
        plan_paged_work([[3, -1]], table_width=1, block_size=16, groups=1)


def test_plan_from_tensor_is_the_host_plan():
    rng = np.random.default_rng(7)
    pos = _positions(rng, 5, 4, 40, 16, True)
    want = plan_paged_work(pos, table_width=41, block_size=16, groups=2)
    got = paged_plan_from_positions(torch.from_numpy(pos.astype(np.int32)),
                                    table_width=41, block_size=16, groups=2)
    assert np.array_equal(got.table, want.table)
    assert got[1:] == want[1:]


# ---------------------------------------------------------------------------
# split + combine against the unsplit plain version and JAX
# ---------------------------------------------------------------------------

# each slot's last query position: 511 (512 rows seen: one item), 512
# (513: the first split), 510, 1024 (1025: three chunks); slot 4 padded
LAST = (511, 512, 510, 1024)
NBMAX = 65                     # 1040 rows at bs 16


def _case(seed, c, groups, kv, dk, bs, spec, last=LAST, nbmax=NBMAX):
    """Slots at ``last`` positions (a run of C ending there) over a
    shuffled pool whose tables hold only the blocks each slot's positions
    need, trash after them, and one padded slot (all-trash table, position
    0).  With ``spec`` the tables get one trash column more, slot 0's last
    query and every query of the padded slot sit on it (padded draft
    rows), as the engine's verify step lays them out."""
    rng = np.random.default_rng(seed)
    kvh = 2
    h, b = kvh * groups, len(last) + 1
    nb = 1 + b * nbmax
    q = rng.normal(size=(b, c, h, dk)).astype(np.float32)
    kf = rng.normal(size=(nb, bs, kvh, dk)).astype(np.float32)
    vf = rng.normal(size=(nb, bs, kvh, dk)).astype(np.float32)
    if kv == "int8":
        kp = np.array(jquant(jnp.asarray(kf), NKV, 8))
        vp = np.array(jquant(jnp.asarray(vf), NKV, 8))
    else:
        kp, vp = kf, vf
    perm = rng.permutation(np.arange(1, nb)).astype(np.int32)
    bt = np.full((b, nbmax + 1 if spec else nbmax), TRASH_BLOCK, np.int32)
    pos = np.zeros((b, c), np.int32)
    for s, p in enumerate(last):
        pos[s] = np.maximum(p - (c - 1) + np.arange(c), 0)
        live = p // bs + 1
        bt[s, :live] = perm[s * nbmax:s * nbmax + live]
    if spec:
        pos[0, -1] = pos[b - 1] = nbmax * bs
    return q, kp, vp, bt, pos


def _three_ways(args, nkv, groups):
    """(split plain, unsplit plain, JAX) outputs as numpy."""
    q, kp, vp, bt, pos = args
    targs = [torch.from_numpy(a) for a in args]
    work = plan_paged_work(pos, table_width=bt.shape[1],
                           block_size=kp.shape[1], groups=groups)
    got = ref.paged_attention_split_ref(*targs, work=work, kv_frac_bits=nkv)
    want = ref.paged_attention_ref(*targs, kv_frac_bits=nkv)
    jax_out = jops.paged_attention(*(jnp.asarray(a) for a in args),
                                   kv_frac_bits=nkv)
    assert got.dtype == torch.float32 and got.shape == want.shape
    # on CPU tensors the wrapper takes the plain version, plan or none
    assert torch.equal(tops.paged_attention(*targs, kv_frac_bits=nkv,
                                            work=work), want)
    return work, got.numpy(), want.numpy(), np.asarray(jax_out)


DIMS = (12, 64, 100, 128)
GRID = [(c, g, kv, DIMS[i % len(DIMS)])
        for i, (c, g, kv) in enumerate(
            (c, g, kv) for c in (1, 4, 16) for g in (1, 2, 4)
            for kv in ("int8", "fp32"))]


@pytest.mark.parametrize("c,groups,kv,dk", GRID)
def test_split_ref_matches_unsplit_and_jax(c, groups, kv, dk):
    args = _case(c + 10 * groups + dk, c, groups, kv, dk, 16, spec=c == 4)
    nkv = NKV if kv == "int8" else None
    work, got, want, jax_out = _three_ways(args, nkv, groups)
    assert work.n_combine > 0
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, jax_out, **TOL)


@pytest.mark.parametrize("kv", ["int8", "fp32"])
def test_split_ref_matches_interpreted_pallas(kv):
    """At C = 1, bs = D = 128 the JAX side runs K4's Pallas body in
    interpret mode."""
    args = _case(5, 1, 2, kv, 128, 128, spec=False, last=(511, 512, 127),
                 nbmax=5)
    nkv = NKV if kv == "int8" else None
    work, got, want, jax_out = _three_ways(args, nkv, 2)
    assert work.n_combine == 1
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, jax_out, **TOL)


@pytest.mark.parametrize("kv", ["int8", "fp32"])
def test_split_ref_rows_straddle_a_chunk_edge(kv):
    """One slot of 16 queries ending at 33732: its item's range, 33733
    rows, is cut into 32 chunks of 1088 and a last one of 5 rows, so
    the first 11 queries see nothing of the last chunk (a partial whose m
    is -inf) and the other 5 see part of it."""
    args = _case(9, 16, 1, kv, 64, 16, spec=False, last=(33732,),
                 nbmax=2109)
    nkv = NKV if kv == "int8" else None
    work, got, want, jax_out = _three_ways(args, nkv, 1)
    items = work.table[:work.n_items]
    edge = items[(items[:, 0] == 0), 3].max()      # the last chunk's start
    row_pos = args[4][0]
    assert work.n_combine >= 1 and (row_pos < edge).sum() == 11 \
        and (row_pos >= edge).sum() == 5
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, jax_out, **TOL)


# ---------------------------------------------------------------------------
# the legacy engine plans once per dispatch
# ---------------------------------------------------------------------------

def test_legacy_engine_hands_paged_step_the_host_plan(monkeypatch):
    """With the device check stubbed to plan (as on the card), each
    dispatch of the legacy engine, speculative verify included, passes
    ``paged_step`` the plan of its own positions and table width; the CPU
    path ignores it, so the tokens match an engine that plans nothing."""
    cfg = get_smoke_config("qwen3_1_7b")
    groups = cfg.n_heads // cfg.n_kv_heads
    kw = dict(smoke=True, mode="fp", n_requests=4, n_slots=2, rate=1e9,
              ragged=False, spec_k=2, gen_lens=(6,), prompt_lens=(8, 20),
              device="cpu")
    plain = tserve.serve_engine("qwen3_1_7b", **kw)["outputs"]

    seen = []
    real_init = ServingEngine.__init__

    def init(self, *a, **k):
        real_init(self, *a, **k)
        step = self._paged_fn

        def recording(params, tokens, cache, positions, bt, work=None):
            seen.append((positions.numpy().copy(), bt.shape[1], work))
            return step(params, tokens, cache, positions, bt, work=work)

        self._paged_fn = recording

    monkeypatch.setattr(ServingEngine, "__init__", init)
    monkeypatch.setattr(ServingEngine, "_plans_work", lambda self: True)
    planned = tserve.serve_engine("qwen3_1_7b", **kw)["outputs"]
    assert any(p.shape == (2, 3) for p, _, _ in seen)       # a verify step
    for positions, width, work in seen:
        want = plan_paged_work(positions, table_width=width,
                               block_size=16, groups=groups)
        assert np.array_equal(work.table.numpy(), want.table)
        assert work[1:] == want[1:]
    assert sorted(plain) == sorted(planned)
    assert all(np.array_equal(plain[r], planned[r]) for r in plain)


# ---------------------------------------------------------------------------
# the build sees the shared header
# ---------------------------------------------------------------------------

def test_library_name_follows_the_shared_header(monkeypatch, tmp_path):
    """K1's and K4's libraries are named by a hash that covers the header
    they include, so an edited header is rebuilt, not loaded stale; nvcc
    is pointed at the header's directory."""
    from repro_torch.kernels import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build._lib_path(n) for n in ("ragged_attention",
                                               "paged_attention")}
    header = csrc / "paged_kv_attention.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build._lib_path(n) for n in before}
    assert all(before[n] != after[n] for n in before)
    i = _build.NVCC_FLAGS.index("-I")
    assert _build.NVCC_FLAGS[i + 1] == str(
        Path(_build.__file__).parent.parent / "csrc")
