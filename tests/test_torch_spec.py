"""Differential tests of speculative decoding's host and device halves: the
port's drafters and ``verify_tokens`` against the JAX package's.

* ``NgramDrafter.draft`` proposes the same tokens (and counts the same
  calls, proposals and empty proposals) as JAX's on random histories;
  ``CallableDrafter`` and ``resolve_drafter`` behave alike.
* ``verify_tokens`` on greedy rows gives JAX's ``out`` and ``n_acc``
  exactly on random logits and drafts (some drafts on the argmax chain,
  some off it, every draft count from 0 to K).
* Sampled rows are held in distribution, since the two packages' random
  bits differ: over N = 20000 rows of one (logits, draft) case, the share
  of rows that accept the draft and the share that emit each token as
  their first output must lie within 5 standard errors,
  5 * sqrt(p (1 - p) / N), of the exact values (acceptance probability
  p(d); first-token law p itself, which rejection sampling preserves).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.serving import spec as jspec  # noqa: E402
from repro_torch.serving import spec as tspec  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401


@pytest.mark.parametrize("seed", range(6))
def test_ngram_drafter_matches_jax(seed):
    rng = np.random.default_rng(seed)
    jd, td = jspec.NgramDrafter(), tspec.NgramDrafter()
    for _ in range(40):
        n = int(rng.integers(0, 30))
        hist = rng.integers(0, 4 + seed, size=n).astype(np.int32)
        k = int(rng.integers(0, 5))
        want, got = jd.draft(hist, k), td.draft(hist, k)
        assert got.dtype == np.int32 and np.array_equal(got, want), hist
    for attr in ("calls", "proposed", "empty"):
        assert getattr(td.stats, attr) == getattr(jd.stats, attr)
    assert td.stats.proposed > 0 and td.stats.empty > 0


def test_callable_drafter_and_resolve_match_jax():
    fn = lambda h, k: list(h[-2:]) * 3          # noqa: E731
    jd, td = jspec.CallableDrafter(fn), tspec.CallableDrafter(fn)
    for k in (0, 1, 3, 9):
        h = np.arange(5, dtype=np.int32)
        assert np.array_equal(td.draft(h, k), jd.draft(h, k))
    assert (td.stats.calls, td.stats.proposed, td.stats.empty) \
        == (jd.stats.calls, jd.stats.proposed, jd.stats.empty)
    assert isinstance(tspec.resolve_drafter("ngram"), tspec.NgramDrafter)
    assert tspec.resolve_drafter(td) is td
    with pytest.raises(ValueError, match="unknown drafter"):
        tspec.resolve_drafter("medusa")
    with pytest.raises(TypeError, match="draft"):
        tspec.resolve_drafter(object())


@pytest.mark.parametrize("k", [0, 1, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_verify_tokens_greedy_matches_jax(k, seed):
    rng = np.random.default_rng(seed)
    b, v = 12, 20
    logits = rng.normal(size=(b, k + 1, v)).astype(np.float32)
    chain = logits.argmax(-1)
    tokens = rng.integers(0, v, size=(b, k + 1)).astype(np.int32)
    # half the rows draft along the argmax chain, some breaking off late
    for r in range(0, b, 2):
        tokens[r, 1:] = chain[r, :k]
        if k and r % 4 == 0:
            tokens[r, 1 + int(rng.integers(k))] = (chain[r, 0] + 1) % v
    n_drafts = rng.integers(0, k + 1, size=b).astype(np.int32)
    temps = np.zeros(b, np.float32)
    jo, jn = jspec.verify_tokens(
        jax.numpy.asarray(logits), jax.numpy.asarray(tokens),
        jax.numpy.asarray(n_drafts), jax.random.PRNGKey(0),
        jax.numpy.asarray(temps))
    to, tn = tspec.verify_tokens(
        torch.from_numpy(logits), torch.from_numpy(tokens),
        torch.from_numpy(n_drafts), torch.Generator().manual_seed(0),
        torch.from_numpy(temps))
    assert to.dtype == torch.int32 and tn.dtype == torch.int32
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    if k:
        assert 0 < int(tn.sum()) < int(n_drafts.sum())


def test_verify_tokens_greedy_rows_beside_sampled_rows():
    """A greedy row's result does not depend on sampled rows in its batch
    or on the generator's state."""
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(rng.normal(size=(4, 3, 9)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, 9, size=(4, 3)).astype(np.int32))
    tokens[0, 1:] = logits[0, :2].argmax(-1)
    n_drafts = torch.full((4,), 2, dtype=torch.int32)
    greedy = tspec.verify_tokens(logits, tokens, n_drafts,
                                 torch.Generator().manual_seed(1),
                                 torch.zeros(4))
    mixed = tspec.verify_tokens(logits, tokens, n_drafts,
                                torch.Generator().manual_seed(2),
                                torch.tensor([0.0, 1.0, 0.0, 0.7]))
    for r in (0, 2):
        assert torch.equal(greedy[0][r], mixed[0][r])
        assert int(greedy[1][r]) == int(mixed[1][r])
    assert int(greedy[1][0]) == 2 and greedy[0][0].tolist() == \
        tokens[0, 1:].tolist() + [int(logits[0, 2].argmax())]


N_DRAWS = 20000


def _within(freq, p, n=N_DRAWS):
    return abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / n) + 1e-12


@pytest.mark.parametrize("top_k", [0, 3])
def test_verify_tokens_sampled_in_distribution(top_k):
    v = 6
    logits = np.asarray([[1.0, 0.2, -0.5, 0.8, 0.0, -1.0],
                         [0.3, 0.3, 1.5, -0.2, 0.1, 0.0]], np.float32)
    temp = 0.8
    draft = 3
    scaled = logits / temp
    if top_k:
        cut = np.sort(scaled, axis=-1)[:, -top_k][:, None]
        scaled = np.where(scaled >= cut, scaled, -np.inf)
    p = np.exp(scaled - scaled.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    n = N_DRAWS
    out, n_acc = tspec.verify_tokens(
        torch.from_numpy(np.broadcast_to(logits, (n, 2, v)).copy()),
        torch.tensor([[0, draft]], dtype=torch.int32).expand(n, 2),
        torch.ones(n, dtype=torch.int32), torch.Generator().manual_seed(7),
        torch.full((n,), temp),
        torch.full((n,), top_k, dtype=torch.int32) if top_k else None,
        k_cap=top_k or None)
    out, n_acc = out.numpy(), n_acc.numpy()
    # acceptance at the exact probability p_0(draft)
    assert _within(float((n_acc == 1).mean()), float(p[0, draft]))
    # the first emitted token follows p_0, the law rejection sampling keeps
    for tok in range(v):
        assert _within(float((out[:, 0] == tok).mean()), float(p[0, tok])), tok
    # accepted rows draw their bonus token from p_1
    bonus = out[n_acc == 1, 1]
    for tok in range(v):
        assert _within(float((bonus == tok).mean()), float(p[1, tok]),
                       len(bonus)), tok
    # nothing is emitted past n_acc + 1
    assert (out[n_acc == 0, 1] == 0).all()
