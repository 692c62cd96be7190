"""Differential tests of the legacy per-shape engine's path: the port's
paged attention (K4's plain version), ``paged_step`` and the
``ragged=False`` / speculative engines against the JAX package's, with the
JAX weights carried over by ``from_jax_params``.

* ``ops.paged_attention`` on the CPU against JAX's ``ops.paged_attention``
  over C in {1, 4, 16}, GQA groups {1, 2, 4}, int8 and fp32 pools, head
  dims 64 and 128, block sizes 16 and 128: shuffled block tables with trash
  tail entries, one padded slot (all-trash table, position 0), a position
  at a block edge, and the speculative step's table with one trash column
  more.  At bs = dk = dv = 128 with C = 1 the JAX side runs K4's Pallas body
  in interpret mode, elsewhere its gather path.  fp32 queries: within
  atol = rtol = 1e-5 (the two sum the fp32 products in other orders).
* ``paged_step``: a (1, 16) prefill chunk, another with a padded tail, a
  (4, 1) decode batch with two padded slots and a (4, 4) verify chunk, in
  FP and INT mode: logits within 1e-5, every pool block but the trash
  block bit-identical after every step.
* Engines on the CPU, greedy: the port's ``serve_engine`` against JAX's on
  the workload of ``test_torch_serving.py::test_engine_greedy_tokens_
  identical`` (8 requests at once, shared prefix 16, an 8-block pool that
  forces preemption): the legacy engine with and without drafting, the
  ragged engine with drafting, FP and INT — identical tokens and
  identical step, padding, preemption, prefix-hit and draft counts.
* The port's ragged engine against its own legacy engine (the JAX test
  ``test_serving_engine.py::test_ragged_engine_token_identical_to_legacy``).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.core.qmodel import QuantContext as JCtx  # noqa: E402
from repro.core.qmodel import QuantMode as JMode  # noqa: E402
from repro.core.qscheme import quant as jquant  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.qmodel import QuantContext as TCtx  # noqa: E402
from repro_torch.core.qmodel import QuantMode as TMode  # noqa: E402
from repro_torch.core.qmodel import quantize_weight_tree  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.flash_attention import plan_paged_work  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving.kv_pool import TRASH_BLOCK  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

NKV = 4
B = 4


# ---------------------------------------------------------------------------
# ops.paged_attention
# ---------------------------------------------------------------------------

def _paged_case(seed, c, groups, kv, dk, bs, spec):
    """Slots: 0 at a block edge, 1 deep in its table, 2 padded (all-trash
    table, position 0), 3 short with trash tail entries.  With ``spec`` the
    table has one trash column more and slot 3's last query sits on it."""
    rng = np.random.default_rng(seed)
    kvh = 2
    h = kvh * groups
    nbmax = 3
    nb = 1 + B * nbmax
    w = nbmax + 1 if spec else nbmax
    q = rng.normal(size=(B, c, h, dk)).astype(np.float32)
    kf = rng.normal(size=(nb, bs, kvh, dk)).astype(np.float32)
    vf = rng.normal(size=(nb, bs, kvh, dk)).astype(np.float32)
    if kv == "int8":
        kp = np.array(jquant(jax.numpy.asarray(kf), NKV, 8))
        vp = np.array(jquant(jax.numpy.asarray(vf), NKV, 8))
    else:
        kp, vp = kf, vf
    perm = rng.permutation(np.arange(1, nb)).astype(np.int32)
    bt = np.full((B, w), TRASH_BLOCK, np.int32)
    bt[0, :2] = perm[0:2]                        # edge: 2 blocks live
    bt[1, :3] = perm[2:5]
    bt[3, :1] = perm[5:6]                        # trash tail entries
    last = np.asarray([bs, 3 * bs - 1, 0, min(5, bs - 1)])
    pos = np.maximum(last[:, None] - (c - 1) + np.arange(c)[None, :], 0)
    pos[2] = 0                                   # the padded slot
    if spec:
        pos[3, -1] = nbmax * bs                  # a padded draft row
    return q, kp, vp, bt, pos.astype(np.int32)


GRID = [(c, g, kv, dk, bs) for c in (1, 4, 16) for g in (1, 2, 4)
        for kv in ("int8", "fp32") for dk, bs in ((64, 16), (128, 128))]


@pytest.mark.parametrize("c,groups,kv,dk,bs", GRID)
def test_paged_attention_matches_jax(c, groups, kv, dk, bs):
    spec = c == 4
    q, kp, vp, bt, pos = _paged_case(3 + c + groups, c, groups, kv, dk, bs,
                                     spec)
    nkv = NKV if kv == "int8" else None
    want = np.asarray(jops.paged_attention(
        *(jax.numpy.asarray(a) for a in (q, kp, vp, bt, pos)),
        kv_frac_bits=nkv))
    tops.reset_launch_counts()
    got = tops.paged_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, bt, pos)),
        kv_frac_bits=nkv)
    assert tops.LAUNCHES["paged_attention"] == 0        # CPU: plain version
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_paged_attention_requires_frac_bits_for_codes():
    q, kp, vp, bt, pos = _paged_case(0, 1, 2, "int8", 64, 16, False)
    with pytest.raises(ValueError, match="kv_frac_bits"):
        tops.paged_attention(*(torch.from_numpy(a)
                               for a in (q, kp, vp, bt, pos)))


def test_paged_attention_cuda_takes_no_plain_fallback(monkeypatch):
    """On a CUDA tensor the wrapper reaches K4's binding (here a stand-in
    that records the call) and never the plain version; without a plan it
    hands the binding ``plan_paged_work`` of the positions and the table
    width."""
    calls = []

    def fake(*args, **kw):
        calls.append(kw)
        raise RuntimeError("paged_attention_cuda reached")

    def plain(*args, **kw):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(tops, "paged_attention_cuda", fake)
    monkeypatch.setattr(tops.ref, "paged_attention_ref", plain)
    monkeypatch.setattr(tops, "_on_cuda", lambda t, what: True)
    q, kp, vp, bt, pos = _paged_case(0, 4, 2, "int8", 64, 16, True)
    with pytest.raises(RuntimeError, match="paged_attention_cuda reached"):
        tops.paged_attention(*(torch.from_numpy(a)
                               for a in (q, kp, vp, bt, pos)),
                             kv_frac_bits=NKV)
    assert len(calls) == 1
    work = calls[0].pop("work")
    assert calls == [{"kv_frac_bits": NKV, "scale": 1 / 8.0}]
    want = plan_paged_work(pos, table_width=bt.shape[1], block_size=16,
                           groups=2)
    assert np.array_equal(work.table.numpy(), want.table)
    assert work[1:] == want[1:]


# ---------------------------------------------------------------------------
# paged_step
# ---------------------------------------------------------------------------

BS, NB, NBMAX = 16, 8, 2


def _cfgs(**kw):
    jcfg = dataclasses.replace(get_smoke_config("qwen3_1_7b"),
                               kv_cache_bits=8, dtype="float32", **kw)
    tcfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})
    return jcfg, tcfg


def _np_params(jcfg):
    return jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))


def _paged_steps(vocab):
    """(tokens, positions, block tables) of four legacy steps: A's 16-token
    prefill chunk (blocks 1, 2); B's 12 tokens padded to a 16 chunk (block
    3, then trash); a (4, 1) decode of A at 16 and B at 12 with two padded
    slots; a (4, 4) verify of A's fed token + 3 drafts and B's fed token +
    1 draft, padded rows on the extra trash column."""
    rng = np.random.default_rng(17)
    a = rng.integers(0, vocab, size=20).astype(np.int32)
    b = rng.integers(0, vocab, size=14).astype(np.int32)
    t = TRASH_BLOCK
    s1 = (a[None, :16], np.arange(16, dtype=np.int32)[None],
          np.asarray([[1, 2]], np.int32))
    tok = np.zeros((1, 16), np.int32)
    tok[0, :12] = b[:12]
    s2 = (tok, np.arange(16, dtype=np.int32)[None],
          np.asarray([[3, t]], np.int32))
    bt3 = np.full((4, NBMAX), t, np.int32)
    bt3[0], bt3[1] = (1, 2), (3, t)
    s3 = (np.asarray([[a[16]], [b[12]], [0], [0]], np.int32),
          np.asarray([[16], [12], [0], [0]], np.int32), bt3)
    pad = NBMAX * BS
    tok4 = np.zeros((4, 4), np.int32)
    tok4[0], tok4[1, :2] = a[16:20], b[12:14]
    pos4 = np.full((4, 4), pad, np.int32)
    pos4[0], pos4[1, :2] = 17 + np.arange(4), 13 + np.arange(2)
    bt4 = np.full((4, NBMAX + 1), t, np.int32)
    bt4[0, :2], bt4[1, :2] = (1, 2), (3, 4)
    return s1, s2, s3, (tok4, pos4, bt4)


def _non_trash_equal(t_pools, j_pools):
    for tp, jp in zip(t_pools, j_pools):
        assert tp.dtype == np.int8 and tp.shape == jp.shape
        np.testing.assert_array_equal(tp[:, TRASH_BLOCK + 1:],
                                      jp[:, TRASH_BLOCK + 1:])


@pytest.mark.parametrize("mode", ["fp", "int"])
def test_paged_step_matches_jax(mode):
    jcfg, tcfg = _cfgs()
    npt = _np_params(jcfg)
    jp = jax.tree.map(jax.numpy.asarray, npt)
    jctx = JCtx(mode=JMode(mode))
    tctx = TCtx(mode=TMode(mode))
    tp = TM.from_jax_params(npt, tcfg, device="cpu")
    if tctx.mode is TMode.INT:
        tp = quantize_weight_tree(tp, tctx)
    jcache = JM.init_paged_cache(jcfg, NB, BS)
    tcache = TM.init_paged_cache(tcfg, NB, BS, device="cpu")
    tops.reset_launch_counts()
    for tokens, positions, bt in _paged_steps(jcfg.vocab_size):
        jl, jcache = JM.paged_step(jp, jax.numpy.asarray(tokens), jcache,
                                   jax.numpy.asarray(positions),
                                   jax.numpy.asarray(bt), jcfg, jctx)
        tl, tcache = TM.paged_step(tp, torch.from_numpy(tokens), tcache,
                                   torch.from_numpy(positions),
                                   torch.from_numpy(bt), tcfg, tctx)
        jl = np.asarray(jl)
        assert tl.shape == jl.shape == (*tokens.shape, jcfg.vocab_padded)
        np.testing.assert_allclose(tl.float().numpy(), jl, atol=1e-5,
                                   rtol=1e-5)
        _non_trash_equal([a.numpy() for a in tcache["paged_kv"]],
                         [np.asarray(a) for a in jcache["paged_kv"]])
    # the steps wrote real codes into A's and B's blocks
    assert torch.count_nonzero(tcache["paged_kv"].k[:, 1:4]) > 0
    assert tops.LAUNCHES["paged_attention"] == 0


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

ENGINE_CASES = [(mode, ragged, spec_k) for mode in ("fp", "int")
                for ragged, spec_k in ((False, 0), (False, 3), (True, 3))]


@pytest.mark.parametrize("mode,ragged,spec_k", ENGINE_CASES)
def test_engine_tokens_identical(mode, ragged, spec_k):
    jcfg, tcfg = _cfgs()
    kw = dict(n_requests=8, rate=1e9, mode=mode, calibrate=False, kv_bits=8,
              cfg_overrides={"dtype": "float32"}, shared_prefix=16,
              num_blocks=8, ragged=ragged, spec_k=spec_k)
    jo = jserve.serve_engine("qwen3_1_7b", **kw)
    params = TM.from_jax_params(_np_params(jcfg), tcfg, device="cpu")
    to = tserve.serve_engine("qwen3_1_7b", params=params, device="cpu", **kw)
    assert sorted(jo["outputs"]) == sorted(to["outputs"]) == list(range(8))
    for rid, toks in jo["outputs"].items():
        assert np.array_equal(toks, to["outputs"][rid]), rid
    tr, jr = to["report"], jo["report"]
    for key in ("decode_steps", "spec_steps", "prefill_chunks",
                "padded_tokens", "dispatched_tokens", "preemptions",
                "ragged_steps"):
        assert tr[key] == jr[key], key
    assert tr["preemptions"] > 0
    assert tr["prefix_cache"]["hits"] == jr["prefix_cache"]["hits"] > 0
    assert tr["ragged"] is ragged
    if spec_k:
        ts, js = tr["speculative"], jr["speculative"]
        for key in ("drafted_tokens", "accepted_tokens", "emitted_tokens",
                    "verify_steps", "fallback_decode_steps"):
            assert ts[key] == js[key], key
        assert ts["drafted_tokens"] > 0 and tr["spec_steps"] > 0
    else:
        assert tr["speculative"] is None
    attn = "ragged_attention" if ragged else "paged_attention"
    assert tr["kernel_launches"] == {"int8_matmul": 0, attn: 0}
    if not ragged:
        assert set(tr["step_shapes"]) == {"legacy_shapes"}


@pytest.mark.parametrize("spec_k", [0, 3])
def test_ragged_engine_token_identical_to_legacy(spec_k):
    """The port's counterpart of the JAX package's test of the same name:
    the unified ragged step and the legacy per-shape trio give identical
    greedy tokens, with drafting off and on (an always-proposing drafter,
    so both engines verify)."""
    from repro_torch.core.qmodel import QuantContext, QuantMode
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import Request
    from repro_torch.serving.spec import CallableDrafter
    jcfg, tcfg = _cfgs()
    params = TM.from_jax_params(_np_params(jcfg), tcfg, device="cpu")
    ctx = QuantContext(mode=QuantMode.FP)

    def run(ragged):
        rng = np.random.default_rng(23)
        t, reqs = 0.0, []
        for i in range(5):
            t += float(rng.exponential(0.02))
            reqs.append(Request(
                rid=i, prompt=rng.integers(0, tcfg.vocab_size, size=int(
                    rng.integers(5, 20))).astype(np.int32),
                max_new_tokens=int(rng.integers(3, 9)), arrival=t))
        drafter = CallableDrafter(lambda h, k: [int(h[-1])] * k)
        eng = ServingEngine(tcfg, params, ctx, n_slots=2, block_size=8,
                            max_model_len=32, chunk=8, spec_k=spec_k,
                            drafter=drafter, ragged=ragged, device="cpu")
        with torch.no_grad():
            rep = eng.run(reqs)
        assert rep["completed"] == len(reqs)
        eng.pool.check_invariants()
        assert eng.pool.n_live == 0
        return eng.outputs(), rep

    got_r, rep_r = run(True)
    got_l, rep_l = run(False)
    assert rep_r["ragged"] and not rep_l["ragged"]
    assert rep_r["ragged_steps"] > 0 and rep_l["ragged_steps"] == 0
    for rid in got_l:
        assert got_r[rid].tolist() == got_l[rid].tolist(), f"req {rid}"
    if spec_k:
        assert rep_r["spec_steps"] > 0 and rep_l["spec_steps"] > 0
        assert (rep_r["speculative"]["drafted_tokens"]
                == rep_l["speculative"]["drafted_tokens"] > 0)
