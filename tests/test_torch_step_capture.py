"""The compiled serving step on the CPU: padded work lists, their
capacity, the step-capture helper and the engines over staged buffers.

* Padded work lists (``ragged_flash.pad_work``): K1's list of a mixed
  step and K4's lists of the legacy engine's decode and verify shapes,
  padded to their step shape's capacity, give through the plain
  work-list consumers (``ref.ragged_attention_split_ref``,
  ``ref.paged_attention_split_ref``) exactly the unpadded list's output,
  and both agree with the JAX package's K1 (Pallas body interpreted) and
  K4 (``ops.paged_attention``) within the tolerances of
  ``test_torch_ragged_plan.py`` (2e-5) and ``test_torch_paged_plan.py``
  (1e-5): fp32 sums in other orders.
* Capacity: for every (T_pad, S_pad) the ragged engine forms (its
  power-of-two buckets up to the worst-case stream) and every shape of the
  legacy engine, contexts up to ``nbmax * block_size`` and GQA groups 1, 2
  and 8, the worst-case descriptors and random ones plan lists that fit;
  the worst case reaches the capacity's tile count.
* ``StepGraphs`` with a stand-in graph (capture records the step, replay
  reruns it into the captured output with the kernel counters held): a
  key's first call runs eagerly and its wrappers count it, its second
  captures and replays, each replay adds the counts the key's capture
  recorded, once, and the capture's own counts are not kept, so every
  call counts its launches once; the static buffers carry each step's
  arrays.
* The engines on the CPU, staging every step's arrays, eager and through
  the stand-in graphs with the work lists planned and padded as on the
  card: tokens identical to the JAX engine on the ragged, legacy and
  speculative paths, first calls equal to the keys and first calls plus
  replays to dispatches; a sampled run identical with and without the
  stand-in graphs.
  ``graphs=True`` on a CPU engine raises.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs import get_smoke_config as jget  # noqa: E402
from repro.core.qscheme import quant as jquant  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    paged_capacity, plan_paged_work)
from repro_torch.kernels.ragged_flash import (  # noqa: E402
    ROWS_PER_ITEM, pad_work, plan_ragged_work, ragged_capacity)
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.steps import StepGraphs  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving.kv_pool import TRASH_BLOCK  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

jnp = jax.numpy
NKV = 4


def _codes(rng, shape, kv):
    f = rng.normal(size=shape).astype(np.float32)
    return np.asarray(jquant(jnp.asarray(f), NKV, 8)) if kv == "int8" else f


# ---------------------------------------------------------------------------
# padded work lists against unpadded ones and JAX
# ---------------------------------------------------------------------------

# (q_len, kv_len) of a mixed step: a decode row past the 512-row split
# edge, a 16-row chunk across it, a 3-token tail over three chunks, a
# fresh one-row prefill; then a padding slot
RAGGED_ITEMS = ((1, 513), (16, 527), (3, 1030), (1, 1))
RAGGED_BS, RAGGED_D, RAGGED_T, RAGGED_S = 128, 128, 32, 6


def _ragged_case(seed, kvh, groups, kv):
    rng = np.random.default_rng(seed)
    h, ns = kvh * groups, len(RAGGED_ITEMS)
    nbmax = -(-max(kl for _, kl in RAGGED_ITEMS) // RAGGED_BS)
    q = rng.normal(size=(RAGGED_T, h, RAGGED_D)).astype(np.float32)
    nb = 1 + ns * nbmax
    kp = _codes(rng, (nb, RAGGED_BS, kvh, RAGGED_D), kv)
    vp = _codes(rng, (nb, RAGGED_BS, kvh, RAGGED_D), kv)
    bt = np.full((RAGGED_S, nbmax), TRASH_BLOCK, np.int32)
    bt[:ns] = rng.permutation(np.arange(1, nb)).reshape(ns, nbmax)
    q_len = np.zeros(RAGGED_S, np.int32)
    kv_len = np.zeros(RAGGED_S, np.int32)
    q_len[:ns] = [ql for ql, _ in RAGGED_ITEMS]
    kv_len[:ns] = [kl for _, kl in RAGGED_ITEMS]
    q_start = np.full(RAGGED_S, RAGGED_T, np.int32)
    q_start[:ns] = np.concatenate([[0], np.cumsum(q_len[:ns - 1])])
    return (q, kp, vp, bt, q_start, q_len, kv_len), nbmax


@pytest.mark.parametrize("kv", ["int8", "fp32"])
@pytest.mark.parametrize("groups", [2, 8])
def test_padded_ragged_list_is_the_unpadded_list(groups, kv):
    args, nbmax = _ragged_case(groups, 2, groups, kv)
    nkv = NKV if kv == "int8" else None
    targs = [torch.from_numpy(a) for a in args]
    work = plan_ragged_work(*args[4:7], groups=groups)
    cap = ragged_capacity(RAGGED_T, RAGGED_S, groups=groups,
                          rows=nbmax * RAGGED_BS)
    padded = pad_work(work, cap)
    assert work.n_combine > 0 and padded.n_items > work.n_items
    assert padded.n_combine > work.n_combine
    assert padded.table.shape == (cap.n_items + cap.n_combine, 8)
    assert tuple(padded[1:]) == tuple(cap)
    got = ref.ragged_attention_split_ref(*targs, work=padded,
                                         kv_frac_bits=nkv)
    want = ref.ragged_attention_split_ref(*targs, work=work, kv_frac_bits=nkv)
    assert torch.equal(got, want)
    pallas = jops.ragged_attention(*(jnp.asarray(a) for a in args),
                                   kv_frac_bits=nkv, tq_max=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=2e-5,
                               rtol=2e-5)
    t_real = int(args[5].sum())
    assert torch.count_nonzero(got[t_real:]) == 0


PAGED_BS, PAGED_NBMAX = 16, 40      # 640 rows a slot


def _paged_case(seed, c, groups, kv, dk):
    """The legacy engine's (4, C) layout: slots at their last positions
    (one past the split edge), a padded slot on the trash block; at C > 1
    a verify chunk, slot 1 drafting one token, its padded rows and the
    padded slot's on the extra trash column."""
    rng = np.random.default_rng(seed)
    kvh, b = 2, 4
    h = kvh * groups
    last = (600, 511, 37)
    width = PAGED_NBMAX + (c > 1)
    nb = 1 + 3 * PAGED_NBMAX
    q = rng.normal(size=(b, c, h, dk)).astype(np.float32)
    kp = _codes(rng, (nb, PAGED_BS, kvh, dk), kv)
    vp = _codes(rng, (nb, PAGED_BS, kvh, dk), kv)
    perm = rng.permutation(np.arange(1, nb)).astype(np.int32)
    bt = np.full((b, width), TRASH_BLOCK, np.int32)
    pad = PAGED_NBMAX * PAGED_BS
    pos = np.full((b, c), pad if c > 1 else 0, np.int32)
    for s, p in enumerate(last):
        n_real = 2 if (c > 1 and s == 1) else c
        pos[s, :n_real] = p - (n_real - 1) + np.arange(n_real)
        live = p // PAGED_BS + 1
        bt[s, :live] = perm[s * PAGED_NBMAX:s * PAGED_NBMAX + live]
    return q, kp, vp, bt, pos


@pytest.mark.parametrize("kv", ["int8", "fp32"])
@pytest.mark.parametrize("c,groups,dk", [(1, 2, 128), (4, 1, 64),
                                         (4, 8, 128)])
def test_padded_paged_list_is_the_unpadded_list(c, groups, dk, kv):
    args = _paged_case(c + groups, c, groups, kv, dk)
    q, kp, vp, bt, pos = args
    nkv = NKV if kv == "int8" else None
    targs = [torch.from_numpy(a) for a in args]
    work = plan_paged_work(pos, table_width=bt.shape[1],
                           block_size=PAGED_BS, groups=groups)
    cap = paged_capacity(*pos.shape, groups=groups, table_width=bt.shape[1],
                         block_size=PAGED_BS)
    padded = pad_work(work, cap)
    assert work.n_combine > 0 and padded.n_items > work.n_items
    got = ref.paged_attention_split_ref(*targs, work=padded,
                                        kv_frac_bits=nkv)
    want = ref.paged_attention_split_ref(*targs, work=work, kv_frac_bits=nkv)
    assert torch.equal(got, want)
    jax_out = jops.paged_attention(*(jnp.asarray(a) for a in args),
                                   kv_frac_bits=nkv)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_out), atol=1e-5,
                               rtol=1e-5)


def test_pad_work_refuses_a_list_past_its_capacity():
    work = plan_ragged_work([0, 1], [1, 1], [5, 700], groups=2)
    cap = ragged_capacity(8, 1, groups=2, rows=700)
    with pytest.raises(ValueError, match="exceeds its capacity"):
        pad_work(work, cap)


# ---------------------------------------------------------------------------
# capacity
# ---------------------------------------------------------------------------

def _t_buckets(budget, n_slots, spec_k):
    """The engine's padded stream lengths (``ServingEngine._t_bucket``)."""
    t_max = max(8, -(-(budget + n_slots * (spec_k + 1)) // 8) * 8)
    out, b = set(), 8
    while True:
        out.add(min(b, t_max))
        if b >= t_max:
            return sorted(out)
        b <<= 1


def _ragged_fits(rng, t_pad, s_pad, groups, rows):
    cap = ragged_capacity(t_pad, s_pad, groups=groups, rows=rows)
    tq = ROWS_PER_ITEM // groups
    m = min(s_pad, t_pad)
    # the worst case: m - 1 one-token rows and the rest in one sequence,
    # every sequence over the longest context (no sequence has more
    # tokens than kv rows)
    worst_q = np.asarray([1] * (m - 1) + [t_pad - m + 1])
    worst = worst_q.max() <= rows
    cases = [(worst_q, np.full(m, rows))] if worst else []
    while len(cases) < 30:
        n = int(rng.integers(1, s_pad + 1))
        t_real = int(rng.integers(n, t_pad + 1))
        cuts = np.sort(rng.choice(np.arange(1, t_real), n - 1,
                                  replace=False)) if n > 1 else []
        ql = np.diff(np.concatenate([[0], cuts, [t_real]])).astype(np.int64)
        if ql.max() > rows:
            continue
        kl = np.where(rng.random(n) < 0.3, rows,
                      rng.integers(ql, rows + 1))
        cases.append((ql, kl))
    for ql, kl in cases:
        pad = np.zeros(s_pad - len(ql), np.int64)
        q_len, kv_len = np.concatenate([ql, pad]), np.concatenate([kl, pad])
        q_start = np.concatenate([[0], np.cumsum(q_len)[:-1]])
        work = plan_ragged_work(q_start, q_len, kv_len, groups=groups)
        padded = pad_work(work, cap)
        assert padded.table.shape == (cap.n_items + cap.n_combine, 8)
    if worst:
        work = plan_ragged_work(
            np.concatenate([[0], np.cumsum(worst_q)[:-1]]), worst_q,
            np.full(m, rows), groups=groups)
        tiles = {tuple(it[:3]) for it in work.table[:work.n_items].tolist()}
        assert len(tiles) == m + (t_pad - m) // tq


@pytest.mark.parametrize("groups", [1, 2, 8])
def test_every_ragged_bucket_fits_its_capacity(groups):
    rng = np.random.default_rng(groups)
    for n_slots in (1, 4, 8):
        for spec_k in (0, 3):
            for budget in (16, 64, 256):
                for rows in (128, 1040, 4096):
                    for t_pad in _t_buckets(budget, n_slots, spec_k):
                        _ragged_fits(rng, t_pad, n_slots, groups, rows)


@pytest.mark.parametrize("groups", [1, 2, 8])
def test_every_legacy_shape_fits_its_capacity(groups):
    """Decode rows anywhere in the context, prefill chunks of every
    bucket inside the model length, verify chunks of every draft count
    with their padded rows on the trash column."""
    rng = np.random.default_rng(10 + groups)
    bs = 16
    for n_slots, spec_k, chunk in ((1, 2, 8), (4, 3, 16), (8, 7, 64)):
        for max_len in (128, 1040, 4096):
            nbmax = -(-max_len // bs)
            for _ in range(20):
                dec = rng.integers(0, max_len, size=(n_slots, 1))
                c = int(2 ** rng.integers(0, chunk.bit_length()))
                start = int(rng.integers(0, max_len - c + 1))
                pre = (start + np.arange(c))[None]
                kp1 = spec_k + 1
                ver = np.full((n_slots, kp1), nbmax * bs)
                for s in range(n_slots):
                    d = int(rng.integers(0, kp1))
                    n_ctx = int(rng.integers(0, max_len - d))
                    ver[s, :1 + d] = n_ctx + np.arange(1 + d)
                for pos, width in ((dec, nbmax), (pre, nbmax),
                                   (ver, nbmax + 1)):
                    work = plan_paged_work(pos, table_width=width,
                                           block_size=bs, groups=groups)
                    cap = paged_capacity(*pos.shape, groups=groups,
                                         table_width=width, block_size=bs)
                    pad_work(work, cap)


# ---------------------------------------------------------------------------
# the step-capture helper
# ---------------------------------------------------------------------------

class StubGraph:
    """A CUDA graph's stand-in on the CPU: ``capture`` records the step
    and runs it once for its output, leaving the generator as it was (a
    capture launches nothing); ``replay`` runs it again into that output
    with the kernel counters held (a replay calls no wrapper)."""

    def __init__(self, generator, pool, stream):
        self.generator = generator
        self.fn = self.output = None

    def capture(self, fn):
        state = None if self.generator is None else self.generator.get_state()
        self.fn, self.output = fn, fn()
        if state is not None:
            self.generator.set_state(state)

    def replay(self):
        counts = dict(tops.LAUNCHES)
        self.output.copy_(self.fn())
        tops.LAUNCHES.update(counts)


PER_STEP = {"ragged_attention": 28, "int8_matmul": 197}


def _counting_step(inp):
    """A step that launches PER_STEP's kernels, as its wrappers count."""
    for name, n in PER_STEP.items():
        tops.LAUNCHES[name] += n
    return inp["x"] * 2 + inp["t"].view(torch.int32)[:, None]


def test_replays_add_each_keys_captured_launches_once():
    tops.reset_launch_counts()
    graphs = StepGraphs("cpu", capture=True, graph_factory=StubGraph)
    seq = ["a", "a", "b", "a", "b", "b"]
    for i, key in enumerate(seq):
        x = np.full((2, 3), i, np.int32)
        t = np.asarray([0.5, i], np.float32)
        out = graphs.run(key, _counting_step, {"x": x, "t": t})
        want = torch.from_numpy(x * 2 + t.view(np.int32)[:, None])
        assert torch.equal(out, want), key
        assert graphs.last == ("eager", "capture", "eager", "replay",
                               "capture", "replay")[i]
    assert graphs.first_calls == graphs.captures == 2
    assert graphs.replays == len(seq) - 2
    assert sorted(graphs.keys) == ["a", "b"]
    for name, n in PER_STEP.items():
        assert tops.LAUNCHES[name] == n * len(seq)
    with pytest.raises(ValueError, match="layout"):
        graphs.run("a", _counting_step, {"x": np.zeros((3, 3), np.int32),
                                         "t": np.zeros(2, np.float32)})
    tops.reset_launch_counts()


def test_eager_helper_runs_the_step_each_call():
    tops.reset_launch_counts()
    graphs = StepGraphs("cpu", capture=False)
    for i in range(3):
        out = graphs.run("a", _counting_step,
                         {"x": np.full((1, 2), i, np.int32),
                          "t": np.zeros(1, np.float32)})
        assert out.tolist() == [[2 * i, 2 * i]]
    assert graphs.first_calls == graphs.captures == graphs.replays == 0
    assert graphs.keys == [] and graphs.last == "eager"
    assert tops.LAUNCHES["ragged_attention"] == 3 * 28
    tops.reset_launch_counts()


def test_graphs_on_a_cpu_engine_raise():
    with pytest.raises(ValueError, match="CUDA device"):
        tserve.serve_engine("qwen3_1_7b", n_requests=1, rate=1e9,
                            graphs=True, device="cpu")
    with pytest.raises(TypeError, match="int64"):
        StepGraphs("cpu", capture=False).run(
            "a", _counting_step, {"x": np.zeros(2, np.int64)})
    eng = tserve.serve_engine("qwen3_1_7b", n_requests=2, rate=1e9,
                              gen_lens=(3,), device="cpu")["engine"]
    assert eng.graphs.capture is False
    assert eng.report()["step_graphs"] == {"enabled": False, "keys": 0,
                                           "first_calls": 0, "captures": 0,
                                           "replays": 0}


# ---------------------------------------------------------------------------
# the engines over staged buffers
# ---------------------------------------------------------------------------

def _stub_graphs(monkeypatch):
    """Engines built after this capture through StubGraph and plan and
    pad their work lists as on the card (the CPU path ignores them)."""
    monkeypatch.setattr(
        tengine, "StepGraphs",
        lambda device, generator, capture: StepGraphs(
            device, generator, capture=True, graph_factory=StubGraph))
    monkeypatch.setattr(tengine.ServingEngine, "_plans_work",
                        lambda self: True)


def _dispatches(rep):
    if rep["ragged"]:
        return rep["ragged_steps"]
    return rep["prefill_chunks"] + rep["decode_steps"] + rep["spec_steps"]


@pytest.mark.parametrize("ragged,spec_k", [(True, 0), (False, 0), (True, 3),
                                           (False, 3)])
def test_engine_tokens_identical_to_jax_through_staging(ragged, spec_k,
                                                        monkeypatch):
    jcfg = dataclasses.replace(jget("qwen3_1_7b"), kv_cache_bits=8,
                               dtype="float32")
    tcfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})
    kw = dict(n_requests=8, rate=1e9, mode="fp", calibrate=False, kv_bits=8,
              cfg_overrides={"dtype": "float32"}, shared_prefix=16,
              num_blocks=8, ragged=ragged, spec_k=spec_k)
    jo = jserve.serve_engine("qwen3_1_7b", **kw)
    np_params = jax.tree.map(np.asarray,
                             JM.init_params(jcfg, jax.random.PRNGKey(0)))
    eager = tserve.serve_engine(
        "qwen3_1_7b", params=TM.from_jax_params(np_params, tcfg,
                                                device="cpu"),
        device="cpu", **kw)
    _stub_graphs(monkeypatch)
    staged = tserve.serve_engine(
        "qwen3_1_7b", params=TM.from_jax_params(np_params, tcfg,
                                                device="cpu"),
        device="cpu", **kw)
    for o in (eager, staged):
        assert sorted(o["outputs"]) == sorted(jo["outputs"])
        for rid, toks in jo["outputs"].items():
            assert np.array_equal(toks, o["outputs"][rid]), rid
    rep = staged["report"]
    assert rep["preemptions"] > 0 and rep["step_graphs"]["enabled"]
    graphs = staged["engine"].graphs
    g = rep["step_graphs"]
    assert g["first_calls"] == len(graphs.keys) == g["keys"]
    assert g["first_calls"] + g["replays"] == _dispatches(rep)
    assert 0 < g["captures"] <= g["keys"] and g["replays"] > 0
    assert len(graphs.keys) < _dispatches(rep)
    if ragged:
        assert all(k[0] == "ragged" for k in graphs.keys)
    else:
        assert {k[2] for k in graphs.keys} == {bool(spec_k)} | {False}


@pytest.mark.parametrize("ragged", [True, False])
def test_sampled_run_identical_with_and_without_graphs(ragged, monkeypatch):
    kw = dict(n_requests=6, rate=1e9, mode="fp", temperature=0.8, top_k=5,
              spec_k=2, ragged=ragged, device="cpu")
    eager = tserve.serve_engine("qwen3_1_7b", **kw)
    _stub_graphs(monkeypatch)
    staged = tserve.serve_engine("qwen3_1_7b", **kw)
    assert staged["report"]["step_graphs"]["captures"] > 0
    assert sorted(eager["outputs"]) == sorted(staged["outputs"])
    for rid, toks in eager["outputs"].items():
        assert np.array_equal(toks, staged["outputs"][rid]), rid
    # the run really sampled: a greedy run of the same workload differs
    greedy = tserve.serve_engine("qwen3_1_7b",
                                 **{**kw, "temperature": 0.0})["outputs"]
    assert any(not np.array_equal(greedy[r], eager["outputs"][r])
               for r in greedy)
