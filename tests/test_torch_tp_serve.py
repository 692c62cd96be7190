"""Tensor-parallel serving on a (data, model) mesh of spawned gloo ranks
against one rank and against the JAX package's single-device reference.

One spawn a mesh shape (ranks meet through a file store under
``tmp_path``), many cases inside it (``tests/tp_cases.py``), on
qwen3-1.7B's smoke config in fp32 with the JAX package's weights:

* classic ``serve`` at (1, 2), (2, 1) and (2, 2) in FP, INT and W8A8
  (INT over int8 weight codes, ``matmul_kernel='int8'``), and FAKE_SF at
  (1, 2); the ragged engine in FP, calibrated INT and W8A8 and the legacy
  engine in INT at (1, 2); classic INT and the engine at (1, 4) with
  ``n_kv_heads`` 4.
* INT and W8A8: every rank's first-step logits and tokens bit-identical
  to one rank's, and the tokens equal to the JAX package's: the classic
  cases' to its classic INT run here (uncalibrated; W8A8's codes are
  INT's), the engine's calibrated INT and W8A8 to its W8A8 engine (the
  same calibrated codes) through the one-rank run, which
  ``test_torch_serving.py::test_engine_w8a8_tokens_identical[prefix]``
  holds to it on this very scenario and weights (the JAX engine's
  calibrated run takes 17 s, a third of this file's budget).  FP and
  FAKE_SF: tokens identical, logits within 1e-5 (the row-cut modules'
  fp32 partials summed in another order: measured about 2e-6).
* Every rank's tokens and scheduler decisions identical, also for an
  INT engine run at a finite arrival rate on the wall clock (the other
  cases run on the recorder's virtual clock), where rank 0's clock
  decides each step's admissions.

The engine serves that W8A8 prefix scenario (6 requests sharing a
16-token prefix, so the prefix cache runs on the mesh too): on the plain
6-request workload the port's own one-rank run departs from the JAX
package's in one last token (the rms statistic's last bit, ROADMAP
Queue 3), which no mesh changes.  While a mesh's ranks run, this process
runs the one-rank cases (each case's one-rank result is made once).

The refusals (a model axis that does not divide the KV heads, a shard
axis other than ``model``, MLA's head count, training a non-dense family,
graphs on a mesh, nccl on the CPU) run without processes.
"""
import concurrent.futures
import copy
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.qmodel import QuantContext  # noqa: E402
from repro_torch.distributed import sharding as tshd  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models.model import from_jax_params  # noqa: E402
from tests import tp_cases  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

CLASSIC = dict(batch=4, prompt_len=12, gen=5,
               cfg_overrides={"dtype": "float32", "kv_cache_bits": 8})
ENGINE = dict(n_requests=6, rate=1e9, shared_prefix=16,
              cfg_overrides={"dtype": "float32"})
FP_TOL = 1e-5
# requests a second for the wall-clock engine case: its arrivals spread
# over several steps
PACED_RATE = 20.0


def _params(overrides: dict):
    jcfg = dataclasses.replace(get_smoke_config("qwen3_1_7b"), **overrides)
    tcfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})
    np_params = jax.tree.map(np.asarray,
                             JM.init_params(jcfg, jax.random.PRNGKey(0)))
    return from_jax_params(np_params, tcfg, device="cpu")


@pytest.fixture(scope="module")
def params():
    return _params({"dtype": "float32"})


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's single-device tokens of classic INT."""
    classic = jserve.serve("qwen3_1_7b", mode="int", calibrate=False,
                           **CLASSIC)
    return np.asarray(classic["tokens"])


def _classic(mode, params, **extra):
    kw = dict(CLASSIC, mode=mode, params=params, attn_kernel="flash",
              calibrate=False)
    if mode == "w8a8":
        kw.update(mode="int", cfg_overrides=dict(
            CLASSIC["cfg_overrides"], matmul_kernel="int8"))
    kw["cfg_overrides"] = dict(kw["cfg_overrides"], **extra)
    return ("classic", kw)


def _engine(mode, params, ragged=True, **extra):
    kw = dict(ENGINE, params=params, ragged=ragged, record=True,
              cfg_overrides=dict(ENGINE["cfg_overrides"], **extra))
    if mode == "w8a8":
        kw["w8a8"] = True
    else:
        kw.update(mode=mode, calibrate=mode == "int")
    return ("engine", kw)


@pytest.fixture(scope="module")
def one_rank() -> dict:
    """Each case's one-rank result, made once a module."""
    return {}


def _on_mesh(shape, named: dict, tmp_path, one_rank: dict, key: str,
             ranks_only: tuple = ()) -> tuple:
    """Every case on every rank of one spawned mesh ([rank][case], the
    ``ranks_only`` cases last), and in this process meanwhile every case
    of ``named`` on one rank."""
    # the ranks' own copy: sending a tensor to a spawned process moves its
    # storage to shared memory, which must not race this thread's reads
    cases = copy.deepcopy(list(named.values()) + list(ranks_only))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(tmesh.run_ranks, tp_cases.run_cases, shape,
                            device="cpu", backend="gloo",
                            kwargs={"cases": cases}, workdir=str(tmp_path),
                            threads=1)
        for n, (kind, kw) in named.items():
            if (key, n) not in one_rank:
                one_rank[key, n] = tp_cases.run(kind, kw, device="cpu")
        ones = [one_rank[key, n] for n in named]
        return ranks.result(timeout=600), ones


def _held(named: dict, ranks, ones, jax_ref=None):
    """Each case on every rank against the same case on one rank."""
    for name, one, *got in zip(named, ones, *ranks):
        kind = named[name][0]
        exact = not name.startswith(("fp", "fake_sf"))
        for r, res in enumerate(got):
            what = (name, r)
            if kind == "classic":
                assert np.array_equal(res["tokens"], one["tokens"]), what
            else:
                assert res["outputs"].keys() == one["outputs"].keys()
                for rid, toks in one["outputs"].items():
                    assert np.array_equal(res["outputs"][rid], toks), what
                assert res["decisions"] == got[0]["decisions"] \
                    == one["decisions"], what
                assert res["steps"] == one["steps"], what
                assert res["table"] == one["table"], what
            if exact:
                assert torch.equal(res["logits"], one["logits"]), what
            else:
                err = (res["logits"] - one["logits"]).abs().max().item()
                assert err <= FP_TOL, (what, err)
        if jax_ref is not None and exact and kind == "classic":
            assert np.array_equal(one["tokens"], jax_ref), name


def test_mesh_1x2(params, jax_ref, one_rank, tmp_path):
    named = {"fp": _classic("fp", params), "int": _classic("int", params),
             "w8a8": _classic("w8a8", params),
             "fake_sf": _classic("fake_sf", params),
             "fp engine": _engine("fp", params),
             "int engine": _engine("int", params),
             "w8a8 engine": _engine("w8a8", params),
             "legacy int engine": _engine("int", params, ragged=False)}
    paced = dict(_engine("int", params)[1], rate=PACED_RATE, record=False)
    ranks, ones = _on_mesh((1, 2), named, tmp_path, one_rank, "smoke",
                           ranks_only=[("engine", paced)])
    _held(named, ranks, ones, jax_ref)
    # at a finite rate on the wall clock the ranks' clocks differ; rank
    # 0's says which arrivals join each step, so every rank's steps admit
    # the same requests and give the same tokens
    got = [r[-1] for r in ranks]
    assert sum(1 for st in got[0]["steps"] if st) > 1, got[0]["steps"]
    for r, res in enumerate(got):
        assert res["steps"] == got[0]["steps"], r
        assert res["outputs"].keys() == got[0]["outputs"].keys()
        for rid, toks in got[0]["outputs"].items():
            assert np.array_equal(res["outputs"][rid], toks), (r, rid)
    # calibrated INT is W8A8's computation: its tokens are the ones the
    # JAX package's W8A8 engine gives (test_torch_serving.py)
    assert one_rank["smoke", "int engine"]["outputs"].keys() \
        == one_rank["smoke", "w8a8 engine"]["outputs"].keys()
    for rid, toks in one_rank["smoke", "w8a8 engine"]["outputs"].items():
        assert np.array_equal(one_rank["smoke", "int engine"]["outputs"][rid],
                              toks), rid


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_mesh_data_axis(params, jax_ref, one_rank, shape, tmp_path):
    """The data axis cuts the classic batch: each data rank serves 2 of
    the 4 prompts, and the tokens gathered are the whole batch's."""
    named = {m: _classic(m, params) for m in ("fp", "int", "w8a8")}
    _held(named, *_on_mesh(shape, named, tmp_path, one_rank, "smoke"),
          jax_ref)


def test_mesh_1x4_four_kv_heads(one_rank, tmp_path):
    """Four ranks, one KV head (and one query head) each."""
    p = _params({"dtype": "float32", "n_kv_heads": 4})
    named = {"int": _classic("int", p, n_kv_heads=4),
             "int engine": _engine("int", p, n_kv_heads=4)}
    _held(named, *_on_mesh((1, 4), named, tmp_path, one_rank, "kv4"))


def test_refusals_without_processes(tmp_path):
    # a model axis that does not divide qwen3's 8 KV heads, at build time
    with pytest.raises(NotImplementedError, match="must divide"):
        tserve.serve("qwen3_1_7b", smoke=False, mesh_shape=(1, 16),
                     device="cpu")
    with pytest.raises(NotImplementedError, match="must divide"):
        tsteps.build_ragged_step(get_config("qwen3_1_7b"), QuantContext(),
                                 mesh=tmesh.RankMesh(1, 16))
    with pytest.raises(NotImplementedError, match="attn_shard_axis"):
        tserve.serve_engine("qwen3_1_7b", mesh_shape=(1, 2), device="cpu",
                            cfg_overrides={"attn_shard_axis": "data"})
    # MLA's kernels run with as many KV heads as query heads
    with pytest.raises(NotImplementedError, match="n_heads for MLA"):
        tserve._resolve_cfg_mesh("deepseek_v3_671b", smoke=False,
                                 mesh_shape=(1, 3))
    # whisper on (1, 2) and RWKV6 on (2, 1) serve (their rank views: the
    # heads and d_ff halved; the batch alone cut) and train on the same
    # rank views
    for arch, shape in (("whisper_large_v3", (1, 2)),
                        ("rwkv6_3b", (2, 1))):
        cfg, got = tserve._resolve_cfg_mesh(arch, smoke=True,
                                            mesh_shape=shape)
        assert got == shape
        loc = tshd.local_config(cfg, tmesh.RankMesh(*shape))
        m = shape[1]
        assert (loc.n_heads, loc.n_kv_heads, loc.d_ff) == (
            cfg.n_heads // m, cfg.n_kv_heads // m, cfg.d_ff // m)
        assert tshd.local_config(cfg, tmesh.RankMesh(*shape),
                                 train=True) == loc
    with pytest.raises(ValueError, match="eagerly"):
        tserve.serve("qwen3_1_7b", mesh_shape=(1, 2), graphs=True,
                     device="cpu")
    with pytest.raises(ValueError, match="captured"):
        tsteps.StepGraphs("cpu", capture=True, graph_factory=object,
                          mesh=tmesh.RankMesh(1, 2))
    # nccl on the CPU's ranks (a world of one)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="gloo"):
            tmesh.make_local_mesh(1, device="cpu", backend="nccl")
        one = tmesh.make_local_mesh(1, device="cpu", backend="gloo")
        assert one.shape == {"data": 1, "model": 1} and one.size == 1
    finally:
        dist.destroy_process_group()
    assert tmesh.parse_mesh("2X4") == (2, 4)
    with pytest.raises(ValueError):
        tmesh.parse_mesh("2x")
