"""The recurrent families (rwkv6-3b, family ``ssm``; zamba2-2.7b, family
``hybrid``) served on a (data, model) mesh of spawned gloo ranks, against
one rank of the port and the JAX package's single-device runs, on the
smoke configs with the JAX package's weights (``from_jax_params``):

* classic ``serve`` (4 x 12 prompt, 5 tokens; zamba2's shared block over
  an int8 dense cache): uncalibrated INT on (1, 2) and (2, 1), and fp32
  FP on (1, 2), greedy tokens equal to the JAX package's ``serve`` on the
  same weights; INT's every step's logits bit-identical to one rank's,
  fp32 FP's within 1e-5 (the row-cut modules' fp32 partials summed in
  another order); calibrated INT on (1, 2) bit-identical to one rank,
  with its table; bf16 FP on (1, 2) held to one rank whose every product
  is taken in the mesh's order (``recurrent_mesh_cases.mesh_order``: the
  row-cut sums and the column-cut blocks): tokens identical, every step's
  logits within ``BF16_REL`` of the largest |logit|;
* the fixed-slab engine on (1, 2) (the JAX recurrent tests' workload: 4
  requests through 2 slots, chunk 8, 4-row blocks, on the recorder's
  virtual clock): uncalibrated INT and fp32 FP token-identical to the JAX
  package's ``serve_engine`` on the same requests and weights and to one
  rank's engine, INT's and W8A8's first-step logits bit-identical to one
  rank's, FP's within 1e-5; every rank's scheduler decisions one rank's;
* RWKV6 on the slab engine on (1, 2), fp32 and int8 slabs, one request
  preempted after its 4th token (its slab snapshot to the host and back
  on every rank): tokens one rank's preempted run's, which
  ``test_torch_recurrent_serving.py`` holds to the JAX engine's;
* each rank's K2 launches: the rank-split form's partials and finishes
  (none on the CPU, where each wrapper takes its plain version; the
  chip script counts them on the card).

One spawn of two ranks runs every mesh case (the (2, 1) ones on the same
ranks, ``recurrent_mesh_cases.run_cases``' ``model_axis``); this process
runs the one-rank cases and the JAX package meanwhile.
"""
import concurrent.futures
import copy
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from repro.launch import serve as jserve  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving.scheduler import Request as TRequest  # noqa: E402
from tests import recurrent_mesh_cases as cases_lib  # noqa: E402
from tests.test_torch_recurrent_blocks import tcfg_of  # noqa: E402
from tests.test_torch_recurrent_serving import (ENGINE, _jax_weights,  # noqa
                                                _weights, _workload)
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

ARCHS = ["rwkv6_3b", "zamba2_2_7b"]
CLASSIC = dict(batch=4, prompt_len=12, gen=5)
FP_TOL = 1e-5
# bf16 FP on the mesh against one rank with every product in the mesh's
# order: every step's logits within this share of the largest
# |logit| (measured on the CPU: bit-identical)
BF16_REL = 1e-2


def _overrides(arch, dtype="float32"):
    kv = {"kv_cache_bits": 8} if arch.startswith("zamba") else {}
    return dict(dtype=dtype, **kv)


@functools.lru_cache(maxsize=None)
def _params(arch, dtype="float32"):
    """The JAX smoke weights (fp32) as the port's; ``bfloat16``: cast."""
    jcfg, _, npt = _weights(arch)
    tree = TM.from_jax_params(npt, tcfg_of(jcfg), device="cpu")
    if dtype == "float32":
        return tree
    return _cast(tree, getattr(torch, dtype))


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype) if tree.dtype == torch.float32 else tree


def _classic(arch, mode, model_axis, **kw):
    case = dict(kind="serve", arch=arch, mode=mode, calibrate=False,
                cfg_overrides=_overrides(arch), params=_params(arch),
                model_axis=model_axis, **CLASSIC)
    case.update(kw)
    return case


def _engine(arch, model_axis=2, **kw):
    case = dict(kind="engine", arch=arch, requests=_workload(
        TRequest, 256), cfg_overrides=_overrides(arch, "float32"),
        kv_bits=8, record=True, params=_params(arch),
        model_axis=model_axis, **ENGINE)
    case.update(kw)
    return case


def _cases() -> dict:
    """(arch, name) -> the case, in ``CASES``' order; bf16 FP's weights
    are the fp32 ones cast to bf16."""
    out = {}
    for arch in ARCHS:
        out[arch, "int 1x2"] = _classic(arch, "int", 2)
        out[arch, "int 2x1"] = _classic(arch, "int", 1)
        out[arch, "fp32 1x2"] = _classic(arch, "fp", 2)
        out[arch, "int calibrated 1x2"] = _classic(arch, "int", 2,
                                                  calibrate=True)
        out[arch, "bf16 fp 1x2"] = _classic(
            arch, "fp", 2, cfg_overrides=_overrides(arch, "bfloat16"),
            params=_params(arch, "bfloat16"))
        out[arch, "engine int"] = _engine(arch, mode="int", calibrate=False)
        out[arch, "engine fp32"] = _engine(arch, mode="fp")
        out[arch, "engine w8a8"] = _engine(arch, w8a8=True)
    for bits in (None, 8):
        out["rwkv6_3b", f"preempt state_bits {bits}"] = dict(
            kind="preempt", arch="rwkv6_3b", params=_params("rwkv6_3b"),
            cfg_overrides=dict(dtype="float32", state_bits=bits),
            prompt=np.random.default_rng(3).integers(
                0, 256, size=19).astype(np.int32),
            engine=ENGINE, model_axis=2)
    return out


NAMES = ["int 1x2", "int 2x1", "fp32 1x2", "int calibrated 1x2",
         "bf16 fp 1x2", "engine int", "engine fp32", "engine w8a8"]
PREEMPT = [("rwkv6_3b", f"preempt state_bits {bits}") for bits in (None, 8)]
CASES = [(arch, name) for arch in ARCHS for name in NAMES] + PREEMPT


def _one_rank_case(case: dict) -> dict:
    one = {k: v for k, v in case.items() if k != "model_axis"}
    if one.get("cfg_overrides", {}).get("dtype") == "bfloat16":
        one["mesh_order"] = 2
    return one


def _jax_classic(arch, mode):
    jcfg, jp, _ = _weights(arch)
    return np.asarray(jserve.serve(
        arch, mode=mode, calibrate=False, params=jp,
        cfg_overrides=_overrides(arch), **CLASSIC)["tokens"])


def _jax_engine(arch, mode):
    with _jax_weights(arch):
        jo = jserve.serve_engine(
            arch, requests=_workload(JRequest, 256), mode=mode,
            calibrate=False, cfg_overrides={"dtype": "float32"}, kv_bits=8,
            record=True, **ENGINE)
    return jo["outputs"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """{"ranks": [rank][case], "ones": name -> one rank's, "jax": ...}."""
    named = _cases()
    assert list(named) == CASES
    # the ranks' own copy: sending a tensor to a spawned process moves its
    # storage to shared memory, which must not race this thread's reads
    rank_cases = copy.deepcopy(list(named.values()))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(tmesh.run_ranks, cases_lib.run_cases, (1, 2),
                          device="cpu", backend="gloo",
                          kwargs={"cases": rank_cases},
                          workdir=str(tmp_path_factory.mktemp("mesh")),
                          threads=1)
        ones = {k: cases_lib.run(_one_rank_case(c), device="cpu")
                for k, c in named.items()}
        jax_ref = {}
        for arch in ARCHS:
            for mode in ("int", "fp"):
                jax_ref[arch, "classic", mode] = _jax_classic(arch, mode)
                jax_ref[arch, "engine", mode] = _jax_engine(arch, mode)
        ranks = fut.result(timeout=600)
    return {"ranks": {k: [r[i] for r in ranks]
                      for i, k in enumerate(named)},
            "ones": ones, "jax": jax_ref}


@pytest.mark.parametrize("key", PREEMPT, ids=[k[1] for k in PREEMPT])
def test_preemption_snapshot_on_mesh(results, key):
    one, got = results["ones"][key], results["ranks"][key]
    assert one["preempted"] and one["evictions"] == 1
    assert len(one["tokens"]) == 10
    for res in got:
        assert res["preempted"] and res["evictions"] == 1
        assert np.array_equal(res["tokens"], one["tokens"])


HELD = [k for k in CASES if k not in PREEMPT]


@pytest.mark.parametrize("key", HELD, ids=[" ".join(k) for k in HELD])
def test_ranks_held_to_one_rank(results, key):
    """Every rank's tokens one rank's; INT / W8A8 logits bit-identical,
    fp32 FP's within FP_TOL, bf16 FP's within BF16_REL of one rank with
    every product in the mesh's order; the calibrated table one rank's;
    an engine's admissions and recorded decisions one rank's."""
    arch, name = key
    one, got = results["ones"][key], results["ranks"][key]
    scale = max(float(t.abs().max()) for t in one["logits"])
    for r, res in enumerate(got):
        what = (arch, name, r)
        assert cases_lib.same_tokens(res, one), what
        assert len(res["logits"]) == len(one["logits"]), what
        for a, b in zip(res["logits"], one["logits"]):
            if "int" in name or "w8a8" in name:
                assert torch.equal(a, b), what
            else:
                tol = BF16_REL * scale if "bf16" in name else FP_TOL
                err = float((a - b).abs().max())
                assert err <= tol, (what, err)
        assert res["table"] == one["table"], what
        if name.startswith("engine"):
            assert res["steps"] == got[0]["steps"] == one["steps"], what
            assert res["decisions"] == one["decisions"], what
    # the CPU's ranks take every kernel's plain version
    assert not any(got[0]["launches"].values())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["int", "fp"])
@pytest.mark.parametrize("path", ["classic", "engine"])
def test_tokens_equal_jax(results, arch, mode, path):
    """The mesh's greedy tokens (classic (1, 2) and, INT, (2, 1); the
    engine's on (1, 2)) are the JAX package's single-device tokens."""
    want = results["jax"][arch, path, mode]
    if path == "classic":
        names = ["int 1x2", "int 2x1"] if mode == "int" else ["fp32 1x2"]
        for name in names:
            for res in results["ranks"][arch, name]:
                assert np.array_equal(res["tokens"], want), (arch, name)
        return
    got = results["ranks"][arch, "engine int" if mode == "int"
                           else "engine fp32"]
    for res in got:
        assert sorted(res["outputs"]) == sorted(want) == [0, 1, 2, 3]
        for rid, toks in want.items():
            assert np.array_equal(res["outputs"][rid], toks), (arch, rid)


@pytest.mark.parametrize("arch", ARCHS)
def test_rank_view_and_cut(arch):
    """The rank's view on (1, 2) and the leaves the rank holds: RWKV6 its
    time-mix projections' rows and the channel mix's hidden, its heads
    and d_model whole; zamba2 its shared block's heads and hidden, its
    Mamba projections cut (w_in's rows, w_out's columns)."""
    from repro_torch.distributed import sharding as shd
    cfg = tcfg_of(_weights(arch)[0])
    mesh = tmesh.RankMesh(1, 2)
    loc = shd.local_config(cfg, mesh)
    params = _params(arch)
    rank = shd.shard_params(params, mesh, {"data": 0, "model": 1}, cfg=cfg)
    d, ff = cfg.d_model, cfg.d_ff
    assert (loc.d_model, loc.d_ff, loc.vocab_size) == (d, ff // 2,
                                                      cfg.vocab_size)
    if arch == "rwkv6_3b":
        assert loc.n_heads == cfg.n_heads
        p = rank["blocks"][0]["rwkv"]
        assert tuple(p["wr"].shape) == (d // 2, d)
        assert tuple(p["wk_ffn"].shape) == (d, ff // 2)
        assert tuple(p["wv_ffn"].shape) == (ff // 2, d)
        assert tuple(p["wr_ffn"].shape) == (d, d // 2)
        assert torch.equal(p["wr"], params["blocks"][0]["rwkv"]["wr"][d // 2:])
    else:
        assert (loc.n_heads, loc.n_kv_heads) == (cfg.n_heads // 2,
                                                 cfg.n_kv_heads // 2)
        p = rank["blocks"][0]["ssm"]
        w_in = params["blocks"][0]["ssm"]["w_in"]
        assert tuple(p["w_in"].shape) == (d // 2, w_in.shape[1])
        assert tuple(p["w_out"].shape) == (2 * d, d // 2)
        assert tuple(rank["shared"]["in_proj"].shape) == (2 * d, d // 2)
        hd = cfg.resolved_head_dim
        assert tuple(rank["shared"]["attn"]["wq"].shape) == (
            d, cfg.n_heads // 2 * hd)
    # the states stay whole over the model axis; the hybrid's pool holds
    # the rank's KV heads
    one = TM.init_paged_state(cfg, 3, num_blocks=4, block_size=4,
                              device="cpu")
    loc_state = TM.init_paged_state(cfg, 3, num_blocks=4, block_size=4,
                                    device="cpu", mesh=mesh)
    for part in ("state", "ssm"):
        if part in one:
            a = one[part].values() if isinstance(one[part], dict) \
                else one[part]
            b = loc_state[part].values() if isinstance(loc_state[part],
                                                       dict) \
                else loc_state[part]
            assert [t.shape for t in a] == [t.shape for t in b]
    if "paged_kv" in one:
        assert loc_state["paged_kv"].k.shape[3] == \
            one["paged_kv"].k.shape[3] // 2
