"""The audio family (whisper-large-v3) served through classic ``serve``
on a (data, model) mesh of spawned gloo ranks, against one rank of the
port and the JAX package's single-device ``serve``, on the fp32 smoke
config with the JAX weights (attention biases drawn from a seed,
``tests/test_torch_whisper.py``'s ``weights``), flash attention (K5 / K6's
plain versions here), 4 x 12 prompt with its stub frame embeddings, 5
tokens:

* uncalibrated INT on (1, 2) and (2, 1) (the data axis cuts the tokens
  and the encoder features alike): greedy tokens the JAX package's
  ``serve``'s, every step's logits bit-identical to one rank's.  These
  run with the reference's attention in the port's plain K5 / K6
  (``test_torch_whisper.reference_attention``: through whisper's encoder
  the port's own fp32 attention order moves INT codes, ROADMAP Queue 3);
* calibrated INT on (1, 2), the port's own attention: bit-identical to
  one rank, its table one rank's;
* fp32 FP on (1, 2): tokens the JAX package's, logits within 1e-5 of one
  rank's; bf16 FP on (1, 2) held to one rank whose every product is
  taken in the mesh's order (``recurrent_mesh_cases.mesh_order``);
* the rank's view and slices: heads, KV heads and d_ff halved, the cross
  attention's columns and biases cut with their heads, the memory whole.

The engines refuse the audio family, as the reference's do
(``tests/test_torch_whisper_serve.py``).  One spawn of two ranks runs every
mesh case; this process runs the one-rank cases and the JAX package
meanwhile.
"""
import concurrent.futures
import copy
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from repro.launch import serve as jserve  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from tests import recurrent_mesh_cases as cases_lib  # noqa: E402
from tests.test_torch_recurrent_mesh import BF16_REL, FP_TOL, _cast  # noqa
from tests.test_torch_whisper import ARCH, cfgs, tparams, weights  # noqa
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

CLASSIC = dict(batch=4, prompt_len=12, gen=5, attn_kernel="flash")
NAMES = ["int 1x2", "int 2x1", "int calibrated 1x2", "fp32 1x2",
         "bf16 fp 1x2"]


@functools.lru_cache(maxsize=None)
def _params(dtype="float32"):
    tree = tparams(cfgs()[1])
    return tree if dtype == "float32" else _cast(tree, torch.bfloat16)


def _case(mode, model_axis, dtype="float32", **kw):
    case = dict(kind="serve", arch=ARCH, mode=mode, calibrate=False,
                cfg_overrides={"dtype": dtype}, params=_params(dtype),
                model_axis=model_axis, **CLASSIC)
    case.update(kw)
    return case


def _cases() -> dict:
    return {"int 1x2": _case("int", 2, xla_attention=True),
            "int 2x1": _case("int", 1, xla_attention=True),
            "int calibrated 1x2": _case("int", 2, calibrate=True),
            "fp32 1x2": _case("fp", 2),
            "bf16 fp 1x2": _case("fp", 2, "bfloat16")}


def _jax_serve(mode):
    return np.asarray(jserve.serve(
        ARCH, mode=mode, calibrate=False, params=weights()[0],
        cfg_overrides={"dtype": "float32"}, **CLASSIC)["tokens"])


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    named = _cases()
    assert list(named) == NAMES
    # the ranks' own copy (a tensor sent to a spawned process moves to
    # shared memory)
    rank_cases = copy.deepcopy(list(named.values()))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(tmesh.run_ranks, cases_lib.run_cases, (1, 2),
                          device="cpu", backend="gloo",
                          kwargs={"cases": rank_cases},
                          workdir=str(tmp_path_factory.mktemp("mesh")),
                          threads=1)
        ones = {}
        for name, case in named.items():
            if case["cfg_overrides"]["dtype"] == "bfloat16":
                case = dict(case, mesh_order=2)
            ones[name] = cases_lib.run(
                {k: v for k, v in case.items() if k != "model_axis"},
                device="cpu")
        jax_ref = {mode: _jax_serve(mode) for mode in ("int", "fp")}
        ranks = fut.result(timeout=600)
    return {"ranks": {k: [r[i] for r in ranks]
                      for i, k in enumerate(named)},
            "ones": ones, "jax": jax_ref}


@pytest.mark.parametrize("name", NAMES)
def test_ranks_held_to_one_rank(results, name):
    """Every rank's tokens one rank's; INT's every step's logits
    bit-identical, fp32 FP's within FP_TOL, bf16 FP's within BF16_REL of
    the largest |logit| of one rank with every product in the mesh's
    order; the
    calibrated table one rank's."""
    one, got = results["ones"][name], results["ranks"][name]
    scale = max(float(t.abs().max()) for t in one["logits"])
    for r, res in enumerate(got):
        assert np.array_equal(res["tokens"], one["tokens"]), (name, r)
        assert len(res["logits"]) == len(one["logits"]) == 5
        for a, b in zip(res["logits"], one["logits"]):
            if name.startswith("int"):
                assert torch.equal(a, b), (name, r)
            else:
                tol = BF16_REL * scale if "bf16" in name else FP_TOL
                err = float((a - b).abs().max())
                assert err <= tol, (name, r, err)
        assert res["table"] == one["table"], (name, r)
    assert not any(got[0]["launches"].values())


@pytest.mark.parametrize("name", ["int 1x2", "int 2x1", "fp32 1x2"])
def test_tokens_equal_jax(results, name):
    want = results["jax"]["int" if name.startswith("int") else "fp"]
    assert want.shape == (4, 5)
    for res in results["ranks"][name]:
        assert np.array_equal(res["tokens"], want), name


def test_rank_view_and_cut():
    """(1, 2): 2 of the 4 heads (KV heads too) and half of d_ff a rank;
    the rank's cross-attention columns and biases are its heads'; the
    cache holds the rank's KV heads and the whole memory."""
    cfg = cfgs()[1]
    mesh = tmesh.RankMesh(1, 2)
    loc = shd.local_config(cfg, mesh)
    assert (loc.n_heads, loc.n_kv_heads, loc.d_ff, loc.resolved_head_dim,
            loc.d_model) == (cfg.n_heads // 2, cfg.n_kv_heads // 2,
                             cfg.d_ff // 2, cfg.resolved_head_dim,
                             cfg.d_model)
    params = _params()
    rank = shd.shard_params(params, mesh, {"data": 0, "model": 1}, cfg=cfg)
    half = cfg.n_heads // 2 * cfg.resolved_head_dim
    whole = params["blocks"][0]["cross"]
    got = rank["blocks"][0]["cross"]
    assert torch.equal(got["wk"], whole["wk"][:, half:])
    assert torch.equal(got["bk"], whole["bk"][half:])
    assert torch.equal(got["wo"], whole["wo"][half:])
    assert tuple(rank["enc_blocks"][0]["mlp"]["w1"].shape) == (
        cfg.d_model, cfg.d_ff // 2)
    cache = TM.init_cache(cfg, 4, 16, device="cpu", mesh=mesh)
    assert cache["kv"].k.shape[3] == cfg.n_kv_heads // 2
    assert tuple(cache["memory"].shape) == (4, cfg.encdec.encoder_seq,
                                            cfg.d_model)
