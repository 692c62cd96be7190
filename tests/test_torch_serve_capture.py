"""The classic serve path's decode step as one captured step: K6 reading
its position on the device, the cache written at a device offset, and
``serve``'s decode loop through ``launch.steps.StepGraphs``.

* K6's plain version (``ops.flash_decode`` on CPU tensors) with ``pos`` a
  0-d int32 tensor equals the host-int call exactly and the JAX
  package's ``ops.flash_decode`` (Pallas body interpreted) within 2e-5,
  at positions 0, mid and last; its split twin over chunks planned for
  the whole cache (those past ``pos`` empty, weighed 0) matches the
  unsplit plain version within 1e-5;
* ``model.decode_step`` with a 0-d tensor ``pos`` is bit-identical to the
  host-int call, logits and caches, FP and INT over float and int8
  caches, and writes the cache prefill allocated in place;
* ``launch.serve.serve`` through a stand-in graph (``StubGraph``: the
  capture bookkeeping of ``StepGraphs`` without CUDA) is token-identical
  to the JAX ``serve`` over ``tests/test_torch_dense.py``'s
  ``SERVE_CASES`` (where ``serve(graphs=False)`` is held to the same
  tokens), with the eager run's launch counts (none on the CPU) and one
  eager first call, one capture and a replay for every later step.
All on the fp32 qwen3 smoke config.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.core.qscheme import quant as jquant  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.qmodel import (QuantContext, QuantMode,  # noqa: E402
                                     quantize_weight_tree)
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from tests.test_torch_dense import SERVE_CASES, _cfgs, _xla_rms  # noqa: E402
from tests.test_torch_step_capture import StubGraph  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

jnp = jax.numpy
NKV = 4
GEN = 8      # an eager first step, the capture, six replays


def _cache(seed, b, s_max, h, kvh, d, int8_kv):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s_max, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, s_max, kvh, d)).astype(np.float32)
    if int8_kv:
        k = np.array(jquant(jnp.asarray(k), NKV, 8))
        v = np.array(jquant(jnp.asarray(v), NKV, 8))
    return q, k, v


@pytest.mark.parametrize("pos", [0, 100, 255])
@pytest.mark.parametrize("int8_kv", [False, True])
def test_k6_plain_tensor_pos(pos, int8_kv):
    b, s_max, h, kvh, d = 2, 256, 8, 2, 128
    q, k, v = _cache(300 + pos, b, s_max, h, kvh, d, int8_kv)
    nkv = NKV if int8_kv else None
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    host = tops.flash_decode(tq, tk, tv, pos=pos, kv_frac_bits=nkv)
    dev_pos = torch.tensor(pos, dtype=torch.int32)
    got = tops.flash_decode(tq, tk, tv, pos=dev_pos, kv_frac_bits=nkv)
    assert got.shape == (b, 1, h, d) and torch.equal(got, host)
    want = jops.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             pos=jnp.asarray(pos, jnp.int32),
                             kv_frac_bits=nkv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    # four splits of 64 rows planned for the cache: at pos 0 three are
    # empty, at 100 two
    split = ref.flash_decode_split_ref(tq, tk, tv, pos=dev_pos, chunk=64,
                                       kv_frac_bits=nkv)
    np.testing.assert_allclose(split.numpy(), host.numpy(), atol=1e-5,
                               rtol=1e-5)


def _decode_cfg(kv_bits):
    return dataclasses.replace(get_smoke_config("qwen3_1_7b"),
                               dtype="float32", kv_cache_bits=kv_bits,
                               attn_kernel="flash")


@pytest.mark.parametrize("mode", ["fp", "int"])
@pytest.mark.parametrize("kv_bits", [None, 8])
def test_decode_step_tensor_pos_bit_identical(mode, kv_bits):
    cfg = _decode_cfg(kv_bits)
    params = TM.init_params(cfg, 0, device="cpu")
    ctx = QuantContext(mode=QuantMode(mode))
    if ctx.mode is QuantMode.INT:
        params = quantize_weight_tree(params, ctx)
    rng = np.random.default_rng(11)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(2, 8)).astype(np.int32))
    caches = []
    with torch.no_grad():
        for _ in range(2):
            _, c = TM.prefill(params, {"tokens": prompt}, cfg, ctx,
                              max_seq=12)
            caches.append(c)
        k_static = caches[1]["kv"].k
        for i in range(4):
            tok = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, size=(2, 1)).astype(np.int32))
            la, caches[0] = TM.decode_step(params, tok, caches[0], 8 + i,
                                           cfg, ctx)
            lb, caches[1] = TM.decode_step(
                params, tok, caches[1], torch.tensor(8 + i, dtype=torch.int32),
                cfg, ctx)
            assert torch.equal(la, lb)
        assert caches[1]["kv"].k is k_static     # written in place
        for a, b in zip(caches[0]["kv"], caches[1]["kv"]):
            assert torch.equal(a, b)
            assert torch.count_nonzero(a[:, :, 11]) > 0  # the last row too
        with pytest.raises(ValueError, match="outside the cache"):
            TM.decode_step(params, tok, caches[0], 12, cfg, ctx)
    assert all(n == 0 for n in tops.LAUNCHES.values())   # CPU: plain path


@pytest.mark.parametrize("mode,attn_kernel,kv_bits", SERVE_CASES)
def test_serve_through_stand_in_graph(mode, attn_kernel, kv_bits,
                                      monkeypatch):
    _xla_rms(monkeypatch, mode)
    jcfg, tcfg = _cfgs(attn_kernel=attn_kernel, kv_cache_bits=kv_bits)
    kw = dict(mode=mode, attn_kernel=attn_kernel, gen=GEN,
              cfg_overrides={"dtype": "float32", "kv_cache_bits": kv_bits})
    jo = jserve.serve("qwen3_1_7b", **kw)
    tops.reset_launch_counts()
    o = tserve.serve("qwen3_1_7b", params=TM.from_jax_params(
        jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0))),
        tcfg, device="cpu"), device="cpu", graphs=True,
        _graph_factory=StubGraph, **kw)
    assert o["tokens"].shape == (4, GEN)
    assert np.array_equal(o["tokens"], np.asarray(jo["tokens"]))
    assert not any(tops.LAUNCHES.values())
    assert o["graphs"] == dict(enabled=True, first_calls=1, captures=1,
                               replays=GEN - 2)
    assert o["compile_decode_s"] > 0 and o["decode_s_per_tok"] > 0
