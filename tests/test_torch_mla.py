"""Differential tests of DeepSeek's multi-head latent attention and of
deepseek_v3_671b's classic path against the JAX package, on its smoke
weights (one dense layer, then MoE layers with a shared expert; MLA in
both) carried over by ``from_jax_params``, fp32 unless stated:

* ``mla_attention`` expanded (no cache: K5's plain version on the CPU,
  ``attn_kernel`` 'flash' and 'chunked') and absorbed (a prefill into an
  ``MLACache`` and decode steps at a device position): FP within 1e-5,
  INT within 2e-6 (its ``wo`` input is the absorbed float path's output,
  which the two packages sum in other orders; every qlinear output on
  the same input is identical, ``tests/test_torch_moe.py``), the latent
  cache within 1e-5;
* ``init_cache`` (``kv`` and ``kv_dense`` as ``MLACache`` in the model
  dtype, whatever ``kv_cache_bits``): layout and dtypes;
* ``forward`` / ``prefill`` / ``decode_step`` in FP (logits within 1e-5)
  and INT (identical), calibration tables identical (``mla/*``, ``mlp/*``
  and ``moe/shared/*``; no expert captured), classic ``serve`` token-
  identical to the JAX prefill + decode loop in FP and calibrated INT,
  and through the stand-in graph (the key naming ``kv`` and ``kv_dense``)
  token-identical to eager;
* a calibrated INT forward over the pre-quantized tree (``mla/*`` grids,
  ``wkv_b`` and the router float) equal to the on-the-fly one bit for
  bit, where the default rule breaks it;
* the families the classic path does not take, and the engines' refusal
  of ``moe``.

The JAX calibration is held by the module-scoped ``calibrated`` fixture.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.core.qmodel import QuantContext as JCtx  # noqa: E402
from repro.core.qmodel import QuantMode as JMode  # noqa: E402
from repro.models import attention as jatt  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.core.qmodel import QuantContext as TCtx  # noqa: E402
from repro_torch.core.qmodel import QuantMode as TMode  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import attention as tatt  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.common import rope_tables  # noqa: E402
from tests.test_torch_recurrent_blocks import tcfg_of  # noqa: E402
from tests.test_torch_moe import (BATCH, GEN, INT_TOL, PROMPT, TOL,  # noqa
                                  calib_tokens, calibrate_both, cfgs, close,
                                  forward_prefill_decode, layer,
                                  prequantized_equals_on_the_fly,
                                  same_layout, serve_against_jax_loop,
                                  serve_through_stand_in_graph, t_, table,
                                  tparams, weights)
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

ARCH = "deepseek_v3_671b"


def _rope(tcfg, positions):
    return rope_tables(positions, tcfg.mla.qk_rope_head_dim,
                       tcfg.rope_theta, torch.float32)


@pytest.mark.parametrize("mode", ["fp", "int"])
@pytest.mark.parametrize("attn_kernel", ["flash", "chunked"])
def test_mla_expanded_matches_jax(mode, attn_kernel):
    jcfg, tcfg = cfgs(ARCH, attn_kernel=attn_kernel)
    jp, _ = weights(ARCH)
    tp = tparams(ARCH, tcfg)
    x = np.random.default_rng(21).standard_normal(
        (3, 19, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(19), (3, 19))
    jctx, tctx = JCtx(mode=JMode(mode)), TCtx(mode=TMode(mode))
    jmla = jax.jit(lambda p, x, pos: jatt.mla_attention(
        jctx, p, x, jcfg, positions=pos))
    for stack, i in (("dense_blocks", 0), ("blocks", 1)):
        jo, jc = jmla(layer(jp[stack], i)["attn"], jnp.asarray(x),
                      jnp.asarray(pos))
        with torch.no_grad():
            to, tc = tatt.mla_attention(
                tctx, tp[stack][i]["attn"], t_(x), tcfg,
                rope=_rope(tcfg, t_(pos)))
        assert jc is None and tc is None
        close(to, jo, f"expanded {stack}", **(TOL if mode == "fp"
                                              else INT_TOL))


@pytest.mark.parametrize("mode", ["fp", "int"])
def test_mla_absorbed_matches_jax(mode):
    """A 13-token prefill into a 20-position latent cache, then decode
    steps at positions 13..15 (a 0-d device tensor on the port), each
    token's output and the cache against the reference's."""
    jcfg, tcfg = cfgs(ARCH)
    jp, _ = weights(ARCH)
    tp = tparams(ARCH, tcfg)
    m = tcfg.mla
    rng = np.random.default_rng(22)
    b, s, s_max = 2, 13, 20
    x = rng.standard_normal((b, 16, jcfg.d_model)).astype(np.float32)
    jctx, tctx = JCtx(mode=JMode(mode)), TCtx(mode=TMode(mode))
    jp_l, tp_l = layer(jp["blocks"], 0)["attn"], tp["blocks"][0]["attn"]
    jc = jatt.MLACache(jnp.zeros((b, s_max, m.kv_lora_rank)),
                       jnp.zeros((b, s_max, m.qk_rope_head_dim)))
    tc = tatt.MLACache(torch.zeros((b, s_max, m.kv_lora_rank)),
                       torch.zeros((b, s_max, m.qk_rope_head_dim)))
    tol = TOL if mode == "fp" else INT_TOL
    steps = [(0, s)] + [(p, 1) for p in range(s, 16)]
    jmla = jax.jit(lambda p, x, pos, c, start: jatt.mla_attention(
        jctx, p, x, jcfg, positions=pos, cache=c, cache_pos=start))
    for start, n in steps:
        pos = np.broadcast_to(np.arange(start, start + n), (b, n))
        xs = x[:, start:start + n]
        jo, jc = jmla(jp_l, jnp.asarray(xs), jnp.asarray(pos), jc,
                      jnp.asarray(start, jnp.int32))
        with torch.no_grad():
            to, tc_out = tatt.mla_attention(
                tctx, tp_l, t_(xs), tcfg, rope=_rope(tcfg, t_(pos)),
                cache=tc,
                cache_pos=torch.tensor(start, dtype=torch.int32)
                if start else 0)
        assert tc_out is tc                     # written in place
        close(to, jo, f"absorbed at {start}", **tol)
        close(tc.c_kv, jc.c_kv, f"c_kv at {start}")
        close(tc.k_pe, jc.k_pe, f"k_pe at {start}")
    assert not tc.c_kv[:, 16:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_bits", [None, 8])
def test_init_cache_matches_jax(dtype, kv_bits):
    jcfg = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype,
                               kv_cache_bits=kv_bits)
    tc = TM.init_cache(tcfg_of(jcfg), 3, 10, device="cpu")
    assert set(tc) == {"kv", "kv_dense"}
    assert isinstance(tc["kv"], tatt.MLACache)
    same_layout(tc, JM.init_cache(jcfg, 3, 10), values=True)


@pytest.mark.parametrize("mode", ["fp", "int"])
def test_forward_prefill_decode_match_jax(mode):
    jcfg, tcfg = cfgs(ARCH)
    forward_prefill_decode(ARCH, jcfg, tcfg, mode)


@pytest.fixture(scope="module")
def calibrated():
    jcfg, tcfg = cfgs(ARCH)
    return calibrate_both(ARCH, jcfg, tcfg)


def test_calibrate_matches_jax(calibrated):
    jctx, jrep, tctx, trep = calibrated
    assert list(tctx.table) == list(jctx.table)
    assert list(trep.results) == list(jrep.results)
    assert table(tctx) == table(jctx)
    mla = [f"mla/{w}" for w in ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo")]
    assert list(tctx.table) == mla + ["mlp/w1", "mlp/w3", "mlp/w2",
                                      "moe/shared/w1", "moe/shared/w3",
                                      "moe/shared/w2", "lm_head"]
    assert tctx.table["mlp/w2"].n_x == tctx.table["mlp/w1"].n_o


@pytest.mark.parametrize("mode", ["fp", "int"])
def test_serve_matches_jax_loop(mode, calibrated):
    jcfg, tcfg = cfgs(ARCH)
    serve_against_jax_loop(ARCH, jcfg, tcfg, mode, calibrated[0])


def test_serve_through_stand_in_graph():
    _, tcfg = cfgs(ARCH)
    serve_through_stand_in_graph(ARCH, tcfg)
    cache = TM.init_cache(tcfg, BATCH, PROMPT + GEN, device="cpu")
    key = tsteps.serve_step_key(np.zeros((BATCH, 1)), cache)
    m = tcfg.mla
    assert key[:2] == ("decode", BATCH)
    assert dict(key[2]) == {
        "kv.c_kv": (2, BATCH, PROMPT + GEN, m.kv_lora_rank),
        "kv.k_pe": (2, BATCH, PROMPT + GEN, m.qk_rope_head_dim),
        "kv_dense.c_kv": (1, BATCH, PROMPT + GEN, m.kv_lora_rank),
        "kv_dense.k_pe": (1, BATCH, PROMPT + GEN, m.qk_rope_head_dim)}


def test_prequantized_tree_equals_on_the_fly(calibrated):
    _, tcfg = cfgs(ARCH)
    prequantized_equals_on_the_fly(ARCH, tcfg, calibrated[0],
                                   {"tokens": t_(calib_tokens()[:, :12])})


def test_family_refusals():
    """The serving engines refuse ``moe`` and the audio family (a whisper
    config), naming the classic path that serves them, as the reference's
    engines refuse them."""
    from repro_torch.configs import get_smoke_config as tsmoke
    _, tcfg = cfgs(ARCH)
    audio = tsmoke("whisper_large_v3")
    for cfg, fam in ((tcfg, "moe"), (audio, "audio")):
        for fn, args in ((TM.init_paged_cache, (cfg, 4, 16)),
                         (TM.init_paged_state, (cfg, 4))):
            with pytest.raises(NotImplementedError,
                               match=f"'{fam}' family.*classic path"):
                fn(*args, device="cpu")
