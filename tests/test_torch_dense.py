"""Differential tests: the port's classic dense-cache path against the JAX
package's, on the same numpy inputs and the JAX package's own weights.

* K5 / K6's plain versions (``kernels.ops.flash_attention`` /
  ``flash_decode`` on CPU tensors) against the JAX package's
  ``ops.flash_attention`` / ``ops.flash_decode`` with their Pallas bodies
  interpreted, at the shapes of ``tests/test_flash_attention.py`` the
  port's causal q_offset-0 prefill covers, within 2e-5 (fp32 sums in
  other orders);
* ``model.forward`` (no cache) logits in FP, FAKE, FAKE_SF (the
  scaling-factor baseline) and INT mode within 1e-5 (FAKE_SF with the
  reference's rms statistic patched in, see ``_xla_rms``), and ``prefill`` plus four ``decode_step``s for attn_kernel
  {chunked, flash} x KV {float, int8} x mode {fp, int}: logits within
  1e-5, int8 caches identical;
* ``launch.serve.serve(device="cpu")`` gives the JAX ``serve``'s greedy
  tokens exactly, uncalibrated FP and FAKE_SF (the rms statistic
  patched as above) and Algorithm-1-calibrated FAKE / INT, over both
  attention kernels and both cache types.
All on the fp32 qwen3 smoke config.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.core.lm_calibrate import calibrate_lm as jcalibrate_lm  # noqa: E402
from repro.core.qmodel import QuantContext as JCtx  # noqa: E402
from repro.core.qmodel import QuantMode as JMode  # noqa: E402
from repro.core.qscheme import quant as jquant  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.qmodel import ModuleBits  # noqa: E402
from repro_torch.core.qmodel import QuantContext as TCtx  # noqa: E402
from repro_torch.core.qmodel import QuantMode as TMode  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from tests.test_torch_model import _xla_inv_rms  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

jnp = jax.numpy
NKV = 4


def _qkv(seed, b, sq, skv, h, kvh, d, int8_kv):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, kvh, d)).astype(np.float32)
    if int8_kv:
        k = np.array(jquant(jnp.asarray(k), NKV, 8))
        v = np.array(jquant(jnp.asarray(v), NKV, 8))
    return q, k, v


@pytest.mark.parametrize("b,sq,skv,h,kvh", [(2, 256, 256, 4, 4),
                                            (2, 256, 256, 4, 1),
                                            (1, 200, 333, 4, 2)])
@pytest.mark.parametrize("int8_kv", [False, True])
def test_flash_prefill_plain_vs_pallas(b, sq, skv, h, kvh, int8_kv):
    q, k, v = _qkv(7 + sq, b, sq, skv, h, kvh, 64, int8_kv)
    nkv = NKV if int8_kv else None
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True,
                                kv_frac_bits=nkv)
    got = tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), kv_frac_bits=nkv)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("pos", [0, 127, 128, 255])
@pytest.mark.parametrize("int8_kv", [False, True])
def test_flash_decode_plain_vs_pallas(pos, int8_kv):
    b, s_max, h, kvh, d = 2, 256, 8, 2, 128
    q, k, v = _qkv(pos, b, 1, s_max, h, kvh, d, int8_kv)
    nkv = NKV if int8_kv else None
    want = jops.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             pos=jnp.asarray(pos, jnp.int32),
                             kv_frac_bits=nkv)
    got = tops.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), pos=pos, kv_frac_bits=nkv)
    assert got.shape == want.shape == (b, 1, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_flash_wrappers_require_frac_bits_for_codes():
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, 1, 4, 4, 2, 1, 8, True))
    with pytest.raises(ValueError, match="kv_frac_bits"):
        tops.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="kv_frac_bits"):
        tops.flash_decode(q[:, :1], k, v, pos=2)


# --- the model -------------------------------------------------------------

def _cfgs(**kw):
    jcfg = dataclasses.replace(get_smoke_config("qwen3_1_7b"),
                               dtype="float32", **kw)
    tcfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})
    return jcfg, tcfg


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _cfgs()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    npt = jax.tree.map(np.asarray, jparams)
    tokens = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, size=(3, 12)).astype(np.int32)
    jctx, _ = jcalibrate_lm(lambda p, b, c: JM.forward(p, b, jcfg, c),
                            jparams, {"tokens": jnp.asarray(tokens)})
    table = {k: ModuleBits(**dataclasses.asdict(v))
             for k, v in jctx.table.items()}
    return dict(npt=npt, tokens=tokens, jtable=jctx.table, table=table)


def _xla_rms(monkeypatch, mode):
    """FAKE_SF's per-tensor scale is max|x| / 127, so the known last-bit
    departure of the port's rms statistic (``models.common.inv_rms``,
    ROADMAP Queue 3) moves the scale of every normed activation whose
    largest element it touches, and with it codes all over the tensor:
    on this forward 1791 of 9216 logits move beyond 1e-5 (max 0.057).
    The FAKE_SF cases therefore run with the reference's statistic, which
    isolates the baseline's own arithmetic (bit-exact,
    ``tests/test_torch_baselines.py``)."""
    if mode == "fake_sf":
        from repro_torch.models import common
        monkeypatch.setattr(common, "inv_rms", _xla_inv_rms)


def _ctxs(weights, mode):
    if mode == "fp":
        return JCtx(), TCtx()
    return (JCtx(mode=JMode(mode), table=weights["jtable"]),
            TCtx(mode=TMode(mode), table=weights["table"]))


@pytest.mark.parametrize("mode", ["fp", "fake", "fake_sf", "int"])
def test_forward_matches_jax(weights, mode, monkeypatch):
    _xla_rms(monkeypatch, mode)
    jcfg, tcfg = _cfgs()
    jctx, tctx = _ctxs(weights, mode)
    jl, _ = JM.forward(jax.tree.map(jnp.asarray, weights["npt"]),
                       {"tokens": jnp.asarray(weights["tokens"])}, jcfg, jctx)
    tl, cache = TM.forward(TM.from_jax_params(weights["npt"], tcfg,
                                              device="cpu"),
                           {"tokens": torch.from_numpy(weights["tokens"])},
                           tcfg, tctx)
    assert cache is None and tl.shape == jl.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mode", ["fp", "int"])
@pytest.mark.parametrize("kv_bits", [None, 8])
@pytest.mark.parametrize("attn_kernel", ["chunked", "flash"])
def test_prefill_decode_matches_jax(weights, mode, kv_bits, attn_kernel):
    jcfg, tcfg = _cfgs(kv_cache_bits=kv_bits, attn_kernel=attn_kernel)
    jctx, tctx = _ctxs(weights, mode)
    jp = jax.tree.map(jnp.asarray, weights["npt"])
    tp = TM.from_jax_params(weights["npt"], tcfg, device="cpu")
    prompt = weights["tokens"][:, :8]
    steps = np.random.default_rng(9).integers(
        0, jcfg.vocab_size, size=(4, 3, 1)).astype(np.int32)
    max_seq = 16
    jl, jc = JM.prefill(jp, {"tokens": jnp.asarray(prompt)}, jcfg, jctx,
                        max_seq=max_seq)
    prefill = tsteps.build_prefill_step(tcfg, tctx, max_seq=max_seq)
    tl, tc = prefill(tp, {"tokens": torch.from_numpy(prompt)})
    pairs = [(tl, jl)]
    for i, tok in enumerate(steps):
        pos = prompt.shape[1] + i
        jl, jc = JM.decode_step(jp, jnp.asarray(tok), jc,
                                jnp.asarray(pos, jnp.int32), jcfg, jctx)
        tl, tc = TM.decode_step(tp, torch.from_numpy(tok), tc, pos, tcfg,
                                tctx)
        pairs.append((tl, jl))
    for t, j in pairs:
        assert t.shape == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)
    want_dt = torch.int8 if kv_bits == 8 else torch.float32
    for t_arr, j_arr in zip(tc["kv"], jc["kv"]):
        assert t_arr.dtype == want_dt and t_arr.shape == j_arr.shape
        if kv_bits == 8:
            assert np.array_equal(t_arr.numpy(), np.asarray(j_arr))
            assert torch.count_nonzero(t_arr[:, :, :12]) > 0
            assert torch.count_nonzero(t_arr[:, :, 12:]) == 0
        else:
            np.testing.assert_allclose(t_arr.numpy(), np.asarray(j_arr),
                                       rtol=1e-5, atol=1e-5)
    assert all(n == 0 for n in tops.LAUNCHES.values())   # CPU: plain path


SERVE_CASES = [("fp", "chunked", None), ("fp", "flash", 8),
               ("fake", "chunked", 8), ("fake", "flash", None),
               ("int", "chunked", None), ("int", "flash", 8),
               ("fake_sf", "chunked", 8), ("fake_sf", "flash", 8)]
# FAKE_SF over an fp32 cache has no case: there a last-bit difference in
# the attention output flips a code on its per-tensor grid at the first
# decode steps, and the JAX package's own chunked and flash paths give 38
# different tokens of 64 (ROADMAP Queue 3); over the int8 cache they agree


@pytest.mark.parametrize("mode,attn_kernel,kv_bits", SERVE_CASES)
def test_serve_tokens_identical(mode, attn_kernel, kv_bits, monkeypatch):
    _xla_rms(monkeypatch, mode)
    overrides = {"dtype": "float32", "kv_cache_bits": kv_bits}
    jcfg, tcfg = _cfgs(attn_kernel=attn_kernel, kv_cache_bits=kv_bits)
    kw = dict(mode=mode, attn_kernel=attn_kernel, cfg_overrides=overrides)
    jo = jserve.serve("qwen3_1_7b", **kw)
    params = TM.from_jax_params(
        jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0))),
        tcfg, device="cpu")
    to = tserve.serve("qwen3_1_7b", params=params, device="cpu", **kw)
    assert to["tokens"].shape == (4, 16)
    assert np.array_equal(to["tokens"], np.asarray(jo["tokens"]))
    if mode in ("fp", "fake_sf"):
        assert to["report"] is None
    else:
        assert {k: dataclasses.astuple(v) for k, v in to["ctx"].table.items()} \
            == {k: dataclasses.astuple(v) for k, v in jo["ctx"].table.items()}
    assert to["ctx"].mode is TMode(mode)
