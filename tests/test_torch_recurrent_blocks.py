"""Differential tests of the port's recurrent blocks against the JAX
package's, fp32, on the same numpy inputs from a seed and (for the
blocks) the JAX package's own smoke weights carried over by
``from_jax_params``:

* ``rwkv._wkv_chunked`` (a padded last chunk, a carried state);
* ``rwkv.rwkv6_block`` with ``valid`` and a carried state;
* ``ssm._causal_conv_train`` with a carried window;
* ``ssm._ssd_chunked`` (a padded last chunk, a carried state);
* ``ssm.mamba2`` with ``init_state`` and ``valid``, its conv window
  gathered per row.

Tolerance: atol = rtol = 1e-5 holds for every output (the two packages
sum the same fp32 products in other orders; the chunked forms multiply by
exponentials up to e^20 here, which the relative tolerance absorbs).  A
row with ``q_len == 0`` must pass its state through bit for bit, on the
port alone (its idle serving lanes rely on it).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.core.qmodel import QuantContext as JCtx  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core.qmodel import QuantContext as TCtx  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

TOL = dict(atol=1e-5, rtol=1e-5)


_SUB_CONFIGS = {"ssm": tbase.SSMConfig, "hybrid": tbase.HybridConfig,
                "moe": tbase.MoEConfig, "mla": tbase.MLAConfig,
                "encdec": tbase.EncDecConfig}


def tcfg_of(jcfg):
    """The port's ModelConfig for a JAX config (sub-configs converted)."""
    kw = {}
    for f in dataclasses.fields(tbase.ModelConfig):
        v = getattr(jcfg, f.name)
        if f.name in _SUB_CONFIGS and v is not None:
            v = _SUB_CONFIGS[f.name](**dataclasses.asdict(v))
        kw[f.name] = v
    return tbase.ModelConfig(**kw)


def _cfgs(arch):
    jcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    return jcfg, tcfg_of(jcfg)


def _params(arch):
    jcfg, tcfg = _cfgs(arch)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    npt = jax.tree.map(np.asarray, jp)
    return jcfg, tcfg, jp, TM.from_jax_params(npt, tcfg, device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=what, **TOL)


def test_wkv_chunked_matches_jax():
    rng = np.random.default_rng(0)
    b, s, h, d, chunk = 3, 40, 2, 64, 16        # 40 = 2 chunks + 8 padded
    r, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) * 0.5
               for _ in range(3))
    w_log = -rng.uniform(0.0, 1.65, (b, s, h, d)).astype(np.float32)
    u = rng.standard_normal((h, d)).astype(np.float32) * 0.1
    s0 = rng.standard_normal((b, h, d, d)).astype(np.float32)
    for init in (None, s0):
        jy, js = jrwkv._wkv_chunked(*(jnp.asarray(a) for a in
                                      (r, k, v, w_log, u)), chunk,
                                    None if init is None
                                    else jnp.asarray(init))
        ty, ts = trwkv._wkv_chunked(*(_t(a) for a in (r, k, v, w_log, u)),
                                    chunk, None if init is None else _t(init))
        _close(ty, jy, "wkv out")
        _close(ts, js, "wkv state")


def _rwkv_inputs(cfg, rng, b=3, s=12):
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    h = cfg.d_model // 64
    st = (rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32),
          rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32),
          rng.standard_normal((b, h, 64, 64)).astype(np.float32) * 0.1)
    valid = np.arange(s)[None, :] < np.asarray([s, 5, 0])[:, None]
    return x, st, valid


def test_rwkv6_block_matches_jax_with_valid_and_state():
    jcfg, tcfg, jp, tp = _params("rwkv6_3b")
    rng = np.random.default_rng(1)
    x, st, valid = _rwkv_inputs(tcfg, rng)
    jst = jrwkv.RWKVState(*(jnp.asarray(a) for a in st))
    tst = trwkv.RWKVState(*(_t(a) for a in st))
    jp0 = jax.tree.map(lambda a: a[0], jp["blocks"])["rwkv"]
    tp0 = tp["blocks"][0]["rwkv"]
    for vmask in (None, valid):
        jo, _, jn = jrwkv.rwkv6_block(
            JCtx(), jp0, jnp.asarray(x), jcfg, state=jst,
            valid=None if vmask is None else jnp.asarray(vmask))
        to, _, tn = trwkv.rwkv6_block(
            TCtx(), tp0, _t(x), tcfg, state=tst,
            valid=None if vmask is None else _t(vmask))
        _close(to, jo, "rwkv6_block out")
        _close(tn.wkv, jn.wkv, "rwkv6_block wkv")
    # the row with no valid token keeps its wkv state bit for bit
    assert torch.equal(tn.wkv[2], tst.wkv[2])
    cm_j = jrwkv.rwkv6_channel_mix(JCtx(), jp0, jnp.asarray(x), jcfg,
                                   x_prev=jst.x_prev_ffn)
    cm_t = trwkv.rwkv6_channel_mix(TCtx(), tp0, _t(x), tcfg,
                                   x_prev=tst.x_prev_ffn)
    _close(cm_t, cm_j, "rwkv6_channel_mix")


def test_rwkv_block_paged_passes_idle_rows_through():
    from repro_torch.models import transformer as ttfm
    _, tcfg, _, tp = _params("rwkv6_3b")
    x, st, valid = _rwkv_inputs(tcfg, np.random.default_rng(2))
    tst = trwkv.RWKVState(*(_t(a) for a in st))
    _, ns = ttfm.rwkv_block_paged(TCtx(), tp["blocks"][0], _t(x), tcfg,
                                  tst, _t(valid))
    for name in ("x_prev_att", "x_prev_ffn", "wkv"):
        assert torch.equal(getattr(ns, name)[2], getattr(tst, name)[2]), name


def test_causal_conv_matches_jax_with_carried_window():
    rng = np.random.default_rng(3)
    xbc = rng.standard_normal((2, 9, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    bias = rng.standard_normal((24,)).astype(np.float32)
    prev = rng.standard_normal((2, 3, 24)).astype(np.float32)
    for pv in (None, prev):
        want = jssm._causal_conv_train(
            jnp.asarray(xbc), jnp.asarray(w), jnp.asarray(bias),
            prev=None if pv is None else jnp.asarray(pv))
        got = tssm._causal_conv_train(_t(xbc), _t(w), _t(bias),
                                      prev=None if pv is None else _t(pv))
        _close(got, want, "causal conv")


def test_ssd_chunked_matches_jax():
    rng = np.random.default_rng(4)
    b, s, h, p, g, n, chunk = 2, 20, 4, 8, 1, 16, 8   # 20 = 2 chunks + 4
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.0, 0.5, (b, s, h)).astype(np.float32)
    a = -np.exp(np.log(np.linspace(1.0, 16.0, h))).astype(np.float32)
    bm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    s0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    for init in (None, s0):
        jy, js = jssm._ssd_chunked(*(jnp.asarray(v) for v in
                                     (x, dt, a, bm, cm)), chunk,
                                   None if init is None
                                   else jnp.asarray(init))
        ty, ts = tssm._ssd_chunked(*(_t(v) for v in (x, dt, a, bm, cm)),
                                   chunk, None if init is None else _t(init))
        _close(ty, jy, "ssd out")
        _close(ts, js, "ssd state")


def test_mamba2_matches_jax_with_state_and_valid():
    jcfg, tcfg, jp, tp = _params("zamba2_2_7b")
    rng = np.random.default_rng(5)
    b, s = 3, 10
    _, d_inner, n_heads, d_conv_in = tssm._dims(tcfg)
    sc = tcfg.ssm
    x = rng.standard_normal((b, s, tcfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((b, sc.d_conv - 1, d_conv_in)).astype(
        np.float32)
    ssm = rng.standard_normal((b, n_heads, sc.head_dim, sc.d_state)).astype(
        np.float32) * 0.1
    valid = np.arange(s)[None, :] < np.asarray([s, 2, 0])[:, None]
    jp0 = jax.tree.map(lambda a: a[0, 0], jp["blocks"]["mamba"])["ssm"]
    tp0 = tp["blocks"][0]["ssm"]
    for vmask in (None, valid):
        jo, jn = jssm.mamba2(JCtx(), jp0, jnp.asarray(x), jcfg,
                             init_state=jssm.SSMState(jnp.asarray(conv),
                                                      jnp.asarray(ssm)),
                             valid=None if vmask is None
                             else jnp.asarray(vmask))
        to, tn = tssm.mamba2(TCtx(), tp0, _t(x), tcfg,
                             init_state=tssm.SSMState(_t(conv), _t(ssm)),
                             valid=None if vmask is None else _t(vmask))
        _close(to, jo, "mamba2 out")
        _close(tn.conv, jn.conv, "mamba2 conv window")
        _close(tn.ssm, jn.ssm, "mamba2 ssm state")
    # the row with no valid token keeps its window and state bit for bit
    assert torch.equal(tn.conv[2], _t(conv)[2])
    assert torch.equal(tn.ssm[2], _t(ssm)[2])
