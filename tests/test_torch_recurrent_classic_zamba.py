"""The classic path of zamba2_2_7b (family ``hybrid``) against the JAX
package: the cases both recurrent archs share
(``tests/recurrent_classic_cases.py``: ``init_cache``, ``forward`` /
``prefill`` / ``decode_step``, calibration, ``quantize_params``, classic
``serve``, the calibrated and W8A8 engines, classic against engine) under
this file's ``arch``, with its own JAX calibration in the module-scoped
``calibrated`` fixture; and Mamba2's and the hybrid group's own:

* ``mamba2_decode`` from a random non-zero state, output and new state
  within 1e-5;
* ``hybrid_group_fwd`` (prefill and ``decode=True``, over an fp32 and an
  int8 dense cache) within 1e-5; int8 cache codes identical, or at most
  phase 20's documented one-step flips (on <= 0.1% of the codes: the two
  packages sum fp32 products in other orders, and a code on a rounding
  boundary may move; ROADMAP Queue 3, "FP int8 slab codes").
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core.qmodel import QuantContext as JCtx  # noqa: E402
from repro.core.qscheme import quant as jquant  # noqa: E402
from repro.models import attention as jatt  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.core.qmodel import QuantContext as TCtx  # noqa: E402
from repro_torch.models import attention as tatt  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.common import rope_tables  # noqa: E402
from tests.recurrent_classic_cases import *  # noqa: E402,F401,F403
from tests.recurrent_classic_cases import (  # noqa: E402
    NKV, _cfgs, _close, _codes_match, _layer, _t, _tparams, _weights)
from tests.torch_threads import one_torch_thread  # noqa: E402,F401


@pytest.fixture(scope="module", params=["zamba2_2_7b"])
def arch(request):
    return request.param


def test_mamba2_decode_matches_jax():
    jcfg, tcfg = _cfgs("zamba2_2_7b")
    jp, _ = _weights("zamba2_2_7b")
    tp = _tparams("zamba2_2_7b", tcfg)
    rng = np.random.default_rng(2)
    z = tssm.zero_state(tcfg, 3)
    x = rng.standard_normal((3, 1, jcfg.d_model)).astype(np.float32)
    conv = rng.standard_normal(tuple(z.conv.shape)).astype(np.float32)
    ssm = (rng.standard_normal(tuple(z.ssm.shape)) * 0.5).astype(np.float32)
    jp_l = _layer(_layer(jp["blocks"]["mamba"], 1), 0)["ssm"]
    jo, jst = jax.jit(lambda p, x, st: jssm.mamba2_decode(
        JCtx(), p, x, jcfg, st))(jp_l, jnp.asarray(x),
                                 jssm.SSMState(jnp.asarray(conv),
                                               jnp.asarray(ssm)))
    g = tcfg.hybrid.attn_every
    with torch.no_grad():
        to, tst = tssm.mamba2_decode(TCtx(), tp["blocks"][g]["ssm"], _t(x),
                                     tcfg, tssm.SSMState(_t(conv), _t(ssm)))
    _close(to, jo, "out")
    _close(tst.conv, jst.conv, "conv")
    _close(tst.ssm, jst.ssm, "ssm")
    # the window rolled: the new window's first rows are the old last ones
    assert torch.equal(tst.conv[:, :-1], _t(conv)[:, 1:])


def _hybrid_case(rng, jcfg, tcfg, b, s_max, kv_bits):
    """Random group states and a dense KV cache whose rows hold values
    (codes when int8)."""
    g = tcfg.hybrid.attn_every
    z = tssm.zero_state(tcfg, b)
    conv = rng.standard_normal((g,) + tuple(z.conv.shape)).astype(np.float32)
    ssm = (rng.standard_normal((g,) + tuple(z.ssm.shape)) * 0.5
           ).astype(np.float32)
    shape = (b, s_max, jcfg.n_kv_heads, jcfg.resolved_head_dim)
    kv = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    if kv_bits == 8:
        kv = [np.asarray(jquant(jnp.asarray(a), NKV, 8)) for a in kv]
    return conv, ssm, kv


@pytest.mark.parametrize("kv_bits", [None, 8])
@pytest.mark.parametrize("decode", [False, True])
def test_hybrid_group_fwd_matches_jax(kv_bits, decode):
    jcfg, tcfg = _cfgs("zamba2_2_7b", kv_cache_bits=kv_bits)
    jp, _ = _weights("zamba2_2_7b")
    tp = _tparams("zamba2_2_7b", tcfg)
    rng = np.random.default_rng(4)
    b, s_max = 2, 24
    s, pos = (1, 17) if decode else (19, 0)
    conv, ssm, kv = _hybrid_case(rng, jcfg, tcfg, b, s_max, kv_bits)
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    xe = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    positions = np.broadcast_to(pos + np.arange(s), (b, s))
    jx, jst, jkv = jtfm.hybrid_group_fwd(
        JCtx(), _layer(jp["blocks"]["mamba"], 1), jp["shared"],
        jnp.asarray(x), jnp.asarray(xe), jcfg,
        positions=jnp.asarray(positions),
        ssm_states=jssm.SSMState(jnp.asarray(conv), jnp.asarray(ssm)),
        attn_cache=jatt.KVCache(*map(jnp.asarray, kv)),
        cache_pos=jnp.asarray(pos, jnp.int32) if decode else 0,
        decode=decode)
    g = tcfg.hybrid.attn_every
    cache = tatt.KVCache(*map(_t, kv))
    with torch.no_grad():
        tx, tst = ttfm.hybrid_group_fwd(
            TCtx(), tp["blocks"][g:2 * g], tp["shared"], _t(x), _t(xe), tcfg,
            states=[tssm.SSMState(_t(conv[j]), _t(ssm[j]))
                    for j in range(g)],
            rope=rope_tables(_t(positions), tcfg.resolved_head_dim,
                             tcfg.rope_theta, torch.float32),
            cache=cache,
            cache_pos=torch.tensor(pos, dtype=torch.int32) if decode else 0,
            decode=decode)
    _close(tx, jx, "x")
    for j in range(g):
        _close(tst[j].conv, jst.conv[j], f"conv {j}")
        _close(tst[j].ssm, jst.ssm[j], f"ssm {j}")
    for name, a, want in (("k", cache.k, jkv.k), ("v", cache.v, jkv.v)):
        if kv_bits == 8:
            _codes_match(a, want, name)
        else:
            _close(a, want, name)
