"""The classic path of rwkv6_3b (family ``ssm``) against the JAX package:
the cases both recurrent archs share (``tests/recurrent_classic_cases.py``:
``init_cache``, ``forward`` / ``prefill`` / ``decode_step``, calibration,
``quantize_params``, classic ``serve``, the calibrated and W8A8 engines,
classic against engine) under this file's ``arch``, with its own JAX
calibration in the module-scoped ``calibrated`` fixture; and RWKV6's own:

* ``rwkv6_decode`` from a random non-zero state, output and new state
  within 1e-5;
* the blocks ``rwkv_block_fwd`` and ``rwkv_block_decode`` within 1e-5;
* the repair of ``quantize_weight_tree`` on RWKV6: a calibrated INT
  forward over the pre-quantized tree equals the on-the-fly forward over
  float weights bit for bit (the channel mix's weights on their
  ``rwkv_ffn/*`` grids).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core.qmodel import QuantContext as JCtx  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.core import qmodel as tqmodel  # noqa: E402
from repro_torch.core.qmodel import QuantContext as TCtx  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from tests.recurrent_classic_cases import *  # noqa: E402,F401,F403
from tests.recurrent_classic_cases import (  # noqa: E402
    _calib_tokens, _cfgs, _close, _layer, _port_ctx, _rwkv_state, _t,
    _tparams, _weights)
from tests.torch_threads import one_torch_thread  # noqa: E402,F401


@pytest.fixture(scope="module", params=["rwkv6_3b"])
def arch(request):
    return request.param


def test_rwkv6_decode_matches_jax():
    jcfg, tcfg = _cfgs("rwkv6_3b")
    jp, _ = _weights("rwkv6_3b")
    tp = _tparams("rwkv6_3b", tcfg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 1, jcfg.d_model)).astype(np.float32)
    st = _rwkv_state(rng, jcfg, 3)
    jo, jst = jax.jit(lambda p, x, st: jrwkv.rwkv6_decode(
        JCtx(), p, x, jcfg, st))(_layer(jp["blocks"], 1)["rwkv"],
                                 jnp.asarray(x),
                                 jrwkv.RWKVState(*map(jnp.asarray, st)))
    with torch.no_grad():
        to, tst = trwkv.rwkv6_decode(TCtx(), tp["blocks"][1]["rwkv"], _t(x),
                                     tcfg, trwkv.RWKVState(*map(_t, st)))
    _close(to, jo, "out")
    for f, a, b in zip(jst._fields, tst, jst):
        assert a.dtype == torch.float32, f
        _close(a, b, f)


@pytest.mark.parametrize("decode", [False, True])
def test_rwkv_blocks_match_jax(decode):
    jcfg, tcfg = _cfgs("rwkv6_3b")
    jp, _ = _weights("rwkv6_3b")
    tp = _tparams("rwkv6_3b", tcfg)
    rng = np.random.default_rng(3)
    s = 1 if decode else 21
    x = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    st = _rwkv_state(rng, jcfg, 2)
    jblock = jtfm.rwkv_block_decode if decode else jtfm.rwkv_block_fwd
    tblock = ttfm.rwkv_block_decode if decode else ttfm.rwkv_block_fwd
    jx, jst = jax.jit(lambda p, x, st: jblock(JCtx(), p, x, jcfg, st))(
        _layer(jp["blocks"], 0), jnp.asarray(x),
        jrwkv.RWKVState(*map(jnp.asarray, st)))
    with torch.no_grad():
        tx, tst = tblock(TCtx(), tp["blocks"][0], _t(x), tcfg,
                         trwkv.RWKVState(*map(_t, st)))
    _close(tx, jx, "x")
    for f, a, b in zip(jst._fields, tst, jst):
        assert tuple(a.shape) == b.shape, f
        _close(a, b, f)


def test_prequantized_rwkv_tree_equals_on_the_fly(calibrated):
    """The repair: ``quantize_weight_tree`` quantizes the channel mix's
    ``wk_ffn`` / ``wv_ffn`` / ``wr_ffn`` on the grids of the modules their
    ``qlinear`` calls name (``rwkv_ffn/wk|wv|wr``, ``models.model.
    qlinear_weight``), so the INT forward over the pre-quantized tree is
    the forward over float weights, bit for bit.  Under the old mapping
    (the longest path suffix in the table: none for these leaves) they
    took the default grid."""
    jctx = calibrated[0]
    ctx = _port_ctx(jctx, "int")
    assert {ctx.table[f"rwkv_ffn/{m}"].n_w for m in ("wk", "wv", "wr")} \
        != {tqmodel.DEFAULT_N_W}      # the grids the old mapping missed
    _, tcfg = _cfgs("rwkv6_3b")
    tp = _tparams("rwkv6_3b", tcfg)
    pre = tqmodel.quantize_weight_tree(tp, ctx, name_fn=TM.qlinear_weight)
    assert pre["blocks"][0]["rwkv"]["wk_ffn"].dtype == torch.int8
    assert pre["blocks"][0]["rwkv"]["lora_mix_a"].dtype == torch.float32
    toks = {"tokens": _t(_calib_tokens()[:, :12])}
    with torch.no_grad():
        want, _ = TM.forward(tp, toks, tcfg, ctx)
        got, _ = TM.forward(pre, toks, tcfg, ctx)
    assert torch.equal(got, want)
