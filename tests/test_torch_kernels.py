"""Differential tests: the plain PyTorch versions behind the port's kernel
wrappers (``repro_torch.kernels.ops`` on CPU tensors) against the JAX
package's Pallas kernels run in interpret mode and its jnp oracles.

* K2 ``int8_matmul``: bit-exact against ``repro.kernels.ops.int8_matmul``
  with ``force_kernel=True`` (the Pallas body, interpreted) and against
  ``integer_ops.int_linear``, at the shapes of ``tests/test_kernels.py``
  including zero-padded tiles under both bias-shift signs.
* K1 ``ragged_attention``: the ``ITEMS`` mixed work-list of
  ``tests/test_ragged_attention.py`` x GQA {1, 4} x KV {int8, bf16},
  plus padding rows and a padding slot, held to that file's tolerances
  against the interpreted Pallas body and ``ref.ragged_attention_ref``;
  padding rows must be exactly 0.
"""
import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")
import torch  # noqa: E402

from repro.core.integer_ops import LinearQuantSpec as JSpec  # noqa: E402
from repro.core.integer_ops import int_linear  # noqa: E402
from repro.core.qscheme import quant as jquant  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ref import ragged_attention_ref  # noqa: E402
from repro_torch.core.integer_ops import LinearQuantSpec as TSpec  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

ITEMS = ((32, 160), (1, 131), (5, 37), (16, 16))   # (q_len, kv_len)
NKV, SMAX, DK, BS = 4, 256, 128, 128
N_PAD_ROWS = 10


def _codes(shape, seed):
    return np.random.default_rng(seed).integers(-128, 128, size=shape
                                                ).astype(np.int8)


def _int8_case(m, k, n, has_bias, spec_kw, relu=False):
    x, w = _codes((m, k), m + 1), _codes((k, n), k + 2)
    b = _codes((n,), n + 3) if has_bias else None
    jspec, tspec = JSpec(**spec_kw), TSpec(**spec_kw)
    got = tops.int8_matmul(torch.from_numpy(x), torch.from_numpy(w),
                           None if b is None else torch.from_numpy(b),
                           tspec, relu=relu)
    jb = None if b is None else jnp.asarray(b)
    pallas = jops.int8_matmul(jnp.asarray(x), jnp.asarray(w), jb, jspec,
                              relu=relu, force_kernel=True)
    ref = int_linear(jnp.asarray(x), jnp.asarray(w), jb, jspec,
                     apply_relu=relu)
    assert got.dtype == (torch.uint8 if relu and spec_kw.get("out_unsigned")
                         else torch.int8)
    assert np.array_equal(got.numpy(), np.asarray(pallas))
    assert np.array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("m,k,n", [(128, 256, 128), (64, 128, 384),
                                   (200, 300, 130)])
@pytest.mark.parametrize("has_bias", [False, True])
def test_int8_matmul_plain_vs_pallas(m, k, n, has_bias):
    _int8_case(m, k, n, has_bias, dict(n_x=4, n_w=8, n_b=7, n_o=4))


@pytest.mark.parametrize("spec_kw,relu", [
    (dict(n_x=2, n_w=2, n_b=10, n_o=1), False),                 # bias << -
    (dict(n_x=2, n_w=3, n_b=9, n_o=4), False),                  # padded
    (dict(n_x=2, n_w=3, n_b=9, n_o=4, out_unsigned=True), True),
    (dict(n_x=0, n_w=1, n_b=1, n_o=4), False),                  # shift < 0
])
def test_int8_matmul_padded_tiles_both_shift_signs(spec_kw, relu):
    """m, k, n past and off the (128, 512, 512) TPU tile quanta: the
    Pallas body zero-pads K and N; the port's plain version has no tiles
    and must agree bit for bit."""
    _int8_case(150, 600, 640, True, spec_kw, relu=relu)


def _build_mixed(seed, kvh, groups, kv):
    """ITEMS packed into one stream over a shuffled pool, plus padding
    rows at the end of the stream and a trailing padding slot."""
    rng = np.random.default_rng(seed)
    h = kvh * groups
    nbmax = SMAX // BS
    ns = len(ITEMS)
    t_real = sum(q for q, _ in ITEMS)
    t = t_real + N_PAD_ROWS
    q = rng.normal(size=(t, h, DK)).astype(np.float32)
    kf = rng.normal(size=(ns, SMAX, kvh, DK)).astype(np.float32)
    vf = rng.normal(size=(ns, SMAX, kvh, DK)).astype(np.float32)
    if kv == "int8":
        kc = np.asarray(jquant(jnp.asarray(kf), NKV, 8))
        vc = np.asarray(jquant(jnp.asarray(vf), NKV, 8))
        nkv = NKV
    else:
        kc = np.asarray(jnp.asarray(kf).astype(jnp.bfloat16))
        vc = np.asarray(jnp.asarray(vf).astype(jnp.bfloat16))
        q = np.asarray(jnp.asarray(q).astype(jnp.bfloat16))
        nkv = None
    nb = 1 + ns * nbmax
    bt = np.zeros((ns + 1, nbmax), np.int32)                # slot ns: pad
    bt[:ns] = rng.permutation(np.arange(1, nb)).reshape(ns, nbmax)
    kp = np.zeros((nb, BS, kvh, DK), kc.dtype)
    vp = np.zeros_like(kp)
    for s in range(ns):
        for i in range(nbmax):
            kp[bt[s, i]] = kc[s, i * BS:(i + 1) * BS]
            vp[bt[s, i]] = vc[s, i * BS:(i + 1) * BS]
    q_len = np.asarray([ql for ql, _ in ITEMS] + [0], np.int32)
    kv_len = np.asarray([kl for _, kl in ITEMS] + [0], np.int32)
    q_start = np.concatenate([[0], np.cumsum(q_len[:ns])]).astype(np.int32)
    q_start[ns] = t
    return q, kp, vp, bt, q_start, q_len, kv_len, nkv, t_real


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _f32(a):
    return (a.float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(jnp.asarray(a).astype(jnp.float32)))


@pytest.mark.parametrize("kv", ["int8", "bf16"])
@pytest.mark.parametrize("groups", [1, 4])
def test_ragged_attention_plain_vs_pallas(groups, kv):
    q, kp, vp, bt, qs, ql, kl, nkv, t_real = _build_mixed(3, 2, groups, kv)
    got = tops.ragged_attention(*(_to_torch(a) for a in (q, kp, vp, bt, qs,
                                                         ql, kl)),
                                kv_frac_bits=nkv)
    jargs = [jnp.asarray(a) for a in (q, kp, vp, bt, qs, ql, kl)]
    pallas = jops.ragged_attention(*jargs, kv_frac_bits=nkv, tq_max=32)
    oracle = ragged_attention_ref(jargs[0].astype(jnp.float32), *jargs[1:],
                                  kv_frac_bits=nkv)
    tol = dict(atol=2e-2, rtol=2e-2) if kv == "bf16" else \
        dict(atol=1e-4, rtol=1e-4)
    assert got.dtype == _to_torch(q).dtype and got.shape == q.shape
    np.testing.assert_allclose(_f32(got), _f32(pallas), **tol)
    np.testing.assert_allclose(_f32(got), _f32(oracle), **tol)
    assert torch.count_nonzero(got[t_real:]) == 0       # padding rows


def test_ragged_attention_requires_frac_bits():
    q, kp, vp, bt, qs, ql, kl, _, _ = _build_mixed(5, 2, 1, "int8")
    with pytest.raises(ValueError, match="kv_frac_bits"):
        tops.ragged_attention(*(_to_torch(a) for a in (q, kp, vp, bt, qs,
                                                       ql, kl)))


def test_int8_matmul_batch_dims():
    """Leading dims flatten into M and come back (a (B, S) batch)."""
    x, w = _codes((4, 32, 256), 5), _codes((256, 128), 6)
    kw = dict(n_x=4, n_w=8, n_b=8, n_o=4)
    got = tops.int8_matmul(torch.from_numpy(x), torch.from_numpy(w), None,
                           TSpec(**kw))
    want = jops.int8_matmul(jnp.asarray(x), jnp.asarray(w), None, JSpec(**kw),
                            force_kernel=True)
    assert got.shape == (4, 32, 128)
    assert np.array_equal(got.numpy(), np.asarray(want))
