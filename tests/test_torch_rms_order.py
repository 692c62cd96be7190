"""The rms statistic: the port's ``inv_rms`` against the reference's.

The reference (``repro.models.common.rmsnorm``) takes the mean square as an
fp32 ``einsum("...d,...d->...")`` and then ``lax.rsqrt``; the port takes it
in float64 and rounds once (``inv_rms``), so the two differ in the last
bits on some rows (the orders tried and their mismatch rates are in
ROADMAP Queue 3).  This test holds the port within the error bound of the
reference's fp32 sum, at the widths of the smoke config, the qk-norm and
qwen3-1.7B.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro_torch.models.common import inv_rms  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

jnp = jax.numpy
EPS = 1e-6


@jax.jit
def _xla_inv_rms(x):
    ms = jnp.einsum("...d,...d->...", x, x,
                    preferred_element_type=jnp.float32) / x.shape[-1]
    return jax.lax.rsqrt(ms + EPS)


def _rows(d, seed=0, n=256):
    rng = np.random.default_rng(seed + d)
    return (rng.standard_normal((n, d))
            * rng.uniform(0.01, 30, (n, 1))).astype(np.float32)


@pytest.mark.parametrize("lead", [(256,), (4, 64)])
@pytest.mark.parametrize("d", [16, 64, 128, 2048])
def test_port_inv_rms_close_to_reference(d, lead):
    x = _rows(d).reshape(*lead, d)
    ref = np.asarray(_xla_inv_rms(jnp.asarray(x)))
    port = inv_rms(torch.from_numpy(x), EPS).numpy()
    assert port.shape == ref.shape
    # a sequential fp32 sum of d squares is off by at most ~d/2 ulp
    assert np.abs(port.astype(np.float64) / ref - 1).max() <= d * 2.0 ** -24
