"""Differential tests: the paper's baselines and the dense configurations
of its tables, in the port against the JAX package.

* ``core.baselines.scale_quant`` (the scaling-factor baseline) is
  bit-identical to the reference's as the reference's models compute it
  (compiled: XLA turns its division by the constant 2^(bits-1) - 1 into a
  product with the fp32 reciprocal), on fp32 and bf16 inputs, at several
  shapes, bits 4 and 8, an all-zero tensor included;
* ``codebook_quant`` (the k-means baseline) is identical to the
  reference's, fp32 and bf16;
* ``llama3_2_1b``, ``qwen3_32b``, ``deepseek_67b`` and ``chameleon_34b``
  (family ``vlm``) equal the JAX configs field for field, CONFIG and
  SMOKE_CONFIG;
* each of their smoke configs serves on the ragged engine token for token
  as the JAX engine does, FP and INT (uncalibrated), fp32.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import baselines as jb  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import baselines as tb  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.model import from_jax_params  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

jnp = jax.numpy
NEW_ARCHS = ["llama3_2_1b", "qwen3_32b", "deepseek_67b", "chameleon_34b"]
_jit_scale_quant = jax.jit(jb.scale_quant, static_argnums=1)


def _inputs(seed, shape, dtype):
    """A (numpy fp32, JAX, torch) triple of the same values in ``dtype``,
    heavy-tailed so the max sits far out."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_t(3, size=shape) * 2).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    x = np.asarray(xj.astype(jnp.float32))
    return xj, torch.from_numpy(x.copy()).to(getattr(torch, dtype))


@pytest.mark.parametrize("shape", [(7,), (3, 12, 64), (64, 96), (5, 1, 33)])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scale_quant_bit_identical(shape, bits, dtype):
    for seed in range(4):
        xj, xt = _inputs(seed, shape, dtype)
        want = np.asarray(_jit_scale_quant(xj, bits).astype(jnp.float32))
        got = tb.scale_quant(xt, bits)
        assert got.dtype == xt.dtype and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.float().numpy(), want)
    # an all-zero tensor: the scale clamps at 1e-12, the result is zero
    zero = tb.scale_quant(torch.zeros(shape, dtype=getattr(torch, dtype)),
                          bits)
    want = _jit_scale_quant(jnp.zeros(shape, dtype), bits)
    assert not zero.any() and not np.asarray(want.astype(jnp.float32)).any()


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_codebook_quant_identical(bits, dtype):
    xj, xt = _inputs(9 + bits, (48, 40), dtype)
    want = np.asarray(jb.codebook_quant(xj, bits).astype(jnp.float32))
    got = tb.codebook_quant(xt, bits)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert len(np.unique(want)) <= 2 ** bits


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_equal_jax(arch):
    assert arch in tconfigs.ARCH_IDS
    for getter in ("get_config", "get_smoke_config"):
        j = getattr(jconfigs, getter)(arch)
        t = getattr(tconfigs, getter)(arch)
        assert isinstance(t, ModelConfig)
        for f in dataclasses.fields(ModelConfig):
            assert getattr(t, f.name) == getattr(j, f.name), (getter, f.name)
        # the fields the port does not carry stay at their defaults
        jdef = {f.name: f.default for f in dataclasses.fields(j)}
        for f in dataclasses.fields(j):
            if not hasattr(t, f.name):
                assert getattr(j, f.name) == jdef[f.name], f.name
    assert tconfigs.get_config("chameleon_34b").family == "vlm"


@pytest.mark.parametrize("mode", ["fp", "int"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_engine_tokens_identical(arch, mode):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                               kv_cache_bits=8, dtype="float32")
    tcfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})
    kw = dict(n_requests=4, rate=1e9, mode=mode, calibrate=False, kv_bits=8,
              cfg_overrides={"dtype": "float32"}, prompt_lens=(8, 24),
              gen_lens=(4, 8))
    jo = jserve.serve_engine(arch, **kw)
    params = from_jax_params(
        jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0))),
        tcfg, device="cpu")
    to = tserve.serve_engine(arch, params=params, device="cpu", **kw)
    assert sorted(jo["outputs"]) == sorted(to["outputs"]) == list(range(4))
    for rid, toks in jo["outputs"].items():
        assert np.array_equal(toks, to["outputs"][rid]), rid
    assert to["report"]["ragged_steps"] == jo["report"]["ragged_steps"]
