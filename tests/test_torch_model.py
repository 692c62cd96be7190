"""Differential tests: the port's model (``repro_torch.models``) against the
JAX package's on the ragged serving step, with the JAX weights carried
over by ``from_jax_params``.

Two steps on the fp32 smoke config with an int8 KV pool: a 16-token
prefill, then a MIXED step (a 12-token prefill chunk of a new sequence,
a decode row of the first, padding rows and a padding slot).  Logits
must match at rtol = atol = 1e-5 in FP and in INT mode, and the
post-scatter int8 pools must be identical.  In INT mode the float ops in
front of every quant point keep the reference's order, so the codes at
every qlinear boundary agree and the integer products are exact.

The same two steps at qwen3-1.7B's full layer width (one layer) show
where that stops: FP mode still matches, INT mode is bit-identical only
with the reference's rms statistic patched in (the port rounds a float64
statistic, see ``repro_torch.models.common.inv_rms``)."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs import get_config, get_smoke_config  # noqa: E402
from repro.core.qmodel import QuantContext as JCtx  # noqa: E402
from repro.core.qmodel import QuantMode as JMode  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.attention import RaggedBatch as JRB  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.qmodel import QuantContext as TCtx  # noqa: E402
from repro_torch.core.qmodel import QuantMode as TMode  # noqa: E402
from repro_torch.core.qmodel import quantize_weight_tree  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.attention import RaggedBatch as TRB  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

BS, NB, S = 16, 8, 3


def _cfgs():
    jcfg = dataclasses.replace(get_smoke_config("qwen3_1_7b"),
                               kv_cache_bits=8, dtype="float32")
    tcfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})
    return jcfg, tcfg


def _steps(vocab):
    """Two engine steps as (tokens, positions, dest, bt, q_start, q_len,
    kv_len) numpy arrays: seq A owns blocks [1, 2], seq B block [3]."""
    rng = np.random.default_rng(11)
    a_tok = rng.integers(0, vocab, size=17).astype(np.int32)
    b_tok = rng.integers(0, vocab, size=12).astype(np.int32)
    bt = np.zeros((S, 2), np.int32)
    # step 1: A prefills 16 tokens; slots 1, 2 are padding
    t1 = dict(tokens=a_tok[:16], positions=np.arange(16, dtype=np.int32),
              dest=(16 + np.arange(16)).astype(np.int32),
              bt=np.asarray([[1, 2], [0, 0], [0, 0]], np.int32),
              q_start=np.asarray([0, 16, 16], np.int32),
              q_len=np.asarray([16, 0, 0], np.int32),
              kv_len=np.asarray([16, 0, 0], np.int32))
    # step 2: B's 12-token chunk, A's decode row at position 16, 3 padding
    # rows (scatter to the trash block), a padding slot
    tok2 = np.zeros(16, np.int32)
    tok2[:12], tok2[12] = b_tok, a_tok[16]
    pos2 = np.zeros(16, np.int32)
    pos2[:12], pos2[12] = np.arange(12), 16
    dest2 = np.zeros(16, np.int32)
    dest2[:12], dest2[12] = 3 * BS + np.arange(12), 2 * BS + 0
    bt[0], bt[1] = (3, 0), (1, 2)
    t2 = dict(tokens=tok2, positions=pos2, dest=dest2, bt=bt,
              q_start=np.asarray([0, 12, 16], np.int32),
              q_len=np.asarray([12, 1, 0], np.int32),
              kv_len=np.asarray([12, 17, 0], np.int32))
    return t1, t2


def _np_params(jcfg):
    return jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))


def test_from_jax_params_round_trip():
    jcfg, tcfg = _cfgs()
    npt = _np_params(jcfg)
    tp = TM.from_jax_params(npt, tcfg, device="cpu")
    assert len(tp["blocks"]) == tcfg.n_layers
    for key in ("embed", "ln_f", "lm_head"):
        assert tp[key].dtype == torch.float32
        assert np.array_equal(tp[key].numpy(), npt[key])
    flat = jax.tree_util.tree_flatten_with_path(npt["blocks"])[0]
    for path, leaf in flat:
        for layer in range(tcfg.n_layers):
            node = tp["blocks"][layer]
            for p in path:
                node = node[p.key]
            assert np.array_equal(node.numpy(), leaf[layer])
    # int8 codes stay int8, bf16 stays bf16
    codes = {"blocks": {"attn": {"wq": np.full((2, 3, 4), -7, np.int8)}},
             "embed": np.asarray(jax.numpy.ones((2, 2), jax.numpy.bfloat16))}
    out = TM.from_jax_params(codes, tcfg, device="cpu")
    assert out["blocks"][1]["attn"]["wq"].dtype == torch.int8
    assert out["embed"].dtype == torch.bfloat16


def _run_jax(npt, jcfg, mode):
    """Both steps through the JAX package: [logits per step], pools."""
    jp = jax.tree.map(jax.numpy.asarray, npt)
    jctx = JCtx(mode=JMode(mode))
    jcache = JM.init_paged_cache(jcfg, NB, BS)
    logits = []
    for step in _steps(jcfg.vocab_size):
        jrb = JRB(dest=jax.numpy.asarray(step["dest"]),
                  block_tables=jax.numpy.asarray(step["bt"]),
                  q_start=jax.numpy.asarray(step["q_start"]),
                  q_len=jax.numpy.asarray(step["q_len"]),
                  kv_len=jax.numpy.asarray(step["kv_len"]))
        jl, jcache = JM.ragged_step(jp, jax.numpy.asarray(step["tokens"]),
                                    jcache,
                                    jax.numpy.asarray(step["positions"]),
                                    jrb, jcfg, jctx)
        logits.append(np.asarray(jl))
    return logits, [np.asarray(a) for a in jcache["paged_kv"]]


def _run_port(npt, tcfg, mode):
    """Both steps through the port on the CPU, the JAX weights carried
    over: [logits per step], int8 pools."""
    tctx = TCtx(mode=TMode(mode))
    tp = TM.from_jax_params(npt, tcfg, device="cpu")
    if tctx.mode is TMode.INT:
        tp = quantize_weight_tree(tp, tctx)       # the engine's build step
    tcache = TM.init_paged_cache(tcfg, NB, BS, device="cpu")
    logits = []
    for step in _steps(tcfg.vocab_size):
        trb = TRB(dest=torch.from_numpy(step["dest"]),
                  block_tables=torch.from_numpy(step["bt"]),
                  q_start=torch.from_numpy(step["q_start"]),
                  q_len=torch.from_numpy(step["q_len"]),
                  kv_len=torch.from_numpy(step["kv_len"]))
        tl, tcache = TM.ragged_step(tp, torch.from_numpy(step["tokens"]),
                                    tcache,
                                    torch.from_numpy(step["positions"]),
                                    trb, tcfg, tctx)
        assert tl.dtype == torch.float32
        logits.append(tl.numpy())
    for arr in tcache["paged_kv"]:
        assert arr.dtype == torch.int8
    # the steps wrote real codes into A's and B's blocks
    assert torch.count_nonzero(tcache["paged_kv"].k[:, 1:4]) > 0
    return logits, [a.numpy() for a in tcache["paged_kv"]]


@pytest.mark.parametrize("mode", ["fp", "int"])
def test_ragged_step_matches_jax(mode):
    jcfg, tcfg = _cfgs()
    npt = _np_params(jcfg)
    j_logits, j_pools = _run_jax(npt, jcfg, mode)
    t_logits, t_pools = _run_port(npt, tcfg, mode)
    for tl, jl in zip(t_logits, j_logits):
        assert tl.shape == jl.shape
        np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    for t_arr, j_arr in zip(t_pools, j_pools):
        assert np.array_equal(t_arr, j_arr)


# --- full qwen3-1.7B layer width ------------------------------------------

@pytest.fixture(scope="module")
def full_width():
    """qwen3-1.7B's published layer widths (d 2048, 16 query and 8 KV
    heads of 128, d_ff 6144) at one layer, the vocabulary cut to 512, in
    fp32, with the JAX package's own initial weights."""
    jcfg = dataclasses.replace(get_config("qwen3_1_7b"), n_layers=1,
                               vocab_size=512, kv_cache_bits=8,
                               dtype="float32")
    tcfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})
    return jcfg, tcfg, _np_params(jcfg)


def _xla_inv_rms(x, eps):
    """The reference's rms statistic, computed by JAX: fp32 einsum sum of
    squares in XLA's order, then ``lax.rsqrt``."""
    xj = jax.numpy.asarray(x.numpy())
    ms = jax.numpy.einsum("...d,...d->...", xj, xj,
                          preferred_element_type=jax.numpy.float32)
    return torch.from_numpy(np.array(jax.lax.rsqrt(ms / x.shape[-1] + eps)))


def test_ragged_step_full_width_fp(full_width):
    """FP mode at full width: logits within 1e-5, int8 pools identical."""
    jcfg, tcfg, npt = full_width
    j_logits, j_pools = _run_jax(npt, jcfg, "fp")
    t_logits, t_pools = _run_port(npt, tcfg, "fp")
    for tl, jl in zip(t_logits, j_logits):
        np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    for t_arr, j_arr in zip(t_pools, j_pools):
        assert np.array_equal(t_arr, j_arr)


def test_ragged_step_full_width_int(full_width, monkeypatch):
    """INT mode at full width.  With the reference's rms statistic patched
    into the port, logits and pools are bit-identical: every other float
    op ahead of a quant point, and every integer op, matches.  With the
    port's own statistic (float64, rounded once: ``inv_rms``) a last-bit
    difference moves a few boundary codes, and the integer layers carry
    that on; the pools then stay within 2 code steps in under 1% of the
    written codes, and the logits (on the 2^-4 grid) within 8 steps."""
    jcfg, tcfg, npt = full_width
    j_logits, j_pools = _run_jax(npt, jcfg, "int")
    own_logits, own_pools = _run_port(npt, tcfg, "int")
    written = sum(int(np.count_nonzero(a)) for a in j_pools)
    moved = sum(int(np.count_nonzero(t.astype(int) - j.astype(int)))
                for t, j in zip(own_pools, j_pools))
    step = max(int(np.abs(t.astype(int) - j.astype(int)).max())
               for t, j in zip(own_pools, j_pools))
    # the measured departure, shown with ``pytest -s``
    pairs = list(zip(own_logits, j_logits))
    print(f"\nfull-width INT, port vs reference: {moved} of {written} pool "
          f"codes moved, by at most {step} steps; logits max |diff| per "
          f"step {[float(np.abs(t - j).max()) for t, j in pairs]}, share "
          f"differing {[float((t != j).mean()) for t, j in pairs]}")
    assert step <= 2 and moved <= 0.01 * written, (moved, written, step)
    for tl, jl in zip(own_logits, j_logits):
        assert np.isfinite(tl).all()
        assert np.abs(tl - jl).max() <= 8 * 2.0 ** -4

    from repro_torch.models import common
    monkeypatch.setattr(common, "inv_rms", _xla_inv_rms)
    t_logits, t_pools = _run_port(npt, tcfg, "int")
    for tl, jl in zip(t_logits, j_logits):
        np.testing.assert_array_equal(tl, jl)
    for t_arr, j_arr in zip(t_pools, j_pools):
        assert np.array_equal(t_arr, j_arr)
