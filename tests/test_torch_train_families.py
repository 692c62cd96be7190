"""Differential tests of the port's training path on every language-model
family beyond the dense one, against the JAX package: granite-moe-3b (MoE),
deepseek-v3 (MoE with MLA: one dense layer, two MoE layers at smoke size),
whisper-large-v3 (audio: the batch's ``encoder_features``), rwkv6-3b (ssm)
and zamba2-2.7b (hybrid), each at its smoke config with the JAX weights
carried over by ``from_jax_params``:

* ``loss_fn``'s loss, metrics and every gradient leaf (``steps.
  loss_and_grads``) against ``jax.value_and_grad`` of the reference's
  ``loss_fn(remat=False)``, in ``fp`` and ``fake_sf`` (fp32 and bf16) and
  ``fake`` and ``int`` (fp32), at the tolerances of ``TOL`` (each looser
  one beside its cause).  ``fake`` and ``int`` give all-zero gradients on
  both sides;
* the gradients ``torch.equal`` under ``remat`` True, 'full' and 'dots' to
  those under ``remat=False``, for every family; zamba2's under each also
  against the reference's ``loss_fn(remat=...)``;
* ``build_train_step`` at its default (``remat=True``): three AdamW steps
  against the reference's ``build_train_step``;
* ``param_count`` / ``pick_optimizer`` against the reference's for every
  language-model arch at full size (deepseek-v3's 671 B take Adafactor);
* ``train()`` and its CLI for every family at smoke size.

About 5 minutes on one thread, most of it compiling the JAX package's
gradients (one ``jax.jit`` a case).
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import ARCH_IDS as JARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.core.qmodel import QuantContext as JCtx  # noqa: E402
from repro.core.qmodel import QuantMode as JMode  # noqa: E402
from repro.data import SyntheticLMStream as JStream  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import warmup_cosine as jwarmup_cosine  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.core.qmodel import QuantContext as TCtx  # noqa: E402
from repro_torch.core.qmodel import QuantMode as TMode  # noqa: E402
from repro_torch.core.tree import leaves, leaves_with_paths  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import warmup_cosine as twarmup_cosine  # noqa: E402
from tests.test_torch_recurrent_blocks import tcfg_of  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

ARCHS = ["granite_moe_3b_a800m", "deepseek_v3_671b", "whisper_large_v3",
         "rwkv6_3b", "zamba2_2_7b"]
MODES = ["fp", "fake_sf", "fake", "int"]
BATCH, SEQ = 4, 32

# (dtype, mode) -> (loss tolerance, gradient tolerance), each family's
# entry in TOL overriding it.  fp32 FP holds every family to the dense
# family's 5e-6 / 2e-6 but where noted; the gradient tolerances are the
# largest |port - reference| over every element of every leaf (the
# largest gradients are about 1-4).  None: checked otherwise (below)
BASE_TOL = {("float32", "fp"): (5e-6, 2e-6),
            ("float32", "fake_sf"): (5e-6, 2e-6),
            ("float32", "fake"): (5e-6, None),
            ("float32", "int"): (5e-6, None),
            ("bfloat16", "fp"): (3e-3, 1.5e-2),
            ("bfloat16", "fake_sf"): (1.5e-2, None)}
TOL = {
    # the embedding's gradient (a scatter-add over the batch's tokens, and
    # the tied head's product) summed in another fp32 order: 3.4e-6 of
    # its largest 1.0
    ("deepseek_v3_671b", "float32", "fp"): (5e-6, 5e-6),
    # the chunked wkv scan sums in another fp32 order than the
    # reference's (ROADMAP Queue 3): 6.2e-6 of 1.4 (embedding),
    # 1.8e-5 on FAKE's loss
    ("rwkv6_3b", "float32", "fp"): (5e-6, 1e-5),
    ("rwkv6_3b", "float32", "fake"): (5e-5, None),
    # FAKE_SF's per-tensor scale, max|x| / 127, turns a last-bit
    # difference into moved codes all over a tensor (ROADMAP Queue 3).
    # deepseek-v3: a MoE layer's output differs from XLA's in the last
    # bit on identical inputs (1.4e-6: the combine and the experts' float
    # products), and the next layer's scale moves (1.1e-4 / 5.8e-4);
    # whisper: the float64 gelu, rms statistic and sinusoid (9.7e-4 /
    # 3.3e-3); rwkv6: those and the wkv scan's order (4.2e-3 / 5.6e-2)
    ("deepseek_v3_671b", "float32", "fake_sf"): (3e-4, 1.5e-3),
    ("whisper_large_v3", "float32", "fake_sf"): (3e-3, 1e-2),
    ("rwkv6_3b", "float32", "fake_sf"): (1e-2, 0.1),
    # bf16: every float64-rounded-once departure (rms, silu, gelu, the
    # router, the sinusoid; Queue 3) lands on a different bf16 value now
    # and then, and the backward carries it through every layer; the
    # whole gradient parts from the reference's by 3-10% of its norm
    # (measured, the largest element apart: granite 0.037, deepseek-v3
    # 0.0996 (MLA and MoE), rwkv6 0.062, zamba2 0.020, whisper 0.0039)
    ("granite_moe_3b_a800m", "bfloat16", "fp"): (3e-3, 8e-2),
    ("deepseek_v3_671b", "bfloat16", "fp"): (3e-3, 0.2),
    ("rwkv6_3b", "bfloat16", "fp"): (3e-3, 0.12),
    ("zamba2_2_7b", "bfloat16", "fp"): (3e-3, 4e-2),
    # bf16 FAKE_SF's loss: codes moved by the departures above
    # (deepseek-v3 2.8e-2)
    ("deepseek_v3_671b", "bfloat16", "fake_sf"): (5e-2, None),
}


def cfgs(arch, dtype="float32"):
    jcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    return jcfg, tcfg_of(jcfg)


@functools.lru_cache(maxsize=None)
def jparams(arch, dtype="float32"):
    """The JAX weights (numpy) of ``arch``'s smoke config in ``dtype``,
    ``init_params`` compiled once (both packages take this one set)."""
    jcfg, _ = cfgs(arch, dtype)
    jp = jax.jit(JM.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, jp)


def batch_of(jcfg, step=1):
    """A batch of the synthetic stream (with the audio family's stub
    ``encoder_features``), as both packages' inputs."""
    audio = jcfg.family == "audio"
    b = JStream(jcfg.vocab_size, SEQ, BATCH, seed=3,
                encoder_seq=jcfg.encdec.encoder_seq if audio else None,
                d_model=jcfg.d_model if audio else None).batch(step)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def as_port(np_tree, tcfg):
    return TM.from_jax_params(np_tree, tcfg, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_grads(arch, dtype, mode, remat=False):
    jcfg, _ = cfgs(arch, dtype)
    jb, _ = batch_of(jcfg)
    jp = jax.tree.map(jnp.asarray, jparams(arch, dtype))
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, b, jcfg, JCtx(mode=JMode(mode)),
                                remat=remat), has_aux=True))(jp, jb)
    return (float(jl), {k: float(v) for k, v in jm.items()},
            jax.tree.map(np.asarray, jg))


def _port_grads(arch, dtype, mode, remat=False):
    jcfg, tcfg = cfgs(arch, dtype)
    _, tb = batch_of(jcfg)
    return TS.loss_and_grads(as_port(jparams(arch, dtype), tcfg), tb, tcfg,
                             TCtx(mode=TMode(mode)), remat=remat)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

# fake and int (all-zero gradients) in fp32 only: a bf16 case would
# compile two more reference gradients a family to check zeros again
CASES = [(dt, m) for dt in ("float32", "bfloat16") for m in MODES
         if dt == "float32" or m in ("fp", "fake_sf")]


@pytest.mark.parametrize("dtype,mode", CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, dtype, mode):
    jl, jm, jg = _jax_grads(arch, dtype, mode)
    tl, tm, tg = _port_grads(arch, dtype, mode)
    _, tcfg = cfgs(arch, dtype)
    loss_tol, grad_tol = TOL.get((arch, dtype, mode),
                                 BASE_TOL[(dtype, mode)])
    assert abs(float(tl) - jl) <= loss_tol, (float(tl), jl)
    for key in ("nll", "z_loss", "ppl_proxy"):
        assert np.isclose(float(tm[key]), jm[key], rtol=loss_tol,
                          atol=loss_tol), key
    want = leaves(as_port(jg, tcfg))        # the reference's, port layout
    params = leaves(as_port(jparams(arch, dtype), tcfg))
    assert [tuple(g.shape) for g in tg] == [tuple(w.shape) for w in want]
    assert all(g.dtype == p.dtype for g, p in zip(tg, params))
    if mode in ("fake", "int"):
        # fake_quant's trunc has no gradient, INT casts to codes: the
        # reference's gradients are all zero, and so are the port's
        assert all(not np.any(g) for g in jax.tree.leaves(jg))
        assert all(not torch.any(g) for g in tg)
        return
    assert max(float(w.float().abs().max()) for w in want) > 0.1
    if grad_tol is None:
        # bf16 FAKE_SF: round has no gradient, so a quantized tensor's
        # gradient flows only through its scale, max|x|, into its largest
        # element; a last-bit difference in bf16 elects another element
        # (granite's ln_f: one element each side, 0.33 at different
        # places; zamba2's embedding: 63 of 16384 elements reached on one
        # side only), so the values are not compared.  The same leaves
        # take a gradient
        assert [bool(g.any()) for g in tg] == [bool(w.any()) for w in want]
        return
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(tg, want))
    assert err <= grad_tol, err


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [True, "full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_gradient(arch, remat):
    want = _port_grads(arch, "float32", "fp")
    got = _port_grads(arch, "float32", "fp", remat=remat)
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[2], want[2]))


@pytest.mark.parametrize("remat", [True, "full", "dots"])
def test_zamba2_remat_matches_reference_remat(remat):
    """zamba2's groups rematerialized on fresh buffers (each group's zero
    states and K/V made inside its body) against the reference's
    ``maybe_remat`` over its fresh cache."""
    arch = "zamba2_2_7b"
    jl, _, jg = _jax_grads(arch, "float32", "fp", remat)
    tl, _, tg = _port_grads(arch, "float32", "fp", remat=remat)
    _, tcfg = cfgs(arch)
    assert abs(float(tl) - jl) <= 5e-6
    err = max(float((g - w).abs().max())
              for g, w in zip(tg, leaves(as_port(jg, tcfg))))
    assert err <= 2e-6, err


def test_hybrid_forward_writes_no_cache_without_one():
    """Without a cache the hybrid forward leaves nothing behind: each
    group's states and K/V live inside its body; with one, the prefill
    fills the cache's states and K/V in place."""
    _, tcfg = cfgs("zamba2_2_7b")
    params = as_port(jparams("zamba2_2_7b"), tcfg)
    tokens = torch.randint(0, tcfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want, none = TM.forward(params, {"tokens": tokens}, tcfg, TCtx())
        cache = TM.init_cache(tcfg, 2, 8, device="cpu")
        got, same = TM.forward(params, {"tokens": tokens}, tcfg, TCtx(),
                               cache=cache)
    assert none is None and same is cache
    assert torch.equal(got, want)
    assert all(bool(t.any()) for t in leaves(cache))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_float64_activations_keep_only_their_input(act, dtype):
    """``mlp._silu`` / ``_gelu`` under autograd: the float64 value rounded
    once, as without a gradient, and the backward of the float64
    expression (rounded once; fp32 gelu within an ulp: the derivative's
    float64 terms in another order) from one saved tensor, x itself."""
    from repro_torch.models import mlp as tmlp
    fn = {"silu": tmlp._silu, "gelu": tmlp._gelu}[act]
    f64 = {"silu": tmlp._silu64, "gelu": tmlp._gelu64}[act]
    gen = torch.Generator().manual_seed(5)
    x = (4 * torch.randn(1 << 14, generator=gen)).to(dtype)
    g = torch.randn(1 << 14, generator=gen).to(dtype)
    a = x.clone().requires_grad_()
    y = fn(a)
    with torch.no_grad():
        assert torch.equal(y, fn(x))
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 1 and saved[0].dtype == dtype
    (got,) = torch.autograd.grad(y, a, g)
    b = x.clone().requires_grad_()
    (want,) = torch.autograd.grad(f64(b.to(torch.float64)).to(dtype), b, g)
    assert torch.allclose(got, want, rtol=2 ** -23, atol=0)
    if dtype == torch.bfloat16 or act == "silu":
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the train step at its default
# ---------------------------------------------------------------------------

# three steps' losses: the dense family's 1e-5, the ssm family's scan
# order (above) carried through two AdamW updates
STEP_TOL = {"rwkv6_3b": 1e-4}


@pytest.mark.parametrize("arch", ARCHS)
def test_three_steps_match_jax(arch):
    """``build_train_step`` at its defaults (``remat=True``) in both
    packages, AdamW, three steps from the same weights."""
    jcfg, tcfg = cfgs(arch)
    jstep = jax.jit(JS.build_train_step(jcfg, JCtx(), jadamw(),
                                        jwarmup_cosine(3e-3, 1, 3)))
    tstep = TS.build_train_step(tcfg, TCtx(), tadamw(),
                                twarmup_cosine(3e-3, 1, 3))
    jp = jax.tree.map(jnp.asarray, jparams(arch))
    js = jadamw().init(jp)
    tp = as_port(jparams(arch), tcfg)
    ts = tadamw().init(tp)
    for i in range(3):
        jb, tb = batch_of(jcfg, i)
        jp, js, jm = jstep(jp, js, jb)
        tp, ts, tm = tstep(tp, ts, tb)
        for key in ("loss", "grad_norm"):
            assert abs(float(tm[key]) - float(jm[key])) <= \
                STEP_TOL.get(arch, 1e-5), (i, key)


# ---------------------------------------------------------------------------
# optimizer choice
# ---------------------------------------------------------------------------

LM_ARCHS = [a for a in ARCH_IDS if a != "resnet_paper"]


def test_lm_archs_are_the_references():
    assert set(LM_ARCHS) <= set(JARCH_IDS)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_count_and_optimizer_match_jax(arch):
    jcfg, tcfg = jget_config(arch), tget_config(arch)
    n = TS.param_count(tcfg)
    assert n == JS.param_count(jcfg)
    want = JS.pick_optimizer(jcfg).init.__qualname__.split(".")[0]
    assert TS.pick_optimizer(tcfg).init.__qualname__.split(".")[0] == want
    assert (want == "adafactor") == (n > TS.ADAFACTOR_THRESHOLD)
    if arch == "deepseek_v3_671b":
        assert want == "adafactor"


# ---------------------------------------------------------------------------
# the training loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_every_family(arch, capsys):
    """``python -m repro_torch.launch.train --arch ARCH`` at smoke size
    on the CPU: finite losses that fall (whisper's batches carry the
    loader's ``encoder_features``)."""
    out = ttrain.main(["--arch", arch, "--steps", "8", "--batch", "4",
                       "--seq", "32", "--lr", "1e-2", "--device", "cpu"])
    losses = out["losses"]
    assert len(losses) == 8 and np.all(np.isfinite(losses))
    assert np.mean(losses[-2:]) < losses[0]
    assert "final loss" in capsys.readouterr().out
