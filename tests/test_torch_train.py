"""Differential tests of the port's training path against the JAX
package, on llama3.2-1B's smoke config with the JAX weights (and
optimizer state) carried over by ``from_jax_params`` /
``from_jax_opt_state``:

* ``loss_fn``'s loss, metrics and every leaf's gradient (``steps.
  loss_and_grads``) against ``jax.value_and_grad`` of the reference's, in
  ``fp``, ``fake_sf``, ``fake`` and ``int``: fp32 within 5e-6 (loss) and
  2e-6 (gradients; the largest is about 2); bf16 within 3e-3 and 1.5e-2,
  INT's loss within 3e-2 (the float64 rms statistic moves codes, ROADMAP
  Queue 3).  ``fake`` and ``int`` gradients are exactly zero in both;
* the gradients identical with ``remat`` False, True, 'full' and 'dots';
* K5's plain version's VJP against ``jax.vjp`` of the reference's
  ``ops.flash_attention`` at Sq = Skv = 128 (its Pallas forward
  interpreted and its ``custom_vjp``), causal and not, within 2e-6; and
  the wrapper's CUDA route (its ``autograd.Function``, the kernel stood in
  by the plain version) giving the plain version's gradients, counting
  one launch a forward, refusing grad over int8 codes;
* one ``build_train_step`` step (AdamW, ``accum_steps`` 1 and 2, and
  Adafactor) from the same params and state: loss, ``grad_norm``, ``lr``
  and params within 2e-6 and each moment leaf within 1e-5 of its largest
  value (1.7e-6 seen) of the JAX step's;
  three steps' losses within 1e-5;
* ``param_count`` / ``pick_optimizer`` against the reference's at full
  width;
* ``train()`` reducing the loss, its resume (bit-identical losses on the
  CPU), the train -> calibrate -> INT serve pipeline of
  ``tests/test_system.py``, the restore determinism of its last test, and
  the CLI and the ``train_small_lm`` twin at smoke size.

About 50 s on one thread, most of it compiling the JAX package's
gradients and steps (one ``jax.jit`` a case).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.core.qmodel import QuantContext as JCtx  # noqa: E402
from repro.core.qmodel import QuantMode as JMode  # noqa: E402
from repro.data import SyntheticLMStream as JStream  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adafactor as jadafactor  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import warmup_cosine as jwarmup_cosine  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.core.qmodel import QuantContext as TCtx  # noqa: E402
from repro_torch.core.qmodel import QuantMode as TMode  # noqa: E402
from repro_torch.core.tree import leaves, leaves_with_paths  # noqa: E402
from repro_torch.data import SyntheticLMStream as TStream  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch import train_small_lm  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import adafactor as tadafactor  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import warmup_cosine as twarmup_cosine  # noqa: E402
from tests.test_torch_recurrent_blocks import tcfg_of  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

ARCH = "llama3_2_1b"
BATCH, SEQ = 4, 32


def cfgs(dtype="float32"):
    jcfg = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)
    return jcfg, tcfg_of(jcfg)


@pytest.fixture(scope="module")
def jparams():
    """The JAX weights of both smoke dtypes (numpy)."""
    return {dt: jax.tree.map(np.asarray, JM.init_params(
        cfgs(dt)[0], jax.random.PRNGKey(0))) for dt in ("float32",
                                                        "bfloat16")}


def batch_of(step=1, batch=BATCH, seq=SEQ):
    b = JStream(256, seq, batch, seed=3).batch(step)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def as_port(np_tree, tcfg):
    """A JAX-layout tree (params, gradients or moments) as the port's."""
    return TM.from_jax_params(np_tree, tcfg, device="cpu")


def max_diff(port_tree, jax_np_tree, tcfg):
    want = leaves(as_port(jax_np_tree, tcfg))
    got = leaves(port_tree)
    assert len(got) == len(want)
    return max(float((g.float() - w.float()).abs().max())
               for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

# (dtype, mode) -> (loss tolerance, gradient tolerance)
LOSS_TOL = {"float32": (5e-6, 2e-6), "bfloat16": (3e-3, 1.5e-2)}


@pytest.mark.parametrize("mode", ["fp", "fake_sf", "fake", "int"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(jparams, dtype, mode):
    jcfg, tcfg = cfgs(dtype)
    jb, tb = batch_of()
    jp = jax.tree.map(jnp.asarray, jparams[dtype])
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, b, jcfg, JCtx(mode=JMode(mode)),
                                remat=False), has_aux=True))(jp, jb)
    tl, tm, tg = TS.loss_and_grads(as_port(jparams[dtype], tcfg), tb, tcfg,
                                   TCtx(mode=TMode(mode)))
    loss_tol, grad_tol = LOSS_TOL[dtype]
    if dtype == "bfloat16" and mode == "int":
        loss_tol = 3e-2         # the rms departure moves codes (Queue 3)
    assert abs(float(tl) - float(jl)) <= loss_tol
    for key in ("nll", "z_loss", "ppl_proxy"):
        assert np.isclose(float(tm[key]), float(jm[key]), rtol=loss_tol,
                          atol=loss_tol), key
    jg = jax.tree.map(np.asarray, jg)
    tg_tree = TM.from_jax_params(jg, tcfg, device="cpu")   # layout only
    assert [tuple(g.shape) for g in tg] == \
        [tuple(g.shape) for g in leaves(tg_tree)]
    assert all(g.dtype == p.dtype for g, p in
               zip(tg, leaves(as_port(jparams[dtype], tcfg))))
    if mode in ("fake", "int"):
        # fake_quant's trunc has no gradient, INT casts to codes: the
        # reference's gradients are all zero, and so are the port's
        assert all(not np.any(g) for g in jax.tree.leaves(jg))
        assert all(not torch.any(g) for g in tg)
        return
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(tg, leaves(tg_tree)))
    assert err <= grad_tol, err
    assert max(float(np.abs(g.astype(np.float32)).max())
               for g in jax.tree.leaves(jg)) > 0.1


@pytest.mark.parametrize("remat", [True, "full", "dots"])
def test_remat_changes_no_gradient(jparams, remat):
    _, tcfg = cfgs()
    _, tb = batch_of()
    params = as_port(jparams["float32"], tcfg)
    want = TS.loss_and_grads(params, tb, tcfg, TCtx(), remat=False)
    got = TS.loss_and_grads(params, tb, tcfg, TCtx(), remat=remat)
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[2], want[2]))


def test_remat_unknown_and_hybrid_refused():
    _, tcfg = cfgs()
    params = TM.init_params(tcfg, device="cpu")
    _, tb = batch_of()
    with pytest.raises(ValueError, match="remat"):
        TM.forward(params, tb, tcfg, TCtx(), remat="nothing")
    with pytest.raises(NotImplementedError, match="cache"):
        TM.forward(params, tb, tcfg, TCtx(), remat=True,
                   cache=TM.init_cache(tcfg, BATCH, SEQ, device="cpu"))


# ---------------------------------------------------------------------------
# K5's backward
# ---------------------------------------------------------------------------

def _qkv(seed, b, sq, skv, h, kvh, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in
                 ((b, sq, h, d), (b, skv, kvh, d), (b, skv, kvh, d)))


@pytest.mark.parametrize("causal", [True, False])
def test_attention_vjp_matches_jax(causal):
    """Sq = Skv = 128 reaches the reference's Pallas forward (interpreted)
    and its ``custom_vjp``: the recompute through ``chunked_attention``."""
    q, k, v = _qkv(7, 1, 128, 128, 4, 2, 16)
    g = np.random.default_rng(8).standard_normal(q.shape).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b, c: jops.flash_attention(
        a, b, c, causal=causal), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got_out = tops.flash_attention(tq, tk, tv, causal=causal)
    got = torch.autograd.grad(got_out, (tq, tk, tv), torch.from_numpy(g))
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out),
                               atol=2e-6, rtol=2e-6)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=2e-6,
                                   rtol=2e-6)


@pytest.fixture
def stand_in_kernel(monkeypatch):
    """The wrapper's CUDA route on CPU tensors: ``_on_cuda`` says yes and
    the kernel's launcher is the plain version."""
    monkeypatch.setattr(tops, "_on_cuda", lambda t, what: True)
    monkeypatch.setattr(tops, "flash_prefill_cuda",
                        lambda q, k, v, kv_frac_bits, causal:
                        tref.flash_attention_ref(
                            q, k, v, causal=causal,
                            kv_frac_bits=kv_frac_bits
                            if k.dtype == torch.int8 else None))
    tops.reset_launch_counts()
    yield
    tops.reset_launch_counts()


@pytest.mark.parametrize("causal", [True, False])
def test_flash_function_gradients(stand_in_kernel, causal):
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 2, 24, 40, 4, 2, 16))
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(1))
    want_in = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(tref.flash_attention_ref(
        *want_in, causal=causal), want_in, g)
    got_in = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tops.flash_attention(*got_in, causal=causal)
    assert tops.LAUNCHES["flash_prefill"] == 1
    assert tops.FORM_LAUNCHES["flash_prefill_noncausal"] == int(not causal)
    got = torch.autograd.grad(out, got_in, g)
    assert tops.LAUNCHES["flash_prefill"] == 1      # the backward: no launch
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    # only q requires grad: k and v get none
    q1 = q.clone().requires_grad_()
    (dq,) = torch.autograd.grad(tops.flash_attention(q1, k, v,
                                                     causal=causal), (q1,), g)
    assert torch.equal(dq, want[0])
    # without grad the kernel runs bare
    with torch.no_grad():
        assert not tops.flash_attention(*got_in, causal=causal).requires_grad


def test_flash_function_refuses_int8_codes(stand_in_kernel):
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 1, 16, 16, 2, 1, 8))
    kc, vc = (torch.clamp(torch.round(t * 16), -128, 127).to(torch.int8)
              for t in (k, v))
    with pytest.raises(NotImplementedError, match="no gradient"):
        tops.flash_attention(q.requires_grad_(), kc, vc, kv_frac_bits=4)
    with torch.no_grad():
        tops.flash_attention(q, kc, vc, kv_frac_bits=4)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _opts(kind):
    return (jadamw(), tadamw()) if kind == "adamw" else \
        (jadafactor(), tadafactor())


@pytest.mark.parametrize("kind,accum", [("adamw", 1), ("adamw", 2),
                                        ("adafactor", 1)])
def test_train_step_matches_jax(jparams, kind, accum):
    """From the JAX state after one step (moments non-zero, step 1), one
    more step in each package: the loss, grad_norm, lr, params and
    moments agree."""
    jcfg, tcfg = cfgs()
    jopt, topt = _opts(kind)
    jlr, tlr = jwarmup_cosine(3e-3, 1, 10), twarmup_cosine(3e-3, 1, 10)
    jstep = jax.jit(JS.build_train_step(jcfg, JCtx(), jopt, jlr,
                                        remat=False, accum_steps=accum))
    jp = jax.tree.map(jnp.asarray, jparams["float32"])
    jb0, _ = batch_of(0)
    jp, js, _ = jstep(jp, jopt.init(jp), jb0)
    np_p, np_s = jax.tree.map(np.asarray, (jp, js))
    jb, tb = batch_of(1)
    jp2, js2, jm = jstep(jp, js, jb)
    tp, ts = as_port(np_p, tcfg), TM.from_jax_opt_state(np_s, tcfg,
                                                        device="cpu")
    tstep = TS.build_train_step(tcfg, TCtx(), topt, tlr, remat=False,
                                accum_steps=accum)
    tp2, ts2, tm = tstep(tp, ts, tb)
    assert tp2 is tp and int(ts2.step) == int(js2.step) == 2
    for key in ("loss", "grad_norm", "lr", "nll"):
        assert abs(float(tm[key]) - float(jm[key])) <= 2e-6, key
    assert max_diff(tp2, jax.tree.map(np.asarray, jp2), tcfg) <= 2e-6
    for name in ("m", "v"):
        want = jax.tree.map(np.asarray, getattr(js2, name))
        got = getattr(ts2, name)
        if want is None:
            assert got is None
            continue
        for g, w in zip(leaves(got), leaves(as_port(want, tcfg))):
            err = float((g - w).abs().max() / w.abs().max())
            assert err <= 1e-5, name


def test_three_steps_match_jax(jparams):
    jcfg, tcfg = cfgs()
    jstep = jax.jit(JS.build_train_step(jcfg, JCtx(), jadamw(),
                                        jwarmup_cosine(3e-3, 1, 3),
                                        remat=False))
    tstep = TS.build_train_step(tcfg, TCtx(), tadamw(),
                                twarmup_cosine(3e-3, 1, 3), remat=False)
    jp = jax.tree.map(jnp.asarray, jparams["float32"])
    js = jadamw().init(jp)
    tp = as_port(jparams["float32"], tcfg)
    ts = tadamw().init(tp)
    for i in range(3):
        jb, tb = batch_of(i)
        jp, js, jm = jstep(jp, js, jb)
        tp, ts, tm = tstep(tp, ts, tb)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5, i


@pytest.mark.parametrize("arch", ["llama3_2_1b", "qwen3_32b"])
def test_param_count_and_optimizer_match_jax(arch):
    jcfg, tcfg = jget_config(arch), tget_config(arch)
    n = TS.param_count(tcfg)
    assert n == JS.param_count(jcfg)
    if arch == "llama3_2_1b":
        assert n == 1_235_814_400
    assert TS.pick_optimizer(tcfg).init.__qualname__.split(".")[0] == \
        JS.pick_optimizer(jcfg).init.__qualname__.split(".")[0]


# ---------------------------------------------------------------------------
# the training loop
# ---------------------------------------------------------------------------

def test_train_reduces_loss_and_resumes(tmp_path):
    full = ttrain.train(ARCH, 12, batch=4, seq=32, device="cpu",
                        log_every=100)
    losses = full["losses"]
    assert len(losses) == 12 and np.all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < 0.8 * np.mean(losses[:3])
    # a run checkpointed every 4 steps, its last commit removed, resumes
    # at step 8 from the stream position it saved and ends as the whole
    # run did, bit for bit
    ck = str(tmp_path / "ck")
    first = ttrain.train(ARCH, 12, batch=4, seq=32, device="cpu",
                         ckpt_dir=ck, ckpt_every=4, log_every=100)
    assert first["losses"] == losses
    assert Checkpointer(ck).all_steps() == [4, 8, 12]
    import shutil
    shutil.rmtree(tmp_path / "ck" / "step_000000012")
    resumed = ttrain.train(ARCH, 12, batch=4, seq=32, device="cpu",
                           ckpt_dir=ck, ckpt_every=4, log_every=100)
    assert resumed["losses"] == losses[9:]
    for a, b in zip(leaves(resumed["params"]), leaves(full["params"])):
        assert torch.equal(a, b)


def test_restore_determinism(tmp_path):
    """``tests/test_system.py::test_train_restore_determinism`` on the
    port: checkpoint at step 5, continue; restore and continue; the same
    loss at step 10 (bit for bit on the CPU)."""
    from repro_torch.configs import get_smoke_config as tsmoke
    from repro_torch.core.tree import unflatten
    cfg = tsmoke("qwen3_1_7b").scaled(dtype="float32")
    opt = tadamw(weight_decay=0.0)
    stream = TStream(cfg.vocab_size, 16, 4, seed=5)

    def run(p, s, lo, hi):
        loss = None
        for i in range(lo, hi):
            b = {k: torch.from_numpy(v) for k, v in stream.batch(i).items()}
            loss, _, g = TS.loss_and_grads(p, b, cfg, TCtx())
            p, s = opt.update(unflatten(p, g), s, p, 1e-3)
        return p, s, float(loss)

    params = TM.init_params(cfg, 0, device="cpu")
    state = opt.init(params)
    params, state, _ = run(params, state, 0, 5)
    ck = Checkpointer(str(tmp_path))
    ck.save(5, {"params": params, "opt": state}, blocking=True)
    template = {"params": params, "opt": state}
    _, _, loss_direct = run(params, state, 5, 10)
    restored, _ = ck.restore(template)
    _, _, loss_resumed = run(restored["params"], restored["opt"], 5, 10)
    assert loss_direct == loss_resumed


@pytest.fixture(scope="module")
def trained():
    """``tests/test_system.py``'s trained model on the port: llama smoke
    fp32, AdamW without decay, 200 steps of 8 x 32."""
    from repro_torch.configs import get_smoke_config as tsmoke
    from repro_torch.core.tree import unflatten
    cfg = tsmoke(ARCH).scaled(dtype="float32")
    params = TM.init_params(cfg, 0, device="cpu")
    opt = tadamw(weight_decay=0.0)
    state = opt.init(params)
    stream = TStream(cfg.vocab_size, 32, 8, seed=0)
    lr = twarmup_cosine(3e-3, 20, 200)
    losses = []
    for i in range(200):
        b = {k: torch.from_numpy(v) for k, v in stream.batch(i).items()}
        loss, _, g = TS.loss_and_grads(params, b, cfg, TCtx())
        params, state = opt.update(unflatten(params, g), state, params,
                                   lr(state.step))
        losses.append(float(loss))
    return cfg, params, stream, losses


def test_pipeline_training_reduces_loss(trained):
    _, _, _, losses = trained
    assert np.mean(losses[-20:]) < 0.8 * np.mean(losses[:20])


def test_pipeline_fake_quant_tracks_fp(trained):
    cfg, params, stream, _ = trained
    b = {"tokens": torch.from_numpy(stream.batch(999)["tokens"])}
    with torch.no_grad():
        lf, _ = TM.forward(params, b, cfg, TCtx(mode=TMode.FP))
        lq, _ = TM.forward(params, b, cfg, TCtx(mode=TMode.FAKE))
    agree = float((lf.argmax(-1) == lq.argmax(-1)).float().mean())
    assert agree > 0.9, agree


def test_pipeline_int_serve(trained):
    cfg, params, stream, _ = trained
    tokens = torch.from_numpy(stream.batch(998)["tokens"][:, :31])
    with torch.no_grad():
        for mode in (TMode.FAKE, TMode.INT):
            ctx = TCtx(mode=mode)
            logits, cache = TM.prefill(params, {"tokens": tokens}, cfg, ctx,
                                       max_seq=32)
            assert bool(torch.all(torch.isfinite(logits)))
            tok = logits.argmax(-1)[:, None].to(torch.int32)
            logits2, _ = TM.decode_step(params, tok, cache, 31, cfg, ctx)
            assert bool(torch.all(torch.isfinite(logits2)))


def test_cli_and_train_small_lm(capsys):
    out = ttrain.main(["--arch", ARCH, "--steps", "3", "--batch", "2",
                       "--seq", "16", "--device", "cpu", "--accum", "2",
                       "--attn-kernel", "flash"])
    assert len(out["losses"]) == 3 and out["cfg"].attn_kernel == "flash"
    assert "final loss" in capsys.readouterr().out
    res = train_small_lm.run(30, batch=4, seq=32, device="cpu")
    assert res["losses"][-1] < res["losses"][0]
    assert 0.5 < res["agreement"] <= 1.0
    assert res["ctx"].table
