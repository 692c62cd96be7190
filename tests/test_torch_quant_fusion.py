"""Differential tests: the LM path's fused quantization in the port.

K3's multi-grid form (one read of a module input, codes on up to three
grids) and its quantize-and-scatter form (K/V codes straight to their
pool rows), K2's float epilogue (the module's dequantized output written
by the matmul), and ``qmodel.qlinears`` (modules that read one input,
quantized once).  On the CPU each wrapper runs its plain version
(``kernels.ref``), which must equal the chain it replaces, on the same
numpy inputs:

* ``quantize_multi_ref`` / ``quantize_scatter_ref`` against
  ``qscheme.quant`` (+ ``index_copy_``), bit for bit: bfloat16 and
  float32, one to three grids with repeats, grids -2 / 0 / 4 / 8 / 12,
  exact +-0.5 ties, saturation, -0.0, odd widths, a row index with
  duplicates into the trash block;
* against the JAX package: ``repro.kernels.ops.quantize_act`` (the Pallas
  body in interpret mode, at a shape that reaches it) and
  ``qscheme.dequant`` of the JAX ``int8_matmul`` (its reference and its
  interpreted Pallas body), bit for bit;
* ``qlinears`` against separate ``qlinear`` calls in FP (the same capture
  store, in the same order), FAKE and INT (equal and distinct input
  grids, biases, float and pre-quantized weights), and INT ``qlinear``
  against the chain it replaced (``quant`` -> K2 codes -> ``dequant``);
* the CPU wrappers count no kernel launches, and the CUDA bindings refuse
  CPU tensors.
"""
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.core import qscheme as jqs  # noqa: E402
from repro.core.integer_ops import LinearQuantSpec as JSpec  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import qscheme as tqs  # noqa: E402
from repro_torch.core.integer_ops import LinearQuantSpec  # noqa: E402
from repro_torch.core.qmodel import (ModuleBits, QuantContext,  # noqa: E402
                                     QuantMode, capture_activations,
                                     qlinear, qlinears)
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.int8_matmul import int8_matmul_cuda  # noqa: E402
from repro_torch.kernels.quantize import (quantize_multi_cuda,  # noqa: E402
                                          quantize_scatter_cuda)
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

jnp = jax.numpy
GRIDS = (-2, 0, 4, 8, 12)


def _inputs(rows, cols, ns, seed, dtype):
    """float32 / bfloat16 values on every boundary of each grid in ``ns``:
    exact .5 ties of both signs, codes past the clip range, -0.0 and 0,
    one fp32 ulp beside a tie, and random values spanning the range."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-300, 300, size=rows * cols) * 2.0 ** -max(ns)
    special = []
    for n in ns:
        k = rng.integers(-131, 131, size=24)
        ties = (k + 0.5) * 2.0 ** -n
        special += [ties, np.nextafter(ties.astype(np.float32), np.float32(0)),
                    np.asarray([-129.0, 128.0, 127.5, -128.5, 400.0,
                                -400.0]) * 2.0 ** -n]
    special.append(np.asarray([0.0, -0.0, 0.5, -0.5]))
    special = np.concatenate(special)[: x.size]
    x[: special.size] = special
    x = x.astype(np.float32)
    if dtype == "bfloat16":
        # through JAX's bfloat16 rounding, so both packages see one value
        x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(
            jnp.float32))
    return torch.from_numpy(x.reshape(rows, cols)).to(getattr(torch, dtype))


def _same(got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


# --- K3, multi-grid form ----------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ns", [(4,), (0, 0), (-2, 12), (8, 8, 4),
                                (12, 0, -2), (4, 8, 4)])
@pytest.mark.parametrize("shape", [(24, 64), (5, 37), (1, 3)])
def test_quantize_multi_equals_quant(dtype, ns, shape):
    x = _inputs(*shape, ns, seed=sum(shape) + 31 * len(ns), dtype=dtype)
    want = [tqs.quant(x, n, 8) for n in ns]
    for got in (tref.quantize_multi_ref(x, ns), tops.quantize_multi(x, ns)):
        assert len(got) == len(ns)
        for g, w in zip(got, want):
            _same(g, w)
    # equal grids share one codes tensor
    got = tops.quantize_multi(x, ns)
    for i, j in ((i, j) for i in range(len(ns)) for j in range(len(ns))):
        assert (got[i] is got[j]) == (ns[i] == ns[j])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", GRIDS)
def test_quantize_multi_matches_jax_kernel(dtype, n):
    """The plain multi-grid codes equal the JAX ``quantize_act`` (rows >= 8,
    cols >= 128: the interpreted Pallas body), grid by grid."""
    ns = (n, 4 if n != 4 else 0)
    x = _inputs(16, 256, ns, seed=200 + n, dtype=dtype)
    xj = jnp.asarray(x.float().numpy()).astype(dtype)
    for got, m in zip(tops.quantize_multi(x, ns), ns):
        want = np.asarray(jops.quantize_act(xj, m))
        assert got.numpy().dtype == want.dtype
        assert np.array_equal(got.numpy(), want)


# --- K3, quantize-and-scatter form -------------------------------------------

def _pools(rows, width, seed):
    g = torch.Generator().manual_seed(seed)
    k = torch.randint(-128, 128, (rows, width), generator=g).to(torch.int8)
    return k, torch.randint(-128, 128, (rows, width), generator=g).to(
        torch.int8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", GRIDS)
@pytest.mark.parametrize("width", [64, 15])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_quantize_scatter_equals_quant_index_copy(dtype, n, width,
                                                  idx_dtype):
    """Nine rows into a pool of 6 blocks of 4 rows; three padding rows go
    to the trash block's row 0 and one to its row 2 (duplicates): every
    other pool row equals ``quant`` + ``index_copy_``, and a trash row
    holds the codes of one of the rows sent there."""
    bs, rows = 4, 9
    index = torch.tensor([5, 9, 0, 23, 0, 12, 2, 0, 4], dtype=idx_dtype)
    k = _inputs(rows, width, (n,), seed=300 + n + width, dtype=dtype)
    v = _inputs(rows, width, (n,), seed=301 + n + width, dtype=dtype)
    kq, vq = tqs.quant(k, n, 8), tqs.quant(v, n, 8)
    want_k, want_v = _pools(6 * bs, width, seed=n + width)
    want_k.index_copy_(0, index.long(), kq)
    want_v.index_copy_(0, index.long(), vq)
    for scatter in (tref.quantize_scatter_ref, tops.quantize_scatter):
        got_k, got_v = _pools(6 * bs, width, seed=n + width)
        scatter(k, v, index, got_k, got_v, n=n)
        live = torch.ones(6 * bs, dtype=torch.bool)
        live[:bs] = False
        _same(got_k[live], want_k[live])
        _same(got_v[live], want_v[live])
        for row in (0, 2):
            sent = (index == row).nonzero().flatten()
            for got, codes in ((got_k, kq), (got_v, vq)):
                assert any(torch.equal(got[row], codes[i]) for i in sent)
        untouched = torch.tensor([1, 3])
        _same(got_k[untouched], _pools(6 * bs, width, n + width)[0][untouched])


# --- K2, float epilogue -------------------------------------------------------

def _codes(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-128, 128, size=shape).astype(np.int8)


SPECS = {"plain": dict(n_x=4, n_w=8, n_b=None, n_o=4),
         "bias<<": dict(n_x=4, n_w=8, n_b=7, n_o=4),
         "bias>>": dict(n_x=2, n_w=3, n_b=9, n_o=4),
         "shift<0": dict(n_x=0, n_w=1, n_b=1, n_o=6),
         "n_o<0": dict(n_x=-1, n_w=2, n_b=None, n_o=-3)}


@pytest.mark.parametrize("spec_name", sorted(SPECS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(5, 48, 24), (16, 128, 128)])
def test_int8_matmul_float_epilogue(spec_name, dtype, m, k, n):
    """K2's float epilogue (plain version and ``ops.int8_matmul`` with
    ``out_float``) equals ``dequant`` of its codes, in the port and of
    the JAX ``int8_matmul`` (its reference, and at 16 x 128 x 128 its
    interpreted Pallas body)."""
    sd = SPECS[spec_name]
    n_b = sd["n_b"] if sd["n_b"] is not None else sd["n_w"]
    x, w = _codes((m, k), m + k), _codes((k, n), n + 7)
    b = _codes((n,), n) if sd["n_b"] is not None else None
    spec = LinearQuantSpec(n_x=sd["n_x"], n_w=sd["n_w"], n_b=n_b,
                           n_o=sd["n_o"], bits=8)
    jspec = JSpec(n_x=sd["n_x"], n_w=sd["n_w"], n_b=n_b, n_o=sd["n_o"],
                  bits=8)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    bt = None if b is None else torch.from_numpy(b)
    out_dt = getattr(torch, dtype)
    codes = tops.int8_matmul(xt, wt, bt, spec)
    got = tops.int8_matmul(xt, wt, bt, spec, out_float=out_dt)
    _same(got, tqs.dequant(codes, sd["n_o"], out_dtype=out_dt))
    _same(tref.int8_matmul_ref(xt, wt, bt, shift=spec.requant_shift,
                               bias_shift=spec.bias_shift, out_dtype=out_dt,
                               n_o=sd["n_o"]), got)
    jb = None if b is None else jnp.asarray(b)
    for force in (False, True) if m >= 16 else (False,):
        jc = jops.int8_matmul(jnp.asarray(x), jnp.asarray(w), jb, jspec,
                              force_kernel=force)
        want = np.asarray(jqs.dequant(jc, sd["n_o"], out_dtype=jnp.float32))
        assert np.array_equal(got.float().numpy(), want)


def test_int8_matmul_float_epilogue_refuses():
    spec = LinearQuantSpec(n_x=4, n_w=8, n_b=8, n_o=4, bits=8)
    x, w = torch.zeros(2, 16, dtype=torch.int8), torch.zeros(
        16, 8, dtype=torch.int8)
    with pytest.raises(TypeError):
        tops.int8_matmul(x, w, None, spec, out_float=torch.float16)
    with pytest.raises(ValueError):
        tref.int8_matmul_ref(x, w, None, shift=8, out_dtype=torch.float32)


# --- qlinears -----------------------------------------------------------------

NAMES = ("attn/wq", "attn/wk", "attn/wv")
TABLES = {
    "default": {},
    "equal": {nm: ModuleBits(n_x=3, n_w=7, n_o=2) for nm in NAMES},
    "distinct": {"attn/wq": ModuleBits(n_x=3, n_w=7, n_o=2),
                 "attn/wk": ModuleBits(n_x=5, n_w=8, n_b=6, n_o=4),
                 "attn/wv": ModuleBits(n_x=-1, n_w=6, n_o=0)},
    "two of three": {"attn/wq": ModuleBits(n_x=2, n_w=7, n_o=3),
                     "attn/wk": ModuleBits(n_x=6, n_w=8, n_o=1),
                     "attn/wv": ModuleBits(n_x=2, n_w=6, n_o=5)},
}


def _module_inputs(dtype, seed, bias):
    g = torch.Generator().manual_seed(seed)
    dt = getattr(torch, dtype)
    x = (torch.randn(2, 5, 32, generator=g) * 3).to(dt)
    ws = [(torch.randn(32, nout, generator=g) * 0.1).to(dt)
          for nout in (48, 16, 16)]
    bs = ([(torch.randn(nout, generator=g) * 0.2).to(dt)
           for nout in (48, 16, 16)] if bias else [None] * 3)
    return x, ws, bs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["fp", "fake"])
@pytest.mark.parametrize("bias", [False, True])
def test_qlinears_float_modes_loop_qlinear(dtype, mode, bias):
    x, ws, bs = _module_inputs(dtype, 5, bias)
    ctx = QuantContext(mode=QuantMode(mode), table=TABLES["distinct"])
    with capture_activations() as got_store:
        got = qlinears(ctx, NAMES, x, ws, bs)
    with capture_activations() as want_store:
        want = [qlinear(ctx, nm, x, w, b) for nm, w, b in zip(NAMES, ws, bs)]
    for g_, w_ in zip(got, want):
        _same(g_, w_)
    assert list(got_store) == list(want_store)
    if mode == "fp":
        assert list(got_store) == list(NAMES)
        for nm in NAMES:
            for a, b_ in zip(got_store[nm], want_store[nm]):
                assert (a is None and b_ is None) or torch.equal(a, b_)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("prequant", [False, True])
def test_qlinears_int_equals_qlinear_and_old_chain(dtype, table, bias,
                                                   prequant):
    """INT ``qlinears`` equals separate ``qlinear`` calls, and each equals
    the chain the port ran before K3 and K2's float epilogue took the
    module boundary: ``quant`` -> K2 codes -> ``dequant``."""
    x, ws, bs = _module_inputs(dtype, 11, bias)
    ctx = QuantContext(mode=QuantMode.INT, table=TABLES[table])
    mbs = [ctx.bits_for(nm) for nm in NAMES]
    if prequant:
        ws = [tqs.quant(w, mb.n_w, 8) for w, mb in zip(ws, mbs)]
    got = qlinears(ctx, NAMES, x, ws, bs)
    for g_, nm, w, b, mb in zip(got, NAMES, ws, bs, mbs):
        _same(g_, qlinear(ctx, nm, x, w, b))
        n_b = mb.n_b if mb.n_b is not None else mb.n_w
        spec = LinearQuantSpec(n_x=mb.n_x, n_w=mb.n_w, n_b=n_b, n_o=mb.n_o,
                               bits=8)
        w_int = w if w.dtype == torch.int8 else tqs.quant(w, mb.n_w, 8)
        b_int = None if b is None else tqs.quant(b, n_b, 8)
        codes = tref.int8_matmul_ref(tqs.quant(x, mb.n_x, 8), w_int, b_int,
                                     shift=spec.requant_shift,
                                     bias_shift=spec.bias_shift)
        _same(g_, tqs.dequant(codes, mb.n_o, out_dtype=x.dtype))


# --- launches and refusals ------------------------------------------------------

def test_cpu_wrappers_count_no_launches():
    tops.reset_launch_counts()
    x, ws, bs = _module_inputs("bfloat16", 3, True)
    ctx = QuantContext(mode=QuantMode.INT, table=TABLES["distinct"])
    qlinears(ctx, NAMES, x, ws, bs)
    qlinear(ctx, "attn/wo", x, ws[0], bs[0])
    tops.quantize_multi(x, (1, 2, 3))
    tops.quantize_act(x, 4)
    k_rows, v_rows = _pools(8, 32, 0)
    tops.quantize_scatter(x[0], x[1], torch.tensor([1, 2, 3, 0, 0]), k_rows,
                          v_rows, n=4)
    assert all(n == 0 for n in tops.LAUNCHES.values()), tops.LAUNCHES


def test_cuda_bindings_refuse_cpu_tensors():
    x = torch.zeros(4, 8)
    k_rows, v_rows = _pools(8, 8, 0)
    with pytest.raises(ValueError):
        quantize_multi_cuda(x, [4], lo=-128, hi=127)
    with pytest.raises(ValueError):
        quantize_scatter_cuda(x, x, torch.arange(4), k_rows, v_rows, n=4,
                              lo=-128, hi=127)
    with pytest.raises(ValueError):
        int8_matmul_cuda(x.to(torch.int8), k_rows, None, shift=0,
                         bias_shift=0, relu=False, lo=-128, hi=127,
                         out_dtype=torch.bfloat16, n_o=4)
    # a wrapper launches on a CUDA tensor, runs its plain version on a
    # CPU or meta one (there only the output's shape), and refuses any
    # other device
    with pytest.raises(ValueError, match="no kernel for device"):
        tops._on_cuda(types.SimpleNamespace(device=torch.device("xpu")),
                      "quantize_multi")
    (codes,) = tops.quantize_multi(x.to("meta"), [4])
    assert codes.device.type == "meta" and codes.shape == x.shape


def test_quantize_act_emits_8_bit_codes_only_on_the_card(monkeypatch):
    """On a CUDA tensor ``quantize_act`` is K3's one-grid form, which
    writes one byte a code: wider codes are refused before any launch."""
    monkeypatch.setattr(tops, "_on_cuda", lambda t, what: True)
    before = tops.LAUNCHES["quantize"]
    with pytest.raises(ValueError, match="8-bit codes"):
        tops.quantize_act(torch.zeros(4, 8), 3, bits=12)
    assert tops.LAUNCHES["quantize"] == before
