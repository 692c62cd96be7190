"""``kernels.cost``, each kernel's one reckoning, against the bounds of
PERF.md §6's kernel table: at each shape ``chip_smoke.py`` times, the
bytes (and, where the bound is the operations', the operations) the
reckoning gives, over the card's rates, are the table's bound to the
digits the table prints.  So the dry run's kernel charges and the table's
bounds are one reckoning.

The operands' values only matter where the work depends on them (a
ragged step's descriptors, K4's positions, K6's position): those are
real CPU tensors, everything else lives on the meta device."""
import math

import pytest
import torch

import chip_smoke as CS
from repro_torch.configs.resnet_paper import CONFIG as RESNET
from repro_torch.core.integer_ops import LinearQuantSpec
from repro_torch.kernels import cost
from tests.torch_threads import one_torch_thread  # noqa: F401

BF16, I8, U8, F32 = torch.bfloat16, torch.int8, torch.uint8, torch.float32
# the operand type each kernel's operations run in: the peak its bound
# divides by (PERF.md §6: the int8 tensor cores, the bf16 ones, or the
# CUDA cores' fp32 rate for elementwise work)
OP_TYPE = {"ragged_attention": "bfloat16", "paged_attention": "bfloat16",
           "flash_attention": "bfloat16", "flash_decode": "bfloat16",
           "int8_matmul": "int8", "int8_matmul_partial": "int8",
           "int8_matmul_finish": "float32", "int8_matmul_grouped": "int8",
           "int8_matmul_grouped_partial": "int8", "quantize_act": "float32",
           "quantize_multi": "float32", "quantize_scatter": "float32",
           "residual_requant": "float32", "int_conv2d": "int8"}


def meta(*shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta")


def bound_ms(fn, *args, **kw):
    """(bound ms, bound_by) of ``fn``'s reckoning, as chip_smoke's."""
    flops, n_bytes = fn(*args, **kw)
    return CS.bound_ms(n_bytes, flops, OP_TYPE[fn.__name__])


def same(got: float, table: str) -> bool:
    """``got`` is the table's number to the digits the table prints: less
    than one unit of its last digit apart (the table rounds, or in places
    cuts, the script's number)."""
    want = float(table)
    digits = len(table.replace(".", "").lstrip("0"))
    unit = 10.0 ** (math.floor(math.log10(want)) - digits + 1)
    return abs(got - want) < unit


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

def k1_args(items, pad_rows=CS.K1_PAD_ROWS):
    """chip_smoke's K1 work-list layout at qwen3-1.7B's heads: the
    descriptors real, q and the int8 pools shapes only."""
    h, kvh, d, bs = CS.K1_HEADS, CS.K1_KV_HEADS, CS.K1_DIM, CS.K1_BS
    ns = len(items)
    nbmax = -(-max(kl for _, kl in items) // bs)
    t = sum(q for q, _ in items) + pad_rows
    q_len = torch.tensor([a for a, _ in items] + [0], dtype=torch.int32)
    kv_len = torch.tensor([b for _, b in items] + [0], dtype=torch.int32)
    q_start = torch.zeros_like(q_len)
    bt = torch.zeros((ns + 1, nbmax), dtype=torch.int32)
    pool = meta(1 + ns * nbmax, bs, kvh, d, dtype=I8)
    return (meta(t, h, d), pool, pool, bt, q_start, q_len, kv_len)


@pytest.mark.parametrize("items,pad,mb", [
    (CS.K1_ITEMS, CS.K1_PAD_ROWS, "1.09"),
    (CS.K1_STEP_ITEMS, CS.K1_STEP_T - 18, "0.49"),
    (CS.K1_LONG_ITEMS, CS.K1_PAD_ROWS, "76.0")],
    ids=["mixed", "engine step", "long"])
def test_k1_bytes(items, pad, mb):
    flops, n_bytes = cost.ragged_attention(*k1_args(items, pad))
    assert same(n_bytes / 1e6, mb)
    # each real token's causal rows, QK and PV
    pairs = sum(sum(kl - ql + i + 1 for i in range(ql)) for ql, kl in items)
    assert flops == pairs * CS.K1_HEADS * 4 * CS.K1_DIM


def test_k1_meta_counts_full_tables():
    q, kp, vp, bt, qs, ql, kl = k1_args(CS.K1_ITEMS)
    real = cost.ragged_attention(q, kp, vp, bt, qs, ql, kl)
    full = cost.ragged_attention(q, kp, vp, bt, qs.to("meta"),
                                 ql.to("meta"), kl.to("meta"))
    assert full[0] > real[0] and full[1] > real[1]


# ---------------------------------------------------------------------------
# K2 and its forms
# ---------------------------------------------------------------------------

SPEC = LinearQuantSpec(n_x=4, n_w=8, n_b=8, n_o=4)


def test_k2_engine_step():
    """197 launches at M = 24: 1.77 GB with the float (bf16) epilogue,
    0.522 ms with the codes."""
    m = CS.K2_STEP_ROWS
    fl = codes = 0
    for (k, n), per in CS.K2_SHAPES.items():
        x, w = meta(m, k, dtype=I8), meta(k, n, dtype=I8)
        fl += per * cost.int8_matmul(x, w, None, SPEC, out_float=BF16)[1]
        codes += per * cost.int8_matmul(x, w, None, SPEC)[1]
    assert same(fl / 1e9, "1.77")
    assert same(CS.bound_ms(codes, 0, "int8")[0], "0.522")


@pytest.mark.parametrize("shape,table", [((6000, 1280, 1280), "0.0099"),
                                         ((6000, 1280, 5120), "0.0397"),
                                         ((6000, 5120, 1280), "0.0397")])
def test_k2_whisper_operations(shape, table):
    m, k, n = shape
    ms, by = bound_ms(cost.int8_matmul, meta(m, k, dtype=I8),
                      meta(k, n, dtype=I8), meta(n, dtype=I8), SPEC,
                      out_float=BF16)
    assert by == "operations" and same(ms, table)


def test_k2_rank_split():
    """wo over 2 ranks at M 24: the partial 0.00069 ms, the finish
    0.00009 ms (bytes)."""
    m, k, n = CS.TP_TIMED_ROWS, 1024, 2048
    ms, by = bound_ms(cost.int8_matmul_partial, meta(m, k, dtype=I8),
                      meta(k, n, dtype=I8))
    assert by == "bytes" and same(ms, "0.00069")
    ms, by = bound_ms(cost.int8_matmul_finish, meta(m, n, dtype=torch.int32),
                      None, SPEC, out_float=BF16)
    assert by == "bytes" and same(ms, "0.00009")


def test_k2_grouped_counts_live_rows():
    """The grouped form reads the live rows and the active experts'
    weights (the bound of PERF.md's grouped rows); meta: every expert
    full."""
    e, c, k, n = 4, 8, 32, 16
    x, w = meta(e, c, k, dtype=I8), meta(e, k, n, dtype=I8)
    counts = torch.tensor([3, 0, 8, 1], dtype=torch.int32)
    flops, n_bytes = cost.int8_matmul_grouped(x, w, counts, SPEC,
                                              rows_cap=5, out_float=BF16)
    rows = 3 + 5 + 1
    assert flops == 2 * rows * k * n
    assert n_bytes == 3 * k * n + rows * k + 2 * rows * n
    seg = torch.tensor([[1, 2], [0, 0], [4, 4], [0, 3]], dtype=torch.int32)
    flops, n_bytes = cost.int8_matmul_grouped_partial(x, w, seg)
    rows = 1 + 2 + 4 + 4 + 3
    assert (flops, n_bytes) == (2 * rows * k * n,
                                3 * k * n + rows * k + 4 * rows * n)
    flops, _ = cost.int8_matmul_grouped(x, w, counts.to("meta"), SPEC)
    assert flops == 2 * e * c * k * n


# ---------------------------------------------------------------------------
# K3, K7, the convolution kernel
# ---------------------------------------------------------------------------

def test_k3_engine_step():
    """141 launches at T 24 (bf16): 29.0 MB, 0.00867 ms; a (24, 2048)
    input alone 0.000044 ms."""
    t = CS.K2_STEP_ROWS
    total = 0
    for _, width, per in CS.K3_STEP_INPUTS:
        total += per * cost.quantize_multi(meta(t, width), (4,))[1]
    kv = meta(t, CS.K3_SCATTER_WIDTH)
    idx = meta(t, dtype=torch.int32)
    total += CS.K3_SCATTER_PER_STEP * cost.quantize_scatter(
        kv, kv, idx, None, None, n=4)[1]
    assert same(total / 1e6, "29.0")
    assert same(CS.bound_ms(total, 0, "float32")[0], "0.00867")
    assert same(bound_ms(cost.quantize_multi, meta(t, 2048), (4,))[0],
                "0.000044")
    # three grids read the input once, write three codes tensors
    assert cost.quantize_multi(meta(t, 2048), (3, 4, 5)) == (
        12 * t * 2048, 5 * t * 2048)


def test_k3_resnet_and_long():
    img, head_in, _, _ = CS._resnet_shapes(RESNET, CS.RESNET_BATCH)
    total = sum(cost.quantize_act(meta(*s, dtype=F32), 7)[1]
                for s in (img, head_in))
    assert same(total / 1e6, "4.0")
    assert same(CS.bound_ms(total, 0, "float32")[0], "0.00120")
    assert same(bound_ms(cost.quantize_act, meta(CS.ELEMWISE_LONG,
                                                 dtype=F32), 5)[0], "0.1002")


def test_k7_six_adds_and_long():
    _, _, adds, _ = CS._resnet_shapes(RESNET, CS.RESNET_BATCH)
    total = sum(cost.residual_requant(meta(*s, dtype=da),
                                      meta(*s, dtype=db))[1]
                for s, da, db in adds)
    assert len(adds) == 6 and same(total / 1e6, "44.0")
    assert same(CS.bound_ms(total, 0, "float32")[0], "0.01315")
    n = CS.ELEMWISE_LONG
    assert same(bound_ms(cost.residual_requant, meta(n, dtype=I8),
                         meta(n, dtype=U8))[0], "0.0601")


def test_conv_forward():
    """The forward's 15 convolutions (conv2 with its residual epilogue):
    0.02721 ms of bytes."""
    _, _, _, convs = CS._resnet_shapes(RESNET, CS.RESNET_BATCH)
    total = ops = 0
    for _, shape, cout, k, stride, xdt, scdt in convs:
        fl, nb = cost.int_conv2d(
            meta(*shape, dtype=xdt), meta(k, k, shape[3], cout, dtype=I8),
            meta(cout, dtype=I8), SPEC, stride=stride,
            residual=None if scdt is None else (None, 7, 6, 7))
        total, ops = total + nb, ops + fl
    assert len(convs) == 15
    ms, by = CS.bound_ms(total, ops, "int8")
    assert by == "bytes" and same(ms, "0.02721")


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------

def k4_args(b, c, h, kvh, d, nbmax, last, kv_dt, spec=False):
    """chip_smoke's ``_k4_case`` layout: positions real, q and pools
    shapes only."""
    w = nbmax + 1 if spec else nbmax
    pos = torch.zeros((b, c), dtype=torch.int32)
    for i in range(b):
        pos[i] = torch.tensor([max(last[i] - c + 1 + j, 0)
                               for j in range(c)], dtype=torch.int32)
    if spec:
        pos[b - 1, -1] = nbmax * 16
    pool = meta(1 + b * nbmax, 16, kvh, d, dtype=kv_dt)
    return (meta(b, c, h, d), pool, pool,
            torch.zeros((b, w), dtype=torch.int32), pos)


@pytest.mark.parametrize("b,c,nbmax,last,spec,mb,ms", [
    (4, 1, CS.K4_NBMAX, CS.K4_DECODE_POS, False, "0.43", "0.00013"),
    (1, 16, CS.K4_NBMAX, CS.K4_DECODE_POS[:1], False, "0.22", "0.00006"),
    (4, 4, CS.K4_NBMAX, CS.K4_DECODE_POS, True, "0.54", "0.00016"),
    (4, 1, CS.K4_LONG_BLOCKS, (CS.K4_LONG_BLOCKS * 16 - 1,) * 4, False,
     "268.5", "0.0801")], ids=["decode", "prefill", "verify", "long"])
def test_k4_engine_shapes(b, c, nbmax, last, spec, mb, ms):
    args = k4_args(b, c, CS.K1_HEADS, CS.K1_KV_HEADS, CS.K1_DIM, nbmax, last,
                   I8, spec)
    flops, n_bytes = cost.paged_attention(*args)
    assert same(n_bytes / 1e6, mb)
    assert same(CS.bound_ms(n_bytes, flops, "bfloat16")[0], ms)


@pytest.mark.parametrize("kv_dt,ms", [(I8, "0.00118"), (BF16, "0.00158")])
def test_k4_zamba2_shared_block(kv_dt, ms):
    b, c, h, d, nbmax = 4, CS.HYBRID_CHUNK, 32, 80, CS.HYBRID_NBMAX
    pos = torch.full((b, c), nbmax * 16, dtype=torch.int32)
    for i, (start, n) in enumerate(
            CS.HYBRID_K4_CASES["decode step"]):
        pos[i, :n] = torch.arange(start, start + n, dtype=torch.int32)
    pool = meta(1 + b * nbmax, 16, h, d, dtype=kv_dt)
    flops, n_bytes = cost.paged_attention(
        meta(b, c, h, d), pool, pool,
        torch.zeros((b, nbmax + 1), dtype=torch.int32), pos)
    assert same(CS.bound_ms(n_bytes, flops, "bfloat16")[0], ms)
    if kv_dt == I8:
        assert same(n_bytes / 1e6, "3.95")


# ---------------------------------------------------------------------------
# K5, K6
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,sq,skv,h,kvh,dk,dv,kv_dt,causal,table,by", [
    (CS.TRAIN_B, CS.TRAIN_S, CS.TRAIN_S, 32, 8, 64, 64, BF16, True, "10.5",
     "MB"),
    (4, CS.WHISPER_FRAMES, CS.WHISPER_FRAMES, 20, 20, 64, 64, BF16, False,
     "46.1", "GFLOP"),
    (4, 32, CS.WHISPER_FRAMES, 20, 20, 64, 64, BF16, False, "31.4", "MB"),
    (1, 4096, 4096, 16, 8, 128, 128, BF16, True, "68.7", "GFLOP"),
    (4, 128, 128, 128, 128, 192, 128, BF16, True, "0.02504", "ms"),
    (4, 32, 32, 128, 128, 192, 128, BF16, True, "0.00626", "ms"),
    (4, 32, 48, 32, 32, 80, 80, I8, True, "0.00059", "ms"),
    (4, 32, 48, 24, 8, 64, 64, I8, True, "0.00027", "ms"),
    (4, 32, 48, 16, 8, 128, 128, I8, True, "0.00039", "ms")],
    ids=["train shape", "whisper encoder", "whisper cross", "long",
         "MLA training", "MLA serve", "zamba2", "granite", "path"])
def test_k5(b, sq, skv, h, kvh, dk, dv, kv_dt, causal, table, by):
    args = (meta(b, sq, h, dk), meta(b, skv, kvh, dk, dtype=kv_dt),
            meta(b, skv, kvh, dv, dtype=kv_dt))
    flops, n_bytes = cost.flash_attention(*args, causal=causal)
    got = {"MB": n_bytes / 1e6, "GFLOP": flops / 1e9,
           "ms": CS.bound_ms(n_bytes, flops, "bfloat16")[0]}[by]
    assert same(got, table)


@pytest.mark.parametrize("b,s_max,pos,h,kvh,d,kv_dt,table,by", [
    (4, 48, 47, 16, 8, 128, I8, "0.00013", "ms"),
    (4, 48, 47, 24, 8, 64, I8, "0.00007", "ms"),
    (4, CS.WHISPER_FRAMES, CS.WHISPER_FRAMES - 1, 20, 20, 64, BF16, "30.7",
     "MB"),
    (4, CS.K6_LONG, CS.K6_LONG - 1, 16, 8, 128, I8, "268", "MB"),
    (4, CS.K6_LONG, CS.K6_EARLY_POS, 16, 8, 128, I8, "0.00026", "ms"),
    (4, 48, 47, 32, 32, 80, I8, "0.00031", "ms"),
    (4, CS.K6_LONG, CS.K6_LONG - 1, 32, 32, 80, I8, "671", "MB")],
    ids=["path", "granite", "whisper cross", "long", "pos 100", "zamba2",
         "zamba2 long"])
def test_k6(b, s_max, pos, h, kvh, d, kv_dt, table, by):
    args = (meta(b, 1, h, d), meta(b, s_max, kvh, d, dtype=kv_dt),
            meta(b, s_max, kvh, d, dtype=kv_dt))
    for p in (pos, torch.tensor(pos, dtype=torch.int32)):
        flops, n_bytes = cost.flash_decode(*args, pos=p)
        got = {"MB": n_bytes / 1e6,
               "ms": CS.bound_ms(n_bytes, flops, "bfloat16")[0]}[by]
        assert same(got, table)
    # a position on the meta device: the cache's last row
    assert cost.flash_decode(*args, pos=meta(dtype=torch.int32)) == \
        cost.flash_decode(*args, pos=s_max - 1)


def test_wrappers_charge_their_reckoning_once():
    """Under a counter each wrapper charges its reckoning once a call, its
    plain version's aten ops uncounted, its output a live allocation."""
    from repro_torch.kernels import ops
    from repro_torch.launch.analysis import CostMode
    g = torch.Generator().manual_seed(0)
    x = torch.randint(-128, 128, (5, 64), dtype=I8, generator=g)
    w = torch.randint(-128, 128, (64, 32), dtype=I8, generator=g)
    q = torch.randn(2, 8, 4, 16, generator=g)
    k = torch.randn(2, 8, 2, 16, generator=g)
    with CostMode() as m:
        out = ops.int8_matmul(x, w, None, SPEC, out_float=BF16)
        att = ops.flash_attention(q, k, k)
    want = {"int8_matmul": cost.int8_matmul(x, w, None, SPEC,
                                            out_float=BF16),
            "flash_attention": cost.flash_attention(q, k, k)}
    assert m.ops == 0
    assert m.kernels == {n: [1, float(f), float(b)]
                         for n, (f, b) in want.items()}
    assert m.flops == sum(f for f, _ in want.values())
    assert m.bytes == sum(b for _, b in want.values())
    assert m.peak == out.untyped_storage().nbytes() \
        + att.untyped_storage().nbytes()
    for name in OP_TYPE:
        assert hasattr(getattr(ops, name), "__wrapped__"), name
