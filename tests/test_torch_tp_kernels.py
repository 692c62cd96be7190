"""K2's rank-split form and the vocab-cut embedding against the whole
product, without processes.

* K2: a row-cut module's input and weight are cut into R pieces of K
  rows (R = 2, 4), each piece's int32 partial taken alone
  (``ops.int8_matmul_partial``), the partials summed in int32 (what the
  ranks' all-reduce does), and the epilogue run once
  (``ops.int8_matmul_finish``): bit-identical to ``ops.int8_matmul`` on
  the whole product, over shapes (qwen3-1.7B's ``wo`` and ``w2`` at a few
  rows among them), with and without a bias, int8 and uint8 (ReLU)
  inputs, codes and float outputs.
* ``models.common.embed`` / ``unembed`` on a rank: each rank's masked
  lookup of its vocab rows, their bit patterns summed, is the whole
  table's lookup bit for bit (a -0.0 row included); each rank's logits
  of its vocab columns, concatenated, are the whole head's (bit for bit
  in INT mode).  A stand-in rank whose collectives return its own part
  lets one process play every rank.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.integer_ops import LinearQuantSpec
from repro_torch.core.qmodel import QuantContext, QuantMode
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops, ref
from repro_torch.models.common import embed, unembed
from tests.torch_threads import one_torch_thread  # noqa: F401

SHAPES = [(1, 64, 32), (4, 96, 48), (24, 256, 128), (7, 2048, 64),
          (3, 6144, 40)]


def _codes(rng, shape, unsigned=False):
    lo, hi = (0, 256) if unsigned else (-128, 128)
    return torch.from_numpy(rng.integers(lo, hi, size=shape)).to(
        torch.uint8 if unsigned else torch.int8)


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_rank_split_k2_equals_whole_product(ranks, m, k, n):
    rng = np.random.default_rng(m * 7 + k + n + ranks)
    w = _codes(rng, (k, n))
    bias = _codes(rng, (n,))
    specs = [LinearQuantSpec(n_x=4, n_w=7, n_b=5, n_o=3),
             LinearQuantSpec(n_x=3, n_w=8, n_b=8, n_o=6, out_unsigned=True),
             LinearQuantSpec(n_x=5, n_w=9, n_b=2, n_o=-1)]
    cut = k // ranks
    for unsigned in (False, True):
        x = _codes(rng, (m, k), unsigned)
        parts = [ops.int8_matmul_partial(x[:, r * cut:(r + 1) * cut],
                                         w[r * cut:(r + 1) * cut])
                 for r in range(ranks)]
        assert all(p.dtype == torch.int32 and p.shape == (m, n)
                   for p in parts)
        acc = parts[0].clone()
        for p in parts[1:]:
            acc += p                    # the ranks' int32 all-reduce
        for spec in specs:
            for b in (None, bias):
                for relu, out_float in ((False, None), (True, None),
                                        (False, torch.bfloat16),
                                        (False, torch.float32)):
                    want = ops.int8_matmul(x, w, b, spec, relu=relu,
                                           out_float=out_float)
                    got = ops.int8_matmul_finish(acc, b, spec, relu=relu,
                                                 out_float=out_float)
                    assert got.dtype == want.dtype
                    assert torch.equal(got, want), (spec, b is None, relu,
                                                    out_float, unsigned)


def test_partial_is_the_plain_int32_sum():
    rng = np.random.default_rng(3)
    x, w = _codes(rng, (5, 2, 64)), _codes(rng, (64, 24))
    got = ops.int8_matmul_partial(x, w)
    want = (x.to(torch.int64) @ w.to(torch.int64)).to(torch.int32)
    assert got.shape == (5, 2, 24) and torch.equal(got, want)
    assert torch.equal(ref.int8_matmul_partial_ref(x, w), want)


class _Rank:
    """One rank of a (1, R) mesh whose collectives return this rank's own
    part (the test adds or gathers the parts itself)."""

    axis_names = ("data", "model")

    def __init__(self, r, ranks):
        self.shape = {"data": 1, "model": ranks}
        self.coords = {"data": 0, "model": r}

    def all_reduce(self, t, axis="model", op="sum"):
        return t

    def all_gather(self, t, axis="model", dim=-1):
        return t


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("ranks", [2, 4])
def test_vocab_cut_embed(ranks, dtype):
    gen = torch.Generator().manual_seed(0)
    table = torch.randn((64, 16), generator=gen).to(dtype)
    table[37, 3] = -0.0
    tokens = torch.tensor([[0, 37, 63, 16], [15, 31, 32, 48]])
    rows = 64 // ranks
    bits = None
    for r in range(ranks):
        with shd.activation_sharding(_Rank(r, ranks)):
            part = embed(table[r * rows:(r + 1) * rows], tokens, dtype)
        b = part.contiguous().view(torch.int32)
        bits = b.clone() if bits is None else bits + b
    got = bits.view(dtype)
    want = embed(table, tokens, dtype)
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16
                                 else torch.int32))
    assert torch.signbit(got[0, 1, 3])          # the -0.0 kept


@pytest.mark.parametrize("mode", ["fp", "int"])
@pytest.mark.parametrize("ranks", [2, 4])
def test_vocab_cut_unembed(ranks, mode):
    gen = torch.Generator().manual_seed(1)
    head = torch.randn((32, 128), generator=gen) * 0.1
    x = torch.randn((6, 32), generator=gen)
    ctx = QuantContext(mode=QuantMode(mode))
    cols = 128 // ranks
    parts = []
    for r in range(ranks):
        with shd.activation_sharding(_Rank(r, ranks)):
            parts.append(unembed(ctx, x, head[:, r * cols:(r + 1) * cols]))
    got = torch.cat(parts, dim=-1)
    want = unembed(ctx, x, head)
    if mode == "int":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_row_cut_qlinear_sums_int32_partials():
    """``qlinear(..., reduce=True)`` on each rank of a row cut gives that
    rank's int32 partial to the all-reduce; summed, the finish is the
    whole module's output (INT), as the stand-in shows by adding the
    partials the way the rank-split K2 form does."""
    from repro_torch.core import qmodel
    gen = torch.Generator().manual_seed(2)
    w = torch.randn((64, 24), generator=gen) * 0.05
    x = torch.randn((5, 64), generator=gen)
    ctx = QuantContext(mode=QuantMode.INT)
    want = qmodel.qlinear(ctx, "attn/wo", x, w)
    acc = []

    class Summing(_Rank):
        def all_reduce(self, t, axis="model", op="sum"):
            acc.append(t.clone())
            return t

    for r in range(2):
        with shd.activation_sharding(Summing(r, 2)):
            qmodel.qlinear(ctx, "attn/wo", x[:, r * 32:(r + 1) * 32],
                           w[r * 32:(r + 1) * 32], reduce=True)
    spec = LinearQuantSpec(n_x=4, n_w=8, n_b=8, n_o=4)
    total = acc[0] + acc[1]
    got = ops.int8_matmul_finish(total, None, spec, out_float=x.dtype)
    assert torch.equal(got, want)
