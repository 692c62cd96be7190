"""Feed-forward layers (PyTorch counterpart of ``repro.models.mlp``): the
SwiGLU MLP, whisper's non-gated gelu MLP and the token-choice mixture of
experts.

Quantization placement (paper Fig. 1(b) generalized): ``w1`` and ``w3``
read the same input, quantized once for both (``qlinears``); the gate product
``silu(w1 x) * (w3 x)`` is ONE unified module — a single activation quant
point after the product feeds the down-projection.  The MoE router stays
fp32 (tiny, numerically sensitive — as softmax in the paper).

MoE dispatch is the reference's capacity-based, sort-free scatter:
  1. top-k routing, probabilities renormalized;
  2. each (token, k) pair gets a position in its expert by a one-hot
     cumsum in (token, k) order; pairs past the capacity C drop;
  3. kept pairs scatter into an (E, C, d) buffer and the experts run as
     ONE batched product a projection (in INT mode K2's grouped form,
     each expert's live rows read on the card);
  4. results gather back weighted by the router's probabilities.
The ranking is per data shard, as the reference's (each shard owns its
slice of every expert's capacity); in one process ``moe(data_shards=D)``
gives that D-shard result.  Off a mesh no step reads back to the host
and no shape depends on the routing, so a decode step that routes is
captured as one CUDA graph.  On a (data, model) mesh (expert
parallelism, eager) each rank computes its own experts over the rows
the data shards send it, reading the routing's counts on the host so
that only kept rows cross between ranks.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core.integer_ops import LinearQuantSpec
from repro_torch.core.qmodel import ModuleBits, QuantContext, QuantMode
from repro_torch.core.qscheme import fake_quant
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.collectives import (copy_to_model,
                                                 gather_rows_from_model)
from repro_torch.kernels import ops as kops
from repro_torch.models import common
from repro_torch.models.common import linear

__all__ = ["init_mlp", "mlp", "init_moe", "moe", "moe_capacity", "route",
           "rank_pairs"]


class _RoundedOnce(torch.autograd.Function):
    """An activation ``f`` evaluated in float64 and rounded once to x's
    dtype, differentiated from the saved x alone: the backward evaluates
    ``f'(x) * g`` in float64 and rounds once.  Autograd through the
    float64 expression would keep several float64 copies of the
    activation for the backward (whisper's 32 encoder MLPs at batch 4 over
    1500 frames ran the card out of memory so)."""

    @staticmethod
    def forward(ctx, x, f, df):
        ctx.df = df
        ctx.save_for_backward(x)
        return f(x.to(torch.float64)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        x64 = x.to(torch.float64)
        return (g.to(torch.float64) * ctx.df(x64)).to(x.dtype), None, None


def _silu64(x64: torch.Tensor) -> torch.Tensor:
    return x64 * torch.sigmoid(x64)


def _dsilu64(x64: torch.Tensor) -> torch.Tensor:
    s = torch.sigmoid(x64)
    return s * (1.0 + x64 * (1.0 - s))


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` evaluated in float64 and rounded once to x's
    dtype, so every device rounds to the same value (its gradient too)."""
    return _RoundedOnce.apply(x, _silu64, _dsilu64)


_GELU_C = math.sqrt(2.0 / math.pi)


def _gelu64(x64: torch.Tensor) -> torch.Tensor:
    inner = _GELU_C * (x64 + 0.044715 * x64 * x64 * x64)
    return 0.5 * x64 * (1.0 + torch.tanh(inner))


def _dgelu64(x64: torch.Tensor) -> torch.Tensor:
    t = torch.tanh(_GELU_C * (x64 + 0.044715 * x64 * x64 * x64))
    return 0.5 * (1.0 + t) + 0.5 * x64 * (1.0 - t * t) * _GELU_C * (
        1.0 + 3 * 0.044715 * x64 * x64)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation ``0.5 x (1 + tanh(sqrt(2 / pi) (x + 0.044715
    x^3)))`` (``jax.nn.gelu``'s default) evaluated in float64 and rounded
    once to x's dtype, as :func:`_silu`."""
    return _RoundedOnce.apply(x, _gelu64, _dgelu64)


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return _silu(x)
    if kind == "gelu":
        return _gelu(x)
    raise NotImplementedError(f"activation {kind!r} is not ported yet")


def init_mlp(init, d_model: int, d_ff: int, act: str = "silu") -> dict:
    p = {"w1": init.dense((d_model, d_ff)),
         "w2": init.dense((d_ff, d_model), fan_in=d_ff)}
    if act in ("silu",):  # gated
        p["w3"] = init.dense((d_model, d_ff))
    return p


def mlp(ctx: QuantContext, p: dict, x: torch.Tensor, act: str = "silu",
        name: str = "mlp") -> torch.Tensor:
    if "w3" in p:
        # w1 and w3 read x: one quant point for both (qlinears)
        g, u = common.linears(ctx, [f"{name}/w1", f"{name}/w3"], x,
                              [p["w1"], p["w3"]])
        h = _act(g, act) * u   # unified-module boundary: ONE quant point after product
    else:
        h = _act(linear(ctx, f"{name}/w1", x, p["w1"]), act)
    # w2 is row-cut on a mesh: its ranks' partial products are summed
    return linear(ctx, f"{name}/w2", h, p["w2"], reduce=True)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _expert_codes(ctx: QuantContext, mb: ModuleBits, a_int: torch.Tensor,
                  w: torch.Tensor, counts: Optional[torch.Tensor],
                  rows_cap: Optional[int], out_dtype: Optional[torch.dtype]
                  ) -> torch.Tensor:
    """The integer branch on input codes: (E, C, d) int8 x the (E, d, f)
    weight stack (int8 codes pass through; float weights quantized on
    ``mb.n_w``) -> int32 -> ``shift_requant((n_x + n_w) - n_o)`` ->
    ``dequant(n_o)`` in ``out_dtype``: one launch of K2's grouped form
    over the rows ``counts`` names ((E,), or an (E, D) grid of segments;
    all C without ``counts``).  ``out_dtype`` None: the int32 sums alone
    (K2's int32 output kind), for a hidden cut over ``data`` whose ranks'
    sums are added before :func:`_finish` runs the epilogue once."""
    w_int = w if w.dtype == torch.int8 else kops.quantize_act(
        w, mb.n_w, ctx.bits)
    if counts is None:
        counts = torch.full((a_int.shape[0],), a_int.shape[1],
                            dtype=torch.int32, device=a_int.device)
    if out_dtype is None:
        return kops.int8_matmul_grouped_partial(a_int, w_int, counts,
                                                rows_cap=rows_cap)
    spec = LinearQuantSpec(n_x=mb.n_x, n_w=mb.n_w, n_b=mb.n_w, n_o=mb.n_o,
                           bits=ctx.bits)
    return kops.int8_matmul_grouped(a_int, w_int, counts, spec,
                                    rows_cap=rows_cap, out_float=out_dtype)


def _qexpert(ctx: QuantContext, name: str, a: torch.Tensor, w: torch.Tensor,
             counts: Optional[torch.Tensor] = None,
             rows_cap: Optional[int] = None, *,
             partial: bool = False) -> torch.Tensor:
    """Quantized batched expert matmul (E, C, d) x (E, d, f) -> (E, C, f).

    FP: a batched product in the activation dtype.  FAKE: Eq. 1 in float
    on both operands.  Every other mode (INT, and FAKE_SF, which falls
    through to it in the reference too) is the integer branch
    (:func:`_expert_codes` on ``quant(a, n_x)``).  The grid is
    ``ctx.bits_for(name)``; calibration never captures the experts, so it
    is the default one.  With ``counts`` the integer branch computes
    the rows it names only (the others are 0 on the CPU and left
    unwritten on the card).  ``partial``: ``a`` and ``w`` hold this
    rank's slice of the contracted dim (the hidden cut over ``data``):
    the float modes' products in fp32, the integer branch's int32 sums,
    neither rounded (:func:`_finish`, after the ranks' sums)."""
    if w.dtype == torch.int8 and ctx.mode in (QuantMode.FP, QuantMode.FAKE):
        raise ValueError(
            f"module {name!r}: int8 expert codes reached the "
            f"{ctx.mode.value!r} path")
    f32 = torch.float32
    if ctx.mode is QuantMode.FP:
        if partial:
            return torch.bmm(a.to(f32), w.to(f32))
        return torch.bmm(a, w.to(a.dtype))
    mb = ctx.bits_for(name)
    if ctx.mode is QuantMode.FAKE:
        aq = fake_quant(a, mb.n_x, ctx.bits)
        wq = fake_quant(w, mb.n_w, ctx.bits).to(a.dtype)
        if partial:
            return torch.bmm(aq.to(f32), wq.to(f32))
        return torch.bmm(aq, wq)
    (a_int,) = kops.quantize_multi(a, [mb.n_x], ctx.bits)
    return _expert_codes(ctx, mb, a_int, w, counts, rows_cap,
                         None if partial else a.dtype)


def _finish(ctx: QuantContext, name: str, acc: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """A partial :func:`_qexpert`'s rows once the ranks' sums are added:
    the integer branch's int32 sums through K2's epilogue (its rank-split
    finish: the output one rank's bit for bit), the float modes' fp32
    sums rounded once to ``dtype``."""
    if acc.dtype != torch.int32:
        return acc.to(dtype)
    mb = ctx.bits_for(name)
    spec = LinearQuantSpec(n_x=mb.n_x, n_w=mb.n_w, n_b=mb.n_w, n_o=mb.n_o,
                           bits=ctx.bits)
    return kops.int8_matmul_finish(acc, None, spec, out_float=dtype)


def moe_capacity(n_tokens: int, mcfg: MoEConfig) -> int:
    """Per-expert capacity C = ceil(T * top_k / E * cf), padded to 128."""
    c = int(n_tokens * mcfg.top_k / mcfg.n_experts * mcfg.capacity_factor)
    return max(128, -(-c // 128) * 128)


def init_moe(init, cfg: ModelConfig) -> dict:
    m = cfg.moe
    d, de = cfg.d_model, m.d_expert
    e = m.e_padded  # stacks padded; the router covers the real experts only
    p = {
        "router": init.dense((d, m.n_experts)).to(torch.float32),
        # stacked expert weights (E, d, de): ONE batched product
        "w1": init.dense_stack((e, d, de)),
        "w3": init.dense_stack((e, d, de)),
        "w2": init.dense_stack((e, de, d), fan_in=de),
    }
    if m.n_shared:
        p["shared"] = init_mlp(init, d, m.d_expert * m.n_shared, cfg.act)
    return p


def route(xt: torch.Tensor, router: torch.Tensor, top_k: int
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The router: fp32 logits ``xt @ router`` (T, E), softmax, top-k,
    renormalized.  Returns (top_p (T, k) fp32, top_e (T, k) int64).

    The logits (products summed in float64) and the softmax (exp and sum
    in float64) are each rounded once to fp32, so the CPU and the card
    route alike (the reference sums in fp32 in XLA's order, which neither
    device reproduces).  Top-k is a stable descending sort: equal
    probabilities give the lower expert first, as ``lax.top_k``.  The
    renormalization is fp32, its sum taken in k order."""
    logits = (xt.to(torch.float64) @ router.to(torch.float64)
              ).to(torch.float32).to(torch.float64)
    ex = torch.exp(logits - logits.max(dim=-1, keepdim=True).values)
    probs = (ex / ex.sum(dim=-1, keepdim=True)).to(torch.float32)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :top_k], top_e[:, :top_k]
    total = top_p[:, 0]
    for i in range(1, top_k):
        total = total + top_p[:, i]
    return top_p / total[:, None], top_e


def rank_pairs(flat_e: torch.Tensor, n_experts: int, cap: int
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each (token, k) pair's position in its expert, in (token, k)
    order: ``flat_e`` (T * k,) expert ids -> (rank (T * k,) int64, keep =
    rank < cap, counts (E,) int32: each expert's kept pairs).  ``flat_e``
    (D, T * k / D) ranks each data shard's pairs on their own (the
    reference's shard-local cumsum), counts (D, E)."""
    # one-hot by an explicit comparison: the same aten ops on every device
    # (``one_hot``'s CPU form checks the ids' range on the host first)
    one_hot = (flat_e[..., None] == torch.arange(
        n_experts, device=flat_e.device)).to(torch.int32)
    rank = torch.cumsum(one_hot, dim=-2).gather(
        -1, flat_e[..., None])[..., 0] - 1
    counts = torch.clamp(one_hot.sum(dim=-2), max=cap).to(torch.int32)
    return rank, rank < cap, counts


def _combine(rows: torch.Tensor, index: torch.Tensor, keep: torch.Tensor,
             top_p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The experts' outputs back to their tokens: pair i reads ``rows[
    index[i]]`` (``index`` any valid row where the pair dropped), ``where(
    keep, row, 0) * top_p`` in the rows' dtype, summed over k in fp32 in k
    order and rounded once to ``dtype``: (T, d)."""
    t, k = top_p.shape
    gathered = rows.index_select(0, index)
    weighted = (torch.where(keep[:, None], gathered, 0)
                * top_p.reshape(t * k, 1).to(gathered.dtype)
                ).reshape(t, k, -1)
    acc = weighted[:, 0].to(torch.float32)
    for i in range(1, k):
        acc = acc + weighted[:, i].to(torch.float32)
    return acc.to(dtype)


def _expert_ffn(ctx: QuantContext, p: dict, name: str, bufs: list,
                counts: Optional[torch.Tensor], rows_cap: int,
                dtype: torch.dtype, partial: bool = False) -> torch.Tensor:
    """The experts' SwiGLU over their (E, C, d) dispatch buffers ``bufs``
    (those of :func:`_token_rows`' rows: the token rows, or the codes on
    ``w1``'s and then ``w3``'s input grid, one buffer when they agree),
    ``counts`` the rows each expert (or segment) holds.  Returns (E, C,
    d): the output rows, or with ``partial`` (the hidden cut over
    ``data``) ``w2``'s unrounded sums over this rank's hidden
    (:func:`_qexpert`)."""
    if ctx.mode in (QuantMode.FP, QuantMode.FAKE):
        g = _silu(_qexpert(ctx, f"{name}/w1", bufs[0], p["w1"]))
        u = _qexpert(ctx, f"{name}/w3", bufs[0], p["w3"])
    else:
        b1, b3 = bufs[0], bufs[-1]
        mb1, mb3 = ctx.bits_for(f"{name}/w1"), ctx.bits_for(f"{name}/w3")
        g = _silu(_expert_codes(ctx, mb1, b1, p["w1"], counts, rows_cap,
                                dtype))
        u = _expert_codes(ctx, mb3, b3, p["w3"], counts, rows_cap, dtype)
    return _qexpert(ctx, f"{name}/w2", g * u, p["w2"], counts, rows_cap,
                    partial=partial)


def _token_rows(ctx: QuantContext, xt: torch.Tensor, name: str) -> list:
    """What the dispatch moves: the token rows (FP, FAKE), or in the
    integer branch their codes on ``w1``'s and ``w3``'s input grids,
    quantized once (one K3 launch; one buffer when the grids agree)."""
    if ctx.mode in (QuantMode.FP, QuantMode.FAKE):
        return [xt]
    mb1, mb3 = ctx.bits_for(f"{name}/w1"), ctx.bits_for(f"{name}/w3")
    c1, c3 = kops.quantize_multi(xt, [mb1.n_x, mb3.n_x], ctx.bits)
    return [c1] if mb3.n_x == mb1.n_x else [c1, c3]


def moe(ctx: QuantContext, p: dict, x: torch.Tensor, cfg: ModelConfig,
        name: str = "moe", *, data_shards: Optional[int] = None
        ) -> torch.Tensor:
    """Token-choice top-k MoE over a (B, S, d) activation, dispatched per
    data shard as the reference's (``repro/models/mlp.py::moe``): the T
    tokens' (token, k) pairs are cut into ``D`` shards of consecutive
    tokens (the batch's data blocks), each ranked on its own against its
    slice of every expert's capacity, ``cap_l = ceil(moe_capacity(T) /
    D)``, and expert e's rows laid out as the reference's exchange buffer
    (E, D * cap_l), shard s's kept rows at ``[s cap_l, s cap_l +
    count)``.  ``D`` is ``data_shards`` (default 1) in one process; on a
    mesh of more than one rank in scope (``distributed.sharding.
    activation_sharding``) the mesh's data axis, which cuts the batch, and
    each rank computes its experts (:func:`_moe_mesh`).

    The kept pairs' rows are copied into a zero (E * D * cap_l + 1, d)
    buffer (dropped pairs onto its last row, which nothing reads): each
    kept slot receives exactly one row, as the reference's add onto zeros
    gives.  In INT mode (and FAKE_SF) the token rows are quantized once
    (K3, one launch for the grids of ``w1`` and ``w3``) and their codes
    scattered, the codes ``quant`` of the buffer would give (a slot holds
    a token row or zeros); the experts' products are K2's grouped form
    over each shard's kept rows (``rows_cap = min(cap_l, T / D)``: a token
    picks an expert once; an (E, D) count grid when D > 1).  The combine
    is ``where(keep, gathered, 0) * top_p`` in the activation dtype,
    summed over k in fp32 in k order and rounded once.  With D = 1 it is
    the one-shard function, bit for bit."""
    mesh = shd.current_mesh()
    if mesh is not None and mesh.size > 1:
        if data_shards is not None:
            raise ValueError("data_shards is the one-process form; on a "
                             "mesh the data axis shards the batch")
        return _moe_mesh(ctx, p, x, cfg, name, mesh)
    m = cfg.moe
    ds = 1 if data_shards is None else int(data_shards)
    b, s, d = x.shape
    t, k, e_pad = b * s, m.top_k, m.e_padded
    if ds < 1 or t % ds:
        raise ValueError(f"{ds} data shards do not cut the {t} tokens")
    tl = t // ds
    xt = x.reshape(t, d)
    cap_l = -(-moe_capacity(t, m) // ds)
    cap = cap_l * ds
    rows_cap = min(cap_l, tl)
    dev = x.device

    top_p, top_e = route(xt, p["router"], k)
    flat_e = top_e.reshape(ds, tl * k)
    rank, keep, counts = rank_pairs(flat_e, e_pad, cap_l)
    shard = torch.arange(ds, device=dev)[:, None] * cap_l
    slot = torch.where(keep, flat_e * cap + shard + rank,
                       e_pad * cap).reshape(t * k)
    tok = torch.arange(t * k, device=dev) // k

    def dispatch(rows: torch.Tensor) -> torch.Tensor:
        buf = rows.new_zeros((e_pad * cap + 1, d))
        buf.index_copy_(0, slot, rows.index_select(0, tok))
        return buf[:-1].view(e_pad, cap, d)

    grid = counts.T.contiguous() if ds > 1 else counts[0]
    bufs = [dispatch(r) for r in _token_rows(ctx, xt, name)]
    out_buf = _expert_ffn(ctx, p, name, bufs, grid,
                          rows_cap, x.dtype)
    safe = torch.where(keep, flat_e * cap + shard + rank,
                       flat_e * cap + shard + cap_l - 1).reshape(t * k)
    out = _combine(out_buf.reshape(e_pad * cap, d), safe,
                   keep.reshape(t * k), top_p, x.dtype)
    if m.n_shared:
        out = out + mlp(ctx, p["shared"], xt, cfg.act, name=f"{name}/shared")
    return out.reshape(b, s, d)


def _moe_mesh(ctx: QuantContext, p: dict, x: torch.Tensor, cfg: ModelConfig,
              name: str, mesh) -> torch.Tensor:
    """:func:`moe` on one rank of a (data, model) mesh (expert
    parallelism): ``x`` is this rank's data shard of the batch, ``p`` its
    slices (``distributed.sharding``'s serving rules): the router whole,
    the E / M experts of its model column, each one's hidden cut over
    ``data`` where serving's 2-D rule cuts it, the shared expert column-
    and row-cut over ``model``.

    The shard ranks its own pairs (the reference's shard-local ranking,
    with the WHOLE batch's capacity).  Its kept rows of its column's
    experts are packed (expert, rank) order; where the hidden is cut every
    data rank of the column gathers every shard's packed rows (only kept
    rows cross, never the zero buffer), lays them out as the reference's
    (E / M, D * cap_l) exchange buffer and computes its hidden's part of
    ``w2``, whose sums (INT: K2's int32 kind; the float modes: fp32) are
    added over ``data`` and finished once, so INT is one rank's bit for
    bit.  Each kept pair's output row then goes back over ``model`` to
    its token's rank (the column's rows of this shard, gathered in expert
    order), which combines in k order as one rank does: no float sum over
    ``model``.  Reads the counts on the host (a mesh runs eagerly); on
    the meta device, where there are none, takes the reference's static
    sizes (every expert's count ``cap_l``: each shard sends its whole
    buffer, as the reference's fixed-shape exchange does).

    In training (``sharding.local_config(train=True)``: each expert's
    hidden whole, so nothing crosses ``data``) the gather's backward keeps
    the column's rows of the gradient, and the token rows' gradient is
    summed over ``model``; the router and ``top_p``, which read the whole
    shard on every rank, take every rank's whole gradient.  The shared
    expert is a column-cut, then row-cut MLP."""
    m = cfg.moe             # the rank's view (``sharding.local_config``)
    ds = shd.batch_shards()
    if shd.data_shards(mesh) > 1 and ds == 1:
        raise NotImplementedError(
            "the moe family on a data axis that does not cut the batch (a "
            "batch the data axis does not divide, or the engine's replicas) "
            "is ROADMAP Queue 1 item 8's")
    b, s, d = x.shape
    tl, k, e_pad = b * s, m.top_k, m.e_padded
    dev = x.device
    el = m.e_local
    if tuple(p["w1"].shape) != (el, d, m.d_expert_local):
        raise ValueError(f"expert stack {tuple(p['w1'].shape)} is not the "
                         f"rank's ({el}, {d}, {m.d_expert_local}): cut "
                         f"the weights by distributed.sharding.shard_params")
    lo = mesh.coords["model"] * el
    cut = m.hidden_shards > 1
    cap_l = -(-moe_capacity(tl * ds, m) // ds)
    rows_cap = min(cap_l, tl)

    xt = x.reshape(tl, d)
    top_p, top_e = route(xt, p["router"], k)
    flat_e = top_e.reshape(tl * k)
    rank, keep, counts = rank_pairs(flat_e, e_pad, cap_l)
    # on meta (a traced step: no counts to read) the reference's static
    # sizes: every expert full, each shard sending its whole cap_l rows
    static = dev.type == "meta"
    counts_h = (torch.full((e_pad,), cap_l, dtype=torch.int32) if static
                else counts.cpu())
    if cut:       # every shard's counts of the column's experts
        grid_h = mesh.all_gather(counts[lo:lo + el][None], "data", 0)
        grid_h = (counts_h[lo:lo + el][None].expand(grid_h.shape[0], el)
                  if static else grid_h.cpu())
    else:
        grid_h = counts_h[lo:lo + el][None]
    segs = grid_h.shape[0]
    n_of = grid_h.sum(dim=1).tolist()               # rows a shard sends
    me = mesh.coords["data"] if cut else 0
    n_mine = n_of[me]

    # this shard's kept rows of the column's experts, (expert, rank) order
    mine = counts[lo:lo + el].to(torch.int64)
    off = torch.cumsum(mine, 0) - mine
    in_col = keep & (flat_e >= lo) & (flat_e < lo + el)
    pos = torch.where(in_col, off[torch.clamp(flat_e - lo, 0, el - 1)]
                      + rank, n_mine)
    tok = torch.arange(tl * k, device=dev) // k

    # each shard's rows' slots in the (E / M, segs * cap_l) layout
    idx = []
    for sh in range(segs):
        e_ids = torch.repeat_interleave(torch.arange(el), grid_h[sh])
        starts = torch.cumsum(grid_h[sh], 0) - grid_h[sh]
        r = torch.arange(int(n_of[sh])) - starts[e_ids]
        idx.append(e_ids * (segs * cap_l) + sh * cap_l + r)
    idx = torch.cat(idx).to(dev)

    def exchange(rows: torch.Tensor) -> torch.Tensor:
        packed = rows.new_zeros((n_mine + 1, d))
        packed.index_copy_(0, pos, rows.index_select(0, tok))
        packed = packed[:-1]
        if cut:
            packed = torch.cat(mesh.all_gather_rows(packed, "data", n_of))
        buf = rows.new_zeros((el * segs * cap_l, d))
        buf.index_copy_(0, idx, packed)
        return buf.view(el, segs * cap_l, d)

    # the rows the column's experts read: in training the tokens'
    # gradient, each column's experts' part, is summed over model
    bufs = [exchange(r) for r in _token_rows(ctx, copy_to_model(xt, mesh),
                                             name)]
    grid = grid_h.T.contiguous().to(dev)            # (E / M, segs) int32
    out_buf = _expert_ffn(ctx, p, name, bufs,
                          grid if segs > 1 else grid[:, 0], rows_cap,
                          x.dtype, partial=cut)
    rows = out_buf.reshape(-1, d).index_select(0, idx)
    if cut:       # the hidden's parts summed over data, finished once
        if rows.shape[0]:       # every data rank of the column knows
            rows = mesh.all_reduce(rows, "data")
        rows = _finish(ctx, f"{name}/w2", rows, x.dtype)
        start = sum(n_of[:me])
        rows = rows[start:start + n_mine]
    # every column's rows of this shard, in expert order
    sizes = [int(counts_h[c * el:(c + 1) * el].sum())
             for c in range(mesh.shape["model"])]
    rows = gather_rows_from_model(rows, mesh, sizes)
    off_all = torch.cumsum(counts.to(torch.int64), 0) - counts
    index = torch.where(keep, off_all[flat_e] + rank, 0)
    out = _combine(rows, index, keep, top_p, x.dtype)
    if m.n_shared:
        out = out + mlp(ctx, p["shared"], xt, cfg.act, name=f"{name}/shared")
    return out.reshape(b, s, d)
