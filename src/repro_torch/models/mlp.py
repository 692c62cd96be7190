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
No step reads back to the host and no shape depends on the routing, so
a decode step that routes is captured as one CUDA graph.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core.integer_ops import LinearQuantSpec
from repro_torch.core.qmodel import ModuleBits, QuantContext, QuantMode
from repro_torch.core.qscheme import fake_quant
from repro_torch.kernels import ops as kops
from repro_torch.models import common
from repro_torch.models.common import linear

__all__ = ["init_mlp", "mlp", "init_moe", "moe", "moe_capacity", "route",
           "rank_pairs"]


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` evaluated in float64 and rounded once to x's
    dtype, so every device rounds to the same value."""
    x64 = x.to(torch.float64)
    return (x64 * torch.sigmoid(x64)).to(x.dtype)


_GELU_C = math.sqrt(2.0 / math.pi)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation ``0.5 x (1 + tanh(sqrt(2 / pi) (x + 0.044715
    x^3)))`` (``jax.nn.gelu``'s default) evaluated in float64 and rounded
    once to x's dtype, as :func:`_silu`."""
    x64 = x.to(torch.float64)
    inner = _GELU_C * (x64 + 0.044715 * x64 * x64 * x64)
    return (0.5 * x64 * (1.0 + torch.tanh(inner))).to(x.dtype)


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
                  rows_cap: Optional[int], out_dtype: torch.dtype
                  ) -> torch.Tensor:
    """The integer branch on input codes: (E, C, d) int8 x the (E, d, f)
    weight stack (int8 codes pass through; float weights quantized on
    ``mb.n_w``) -> int32 -> ``shift_requant((n_x + n_w) - n_o)`` ->
    ``dequant(n_o)`` in ``out_dtype``: one launch of K2's grouped form,
    expert e's first ``counts[e]`` rows (all C without ``counts``)."""
    w_int = w if w.dtype == torch.int8 else kops.quantize_act(
        w, mb.n_w, ctx.bits)
    if counts is None:
        counts = torch.full((a_int.shape[0],), a_int.shape[1],
                            dtype=torch.int32, device=a_int.device)
    spec = LinearQuantSpec(n_x=mb.n_x, n_w=mb.n_w, n_b=mb.n_w, n_o=mb.n_o,
                           bits=ctx.bits)
    return kops.int8_matmul_grouped(a_int, w_int, counts, spec,
                                    rows_cap=rows_cap, out_float=out_dtype)


def _qexpert(ctx: QuantContext, name: str, a: torch.Tensor, w: torch.Tensor,
             counts: Optional[torch.Tensor] = None,
             rows_cap: Optional[int] = None) -> torch.Tensor:
    """Quantized batched expert matmul (E, C, d) x (E, d, f) -> (E, C, f).

    FP: a batched product in the activation dtype.  FAKE: Eq. 1 in float
    on both operands.  Every other mode (INT, and FAKE_SF, which falls
    through to it in the reference too) is the integer branch
    (:func:`_expert_codes` on ``quant(a, n_x)``).  The grid is
    ``ctx.bits_for(name)``; calibration never captures the experts, so it
    is the default one.  With ``counts`` the integer branch computes
    expert e's first ``counts[e]`` rows only (the others are 0 on the
    CPU and left unwritten on the card)."""
    if w.dtype == torch.int8 and ctx.mode in (QuantMode.FP, QuantMode.FAKE):
        raise ValueError(
            f"module {name!r}: int8 expert codes reached the "
            f"{ctx.mode.value!r} path")
    if ctx.mode is QuantMode.FP:
        return torch.bmm(a, w.to(a.dtype))
    mb = ctx.bits_for(name)
    if ctx.mode is QuantMode.FAKE:
        return torch.bmm(fake_quant(a, mb.n_x, ctx.bits),
                         fake_quant(w, mb.n_w, ctx.bits).to(a.dtype))
    (a_int,) = kops.quantize_multi(a, [mb.n_x], ctx.bits)
    return _expert_codes(ctx, mb, a_int, w, counts, rows_cap, a.dtype)


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
    rank < cap, counts (E,) int32: each expert's kept pairs)."""
    one_hot = torch.nn.functional.one_hot(flat_e, n_experts).to(torch.int32)
    rank = torch.cumsum(one_hot, dim=0).gather(1, flat_e[:, None])[:, 0] - 1
    counts = torch.clamp(one_hot.sum(dim=0), max=cap).to(torch.int32)
    return rank, rank < cap, counts


def moe(ctx: QuantContext, p: dict, x: torch.Tensor, cfg: ModelConfig,
        name: str = "moe") -> torch.Tensor:
    """Token-choice top-k MoE over a (B, S, d) activation (one data
    shard, the reference's ``data_shards() == 1``).

    The kept pairs' rows are copied into a zero (E * C + 1, d) buffer
    (dropped pairs onto its last row, which nothing reads): each kept slot
    receives exactly one row, as the reference's add onto zeros gives.  In
    INT mode (and FAKE_SF) the token rows are quantized once (K3, one
    launch for the grids of ``w1`` and ``w3``) and their codes scattered,
    the codes ``quant`` of the (E, C, d) buffer would give (a slot holds a
    token row or zeros); the experts' products are K2's grouped form over
    each expert's kept rows (``rows_cap = min(C, T)``: a token picks an
    expert once).  The combine is ``where(keep, gathered, 0) * top_p`` in
    the activation dtype, summed over k in fp32 in k order and rounded
    once."""
    m = cfg.moe
    b, s, d = x.shape
    t, k, e_pad = b * s, m.top_k, m.e_padded
    xt = x.reshape(t, d)
    cap = moe_capacity(t, m)
    rows_cap = min(cap, t)
    dev = x.device

    top_p, top_e = route(xt, p["router"], k)
    flat_e = top_e.reshape(t * k)
    rank, keep, counts = rank_pairs(flat_e, e_pad, cap)
    slot = torch.where(keep, flat_e * cap + rank, e_pad * cap)
    tok = torch.arange(t * k, device=dev) // k

    def dispatch(rows: torch.Tensor) -> torch.Tensor:
        buf = rows.new_zeros((e_pad * cap + 1, d))
        buf.index_copy_(0, slot, rows.index_select(0, tok))
        return buf[:-1].view(e_pad, cap, d)

    if ctx.mode in (QuantMode.FP, QuantMode.FAKE):
        buf = dispatch(xt)
        g = _silu(_qexpert(ctx, f"{name}/w1", buf, p["w1"]))
        u = _qexpert(ctx, f"{name}/w3", buf, p["w3"])
    else:
        mb1, mb3 = ctx.bits_for(f"{name}/w1"), ctx.bits_for(f"{name}/w3")
        c1, c3 = kops.quantize_multi(xt, [mb1.n_x, mb3.n_x], ctx.bits)
        b1 = dispatch(c1)
        b3 = b1 if mb3.n_x == mb1.n_x else dispatch(c3)
        g = _silu(_expert_codes(ctx, mb1, b1, p["w1"], counts, rows_cap,
                                x.dtype))
        u = _expert_codes(ctx, mb3, b3, p["w3"], counts, rows_cap, x.dtype)
    out_buf = _qexpert(ctx, f"{name}/w2", g * u, p["w2"], counts, rows_cap)

    safe = torch.where(keep, rank, cap - 1)
    gathered = out_buf.reshape(e_pad * cap, d).index_select(
        0, flat_e * cap + safe)
    weighted = (torch.where(keep[:, None], gathered, 0)
                * top_p.reshape(t * k, 1).to(gathered.dtype)
                ).reshape(t, k, d)
    acc = weighted[:, 0].to(torch.float32)
    for i in range(1, k):
        acc = acc + weighted[:, i].to(torch.float32)
    out = acc.to(x.dtype)
    if m.n_shared:
        out = out + mlp(ctx, p["shared"], xt, cfg.act, name=f"{name}/shared")
    return out.reshape(b, s, d)
