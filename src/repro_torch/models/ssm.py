"""Mamba2 (SSD) block (PyTorch counterpart of ``repro.models.ssm``), the
recurrent layer of zamba2-2.7b's hybrid stack.

The prefill and the serving step run the chunked state-space-duality
form: a masked quadratic within each chunk and the (H, P, N) state
carried across chunks by a plain loop (where the reference scans); the
classic decode step is the O(1) recurrence (``mamba2_decode``).  The in/out
projections go through ``qlinear``; the recurrence stays fp32 (a
power-of-two rounded decay applied every step diverges).  Its products
are fp32 matmuls and must not run in TF32 or bf16 (the port keeps
PyTorch's default, ``allow_tf32 = False``).

On a (data, model) mesh ``w_in`` is cut on its contract dim over a
whole input (``qlinear``'s ``split_input``: the packed z / xBC / dt
output whole on every rank) and ``w_out``'s columns are gathered, so the
conv, the scan and the state are whole on every rank, as one rank's.  In
training both projections' input gradients are summed over the model
axis, so ``a_log``, ``d_skip``, ``dt_bias``, ``conv_w`` / ``conv_b`` and
the gated norm take every rank's whole gradient, which is not summed.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.core.qmodel import QuantContext
from repro_torch.models.common import linear, rmsnorm
from repro_torch.models.mlp import _silu

__all__ = ["SSMState", "zero_state", "init_mamba2", "mamba2",
           "mamba2_decode"]


class SSMState(NamedTuple):
    conv: torch.Tensor    # (B, d_conv - 1, d_conv_in) rolling conv window
    ssm: torch.Tensor     # (B, H, P, N) recurrent state, fp32


def _dims(cfg: ModelConfig):
    s: SSMConfig = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    d_conv_in = d_inner + 2 * s.n_groups * s.d_state
    return s, d_inner, n_heads, d_conv_in


def zero_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
               device=None) -> SSMState:
    s, d_inner, n_heads, d_conv_in = _dims(cfg)
    return SSMState(
        conv=torch.zeros((batch, s.d_conv - 1, d_conv_in), dtype=dtype,
                         device=device),
        ssm=torch.zeros((batch, n_heads, s.head_dim, s.d_state),
                        dtype=torch.float32, device=device))


def init_mamba2(init, cfg: ModelConfig) -> dict:
    s, d_inner, n_heads, d_conv_in = _dims(cfg)
    d = cfg.d_model
    dev = init.device
    return {
        # z (gate), xBC (conv path), dt: one fused in-projection
        "w_in": init.dense((d, d_inner + d_conv_in + n_heads)),
        "conv_w": init.dense((s.d_conv, d_conv_in), fan_in=s.d_conv),
        "conv_b": init.zeros((d_conv_in,)),
        "a_log": torch.log(torch.linspace(1.0, 16.0, n_heads,
                                          dtype=torch.float32, device=dev)),
        "dt_bias": torch.zeros((n_heads,), dtype=torch.float32, device=dev),
        "d_skip": torch.ones((n_heads,), dtype=torch.float32, device=dev),
        "norm": init.ones((d_inner,)),
        "w_out": init.dense((d_inner, d), fan_in=d_inner),
    }


def _split_in(cfg: ModelConfig, zxbcdt: torch.Tensor):
    s, d_inner, n_heads, d_conv_in = _dims(cfg)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + d_conv_in]
    dt = zxbcdt[..., d_inner + d_conv_in:]
    return z, xbc, dt


def _causal_conv_train(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv over the sequence: xbc (B, S, C), w (K, C).

    ``prev`` is the (B, K-1, C) pre-conv window carried from the previous
    chunk (``SSMState.conv``); a zero window is the classic left zero
    padding, so a fresh sequence is unchanged and a chunked prefill
    continues the conv stream without a seam."""
    k = w.shape[0]
    if prev is None:
        pad = torch.nn.functional.pad(xbc, (0, 0, k - 1, 0))
    else:
        pad = torch.cat([prev.to(xbc.dtype), xbc], dim=1)
    w = w.to(xbc.dtype)
    out = torch.zeros_like(xbc)
    for i in range(k):  # K = 4: unrolled adds, as the reference
        out = out + pad[:, i:i + xbc.shape[1], :] * w[i]
    return out + b.to(xbc.dtype)


def _ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 bmat: torch.Tensor, cmat: torch.Tensor, chunk: int,
                 init_state: Optional[torch.Tensor]
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan, fp32.

    x: (B, S, H, P) values; dt: (B, S, H) >= 0; a: (H,) = -exp(a_log);
    bmat / cmat: (B, S, G, N), the G groups broadcast over H.  Returns y
    (B, S, H, P) and the final state (B, H, P, N).  A token with dt = 0
    neither contributes to nor decays the state."""
    b, s, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    pad = (-s) % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        bmat = torch.nn.functional.pad(bmat, (0, 0, 0, 0, 0, pad))
        cmat = torch.nn.functional.pad(cmat, (0, 0, 0, 0, 0, pad))
    s_pad = s + pad
    nc = s_pad // chunk
    rep = h // g

    la = dt * a[None, None, :]                              # (B,S,H) <= 0
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    lac = la.reshape(b, nc, chunk, h)
    # each group's B / C broadcast over its rep heads (an expand: no host
    # sync, so the step stays capturable)
    bc, cc = (m.reshape(b, nc, chunk, g, 1, n).expand(
        b, nc, chunk, g, rep, n).reshape(b, nc, chunk, h, n)
        for m in (bmat, cmat))

    cum = torch.cumsum(lac, dim=2)                          # (B,NC,L,H)
    total = cum[:, :, -1]                                   # (B,NC,H)

    # intra-chunk: w_{t,s} = (C_t . B_s) exp(cum_t - cum_s) dt_s, s <= t
    cb = torch.einsum("bnthm,bnshm->bnhts", cc, bc)         # (B,NC,H,L,L)
    decay = (cum[..., :, None, :] - cum[..., None, :, :]).permute(
        0, 1, 4, 2, 3)                                      # (B,NC,H,L,L)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))
    w_ts = torch.exp(torch.where(
        causal, decay, torch.full((), -math.inf, device=x.device))) * cb
    w_ts = w_ts * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_intra = torch.einsum("bnhts,bnshp->bnthp", w_ts, xc)

    # chunk-boundary states: sum_s exp(total - cum_s) dt_s x_s B_s^T
    w_s = torch.exp(total[:, :, None, :] - cum) * dtc       # (B,NC,L,H)
    st = torch.einsum("bnsh,bnshp,bnshm->bnhpm", w_s, xc, bc)

    prev = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
            if init_state is None else init_state.to(torch.float32))
    prevs = []
    for k in range(nc):                 # the state BEFORE each chunk
        prevs.append(prev)
        prev = torch.exp(total[:, k])[:, :, None, None] * prev + st[:, k]
    prevs = torch.stack(prevs, dim=1)                       # (B,NC,H,P,N)

    # inter-chunk: y_t += C_t exp(cum_t) S_prev
    y_inter = torch.einsum("bnthm,bnhpm->bnthp",
                           cc * torch.exp(cum)[..., None], prevs)
    y = (y_intra + y_inter).reshape(b, s_pad, h, p)
    return y[:, :s], prev


def mamba2(ctx: QuantContext, p: dict, x: torch.Tensor, cfg: ModelConfig,
           name: str = "ssm", init_state: Optional[SSMState] = None,
           valid: Optional[torch.Tensor] = None
           ) -> tuple[torch.Tensor, SSMState]:
    """Full-sequence Mamba2 forward; returns (output, final state).

    ``init_state`` continues a streamed sequence: its ``ssm`` seeds the
    SSD scan and its ``conv`` window the causal conv.  ``valid`` (B, S)
    bool masks the trailing padding of the batched serving step: a masked
    position's dt is zeroed (inert in the recurrence), and the returned
    conv window is gathered at each row's own valid length (a row with no
    valid token returns its window unchanged)."""
    s, d_inner, n_heads, d_conv_in = _dims(cfg)
    b, seq, d = x.shape
    zxbcdt = linear(ctx, f"{name}/w_in", x, p["w_in"], reduce=True,
                    split_input=True)
    z, xbc_raw, dt = _split_in(cfg, zxbcdt)
    prev = init_state.conv if init_state is not None else None
    xbc = _silu(_causal_conv_train(xbc_raw, p["conv_w"], p["conv_b"],
                                   prev=prev))
    gn = s.n_groups * s.d_state
    xs = xbc[..., :d_inner]
    bmat = xbc[..., d_inner:d_inner + gn].reshape(
        b, seq, s.n_groups, s.d_state).to(torch.float32)
    cmat = xbc[..., d_inner + gn:].reshape(
        b, seq, s.n_groups, s.d_state).to(torch.float32)
    dtp = torch.nn.functional.softplus(dt.to(torch.float32) + p["dt_bias"])
    if valid is not None:
        dtp = torch.where(valid[..., None], dtp, torch.zeros_like(dtp))
    a = -torch.exp(p["a_log"])
    xh = xs.reshape(b, seq, n_heads, s.head_dim).to(torch.float32)

    chunk = min(s.chunk, seq)
    y, final = _ssd_chunked(xh, dtp, a, bmat, cmat, chunk,
                            init_state.ssm if init_state else None)
    y = y + xh * p["d_skip"][None, None, :, None]
    y = y.reshape(b, seq, d_inner).to(x.dtype)
    y = rmsnorm(y * _silu(z), p["norm"], cfg.norm_eps)
    out = linear(ctx, f"{name}/w_out", y, p["w_out"], gather=True)
    # conv state = the last d_conv - 1 PRE-conv inputs
    if valid is None:
        conv_tail = xbc_raw[:, -(s.d_conv - 1):, :]
    else:
        win = (torch.cat([prev.to(xbc_raw.dtype), xbc_raw], dim=1)
               if prev is not None else
               torch.nn.functional.pad(xbc_raw, (0, 0, s.d_conv - 1, 0)))
        q_len = valid.to(torch.int64).sum(dim=1)            # (B,)
        idx = q_len[:, None] + torch.arange(s.d_conv - 1, device=x.device)
        conv_tail = torch.gather(
            win, 1, idx[..., None].expand(-1, -1, win.shape[-1]))
    return out, SSMState(conv=conv_tail, ssm=final)


def mamba2_decode(ctx: QuantContext, p: dict, x: torch.Tensor,
                  cfg: ModelConfig, state: SSMState, name: str = "ssm"
                  ) -> tuple[torch.Tensor, SSMState]:
    """Single-token step, x (B, 1, d), O(1) in sequence length: the conv
    over the rolling window ``[state.conv | xbc]`` (the new window drops
    its first row), each group's B / C repeated over its heads, the state
    decayed by ``exp(softplus(dt + dt_bias) * a)`` plus the token's
    update, the D skip and the gated rmsnorm.  Returns (output, new
    state)."""
    s, d_inner, n_heads, d_conv_in = _dims(cfg)
    b = x.shape[0]
    zxbcdt = linear(ctx, f"{name}/w_in", x, p["w_in"], reduce=True,
                    split_input=True)
    z, xbc, dt = _split_in(cfg, zxbcdt)

    window = torch.cat([state.conv, xbc], dim=1)           # (B, K, C)
    conv_out = torch.einsum("bkc,kc->bc", window,
                            p["conv_w"].to(window.dtype)) \
        + p["conv_b"].to(window.dtype)
    xbc_t = _silu(conv_out)[:, None, :]
    new_conv = window[:, 1:, :]

    gn = s.n_groups * s.d_state
    rep = n_heads // s.n_groups
    # each group's B / C over its rep heads (an expand, as in the scan)
    bmat, cmat = (m.reshape(b, s.n_groups, 1, s.d_state).to(torch.float32)
                  .expand(b, s.n_groups, rep, s.d_state)
                  .reshape(b, n_heads, s.d_state)
                  for m in (xbc_t[:, 0, d_inner:d_inner + gn],
                            xbc_t[:, 0, d_inner + gn:]))
    dtp = torch.nn.functional.softplus(dt[:, 0].to(torch.float32)
                                       + p["dt_bias"])       # (B, H)
    a = -torch.exp(p["a_log"])
    decay = torch.exp(dtp * a[None, :])                      # (B, H)
    xh = xbc_t[:, 0, :d_inner].reshape(b, n_heads, s.head_dim).to(
        torch.float32)

    upd = torch.einsum("bh,bhp,bhn->bhpn", dtp, xh, bmat)
    new_ssm = decay[:, :, None, None] * state.ssm.to(torch.float32) + upd
    y = torch.einsum("bhn,bhpn->bhp", cmat, new_ssm)
    y = y + xh * p["d_skip"][None, :, None]
    y = y.reshape(b, 1, d_inner).to(x.dtype)
    y = rmsnorm(y * _silu(z), p["norm"], cfg.norm_eps)
    out = linear(ctx, f"{name}/w_out", y, p["w_out"], gather=True)
    return out, SSMState(conv=new_conv, ssm=new_ssm)
