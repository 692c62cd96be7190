"""RWKV6 "Finch" block (PyTorch counterpart of ``repro.models.rwkv``):
attention-free time-mix with data-dependent per-channel decay, and the
squared-ReLU channel-mix.

Recurrence per head (d_k = d_v = head_dim = 64):
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T          (S: (d_k, d_v))
    out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
with w_t = exp(-exp(w0 + lora_w(x_t))) in (0, 1) per channel.

The prefill and the serving step run the chunked linear-attention form
(a masked quadratic within each chunk, the state carried across chunks
by a plain loop where the reference scans); the classic decode step is
the O(1) recurrence (``rwkv6_decode``).  The r/k/v/g/o projections and both
channel-mix matmuls go through ``qlinear``; the decay and the recurrence
stay fp32 (a power-of-two rounded decay applied every step diverges).
Their products are fp32 matmuls: they must not run in TF32 or bf16 (the
port keeps PyTorch's default, ``torch.backends.cuda.matmul.allow_tf32 =
False``), since the chunked form multiplies by exponentials up to e^53.

On a (data, model) mesh the r/k/v/g/o projections are cut on their
contract dim over a whole input, each rank taking its block of it
(``_ROWS``: ``qlinear``'s ``split_input``), and give whole outputs, so
the heads, the scan, the ``ln_x`` statistic and the state are whole on
every rank, as one rank's; the channel mix cuts its hidden (``wk_ffn``
columns, ``wv_ffn`` rows) and gathers ``wr_ffn``'s columns.  In training
every projection's input gradient is summed over the model axis, so the
leaves that act on whole tensors (the token-shift mixes and their LoRA,
the decay, the bonus ``u``, ``ln_x``) take every rank's whole gradient,
which is not summed.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.qmodel import QuantContext
from repro_torch.models.common import linear, rmsnorm
from repro_torch.models.mlp import _silu

__all__ = ["RWKVState", "HEAD_DIM", "zero_state", "init_rwkv6",
           "rwkv6_block", "rwkv6_channel_mix", "rwkv6_decode"]

HEAD_DIM = 64  # rwkv6 fixed head size
# the time mix's projections: contract-cut over a whole input on a mesh
_ROWS = dict(reduce=True, split_input=True)


class RWKVState(NamedTuple):
    x_prev_att: torch.Tensor   # (B, 1, d) last token seen by time-mix
    x_prev_ffn: torch.Tensor   # (B, 1, d) last token seen by channel-mix
    wkv: torch.Tensor          # (B, H, dk, dv) recurrent state, fp32


def _heads(cfg: ModelConfig) -> int:
    return cfg.d_model // HEAD_DIM


def zero_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
               device=None) -> RWKVState:
    h = _heads(cfg)
    return RWKVState(
        x_prev_att=torch.zeros((batch, 1, cfg.d_model), dtype=dtype,
                               device=device),
        x_prev_ffn=torch.zeros((batch, 1, cfg.d_model), dtype=dtype,
                               device=device),
        wkv=torch.zeros((batch, h, HEAD_DIM, HEAD_DIM), dtype=torch.float32,
                        device=device))


def init_rwkv6(init, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    h = _heads(cfg)
    lora = 64
    return {
        # time-mix interpolation weights (token shift) for r, k, v, w, g
        "mu": init.zeros((5, d)) + 0.5,
        "lora_mix_a": init.dense((d, 5 * 32)),
        "lora_mix_b": init.dense((5, 32, d)),
        "wr": init.dense((d, d)),
        "wk": init.dense((d, d)),
        "wv": init.dense((d, d)),
        "wg": init.dense((d, d)),
        "wo": init.dense((d, d)),
        "w0": init.zeros((d,)) - 0.6,          # base decay logit
        "lora_w_a": init.dense((d, lora)),
        "lora_w_b": init.dense((lora, d)),
        "u": init.dense((h, HEAD_DIM)) * 0.1,  # first-token bonus
        "ln_x": init.ones((d,)),               # per-head group norm gain
        # channel mix
        "mu_ffn": init.zeros((2, d)) + 0.5,
        "wk_ffn": init.dense((d, int(cfg.d_ff))),
        "wv_ffn": init.dense((int(cfg.d_ff), d), fan_in=cfg.d_ff),
        "wr_ffn": init.dense((d, d)),
    }


def _token_shift(x: torch.Tensor,
                 x_prev: Optional[torch.Tensor]) -> torch.Tensor:
    """x_{t-1} stream: shift right by one, the first slot from the state
    (or zero)."""
    if x_prev is None:
        x_prev = torch.zeros_like(x[:, :1])
    return torch.cat([x_prev.to(x.dtype), x[:, :-1]], dim=1)


def _ddlerp(x, xp, mu, la, lb):
    """RWKV6 data-dependent interpolation of the 5 mix streams."""
    xx = xp - x
    base = x + xx * mu.to(x.dtype)[:, None, None]             # (5, B, S, d)
    inner = torch.tanh((x + xx * 0.5) @ la.to(x.dtype))       # (B, S, 5*32)
    b_, s_, _ = inner.shape
    inner = inner.reshape(b_, s_, 5, 32).permute(2, 0, 1, 3)
    corr = torch.einsum("nbsr,nrd->nbsd", inner, lb.to(x.dtype))
    return base + xx[None] * corr


def _wkv_chunked(r, k, v, w_log, u, chunk: int,
                 init_state: Optional[torch.Tensor]):
    """Chunked RWKV6 linear attention, fp32.

    r, k, v: (B, S, H, D); w_log: (B, S, H, D) = log decay (<= 0); u:
    (H, D).  Returns out (B, S, H, D) and the final state (B, H, D, D)
    [dk x dv].  Padded tokens (zero r/k/v, zero log-decay) contribute
    nothing and leave the carried state untouched."""
    b, s, h, d = r.shape
    pad = (-s) % chunk
    if pad:
        r, k, v, w_log = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                          for t in (r, k, v, w_log))
    s_pad = s + pad
    nc = s_pad // chunk
    rc = r.reshape(b, nc, chunk, h, d)
    kc = k.reshape(b, nc, chunk, h, d)
    vc = v.reshape(b, nc, chunk, h, d)
    wl = w_log.reshape(b, nc, chunk, h, d)
    # no clamping: the block bounds the per-token log-decay to
    # [-e^0.5, 0], so |cum| <= 1.65 * chunk and with chunk <= 32 every
    # exp() below stays finite in fp32 (e^53 << 3.4e38)
    cum = torch.cumsum(wl, dim=2)                           # (B,NC,L,H,D)
    total = cum[:, :, -1]                                   # (B,NC,H,D)

    # intra-chunk: score_{t,s} = sum_d r_td k_sd exp(cum_{t-1,d} - cum_{s,d})
    # for s < t; the diagonal takes the bonus u instead of a decay
    q_dec = torch.exp(cum - wl)                             # exp(cum_{t-1})
    k_dec = torch.exp(-cum)
    att = torch.einsum("bnthd,bnshd->bnhts", rc * q_dec, kc * k_dec)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=r.device), diagonal=-1)
    att = torch.where(causal, att, torch.zeros((), dtype=att.dtype,
                                               device=att.device))
    diag = torch.einsum("bnthd,bnthd->bnth", rc * u, kc)
    y_intra = torch.einsum("bnhts,bnshd->bnthd", att, vc) \
        + diag[..., None] * vc

    # cross-chunk state: S_next = diag(exp(total)) S
    #                             + sum_s exp(total - cum_s) k_s v_s^T
    k_carry = torch.exp(total[:, :, None] - cum) * kc
    st = torch.einsum("bnshk,bnshv->bnhkv", k_carry, vc)

    prev = (torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
            if init_state is None else init_state.to(torch.float32))
    prevs = []
    for n in range(nc):                 # the state BEFORE each chunk
        prevs.append(prev)
        prev = torch.exp(total[:, n])[..., None] * prev + st[:, n]
    prevs = torch.stack(prevs, dim=1)                       # (B,NC,H,Dk,Dv)

    y_inter = torch.einsum("bnthk,bnhkv->bnthv", rc * q_dec, prevs)
    y = (y_intra + y_inter).reshape(b, s_pad, h, d)
    return y[:, :s], prev


def rwkv6_block(ctx: QuantContext, p: dict, x: torch.Tensor,
                cfg: ModelConfig, state: Optional[RWKVState] = None,
                name: str = "rwkv", valid: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, None, RWKVState]:
    """Returns (time-mix output, None, new state); the caller applies the
    pre-norm and adds the residuals.

    ``valid`` (B, S) bool marks real tokens of a right-padded batch: an
    invalid position gets r/k/v = 0 (no contribution, no output) and
    log-decay 0 (decay 1, the carried state untouched), so a row with no
    valid token passes its wkv state through bit for bit."""
    b, s, d = x.shape
    h = _heads(cfg)
    chunk = min(cfg.ssm.chunk if cfg.ssm else 32, s)

    xp = _token_shift(x, state.x_prev_att if state else None)
    mixed = _ddlerp(x, xp, p["mu"], p["lora_mix_a"], p["lora_mix_b"])
    xr, xk, xv, xw, xg = (mixed[i] for i in range(5))

    r = linear(ctx, f"{name}/wr", xr, p["wr"], **_ROWS).reshape(
        b, s, h, HEAD_DIM)
    k = linear(ctx, f"{name}/wk", xk, p["wk"], **_ROWS).reshape(
        b, s, h, HEAD_DIM)
    v = linear(ctx, f"{name}/wv", xv, p["wv"], **_ROWS).reshape(
        b, s, h, HEAD_DIM)
    g = _silu(linear(ctx, f"{name}/wg", xg, p["wg"], **_ROWS))

    # data-dependent decay (fp32): w_log = -exp(w0 + lora_w(xw)), the logit
    # clipped to <= 0.5, so the per-token decay stays >= exp(-1.65)
    w_dd = xw @ p["lora_w_a"].to(x.dtype)
    w_dd = torch.tanh(w_dd) @ p["lora_w_b"].to(x.dtype)
    w_log = -torch.exp(torch.clamp(p["w0"].to(torch.float32)
                                   + w_dd.to(torch.float32), -8.0, 0.5))
    w_log = w_log.reshape(b, s, h, HEAD_DIM)

    if valid is not None:
        m = valid[:, :, None, None]
        r = torch.where(m, r, torch.zeros_like(r))
        k = torch.where(m, k, torch.zeros_like(k))
        v = torch.where(m, v, torch.zeros_like(v))
        w_log = torch.where(m, w_log, torch.zeros_like(w_log))

    out, wkv = _wkv_chunked(
        r.to(torch.float32), k.to(torch.float32), v.to(torch.float32),
        w_log, p["u"].to(torch.float32), chunk,
        state.wkv if state else None)
    out = out.reshape(b, s, d).to(x.dtype)
    out = rmsnorm(out, p["ln_x"], cfg.norm_eps) * g
    att_out = linear(ctx, f"{name}/wo", out, p["wo"], **_ROWS)
    new_state = RWKVState(x_prev_att=x[:, -1:], x_prev_ffn=x[:, -1:],
                          wkv=wkv)
    return att_out, None, new_state


def rwkv6_channel_mix(ctx: QuantContext, p: dict, x: torch.Tensor,
                      cfg: ModelConfig, x_prev: Optional[torch.Tensor] = None,
                      name: str = "rwkv_ffn") -> torch.Tensor:
    """Squared-ReLU channel mix: the ReLU precedes the quant point, so the
    code is unsigned (the paper's Fig. 1(b) fast path)."""
    xp = _token_shift(x, x_prev)
    mu = p["mu_ffn"].to(x.dtype)
    xk = x + (xp - x) * mu[0][None, None]
    xr = x + (xp - x) * mu[1][None, None]
    k = linear(ctx, f"{name}/wk", xk, p["wk_ffn"])
    k = torch.square(torch.relu(k))
    # on a mesh: k is the rank's d_ff columns, wv_ffn its rows (the
    # row-cut sum gives kv whole), and wr_ffn's columns are gathered
    kv = linear(ctx, f"{name}/wv", k, p["wv_ffn"], reduce=True)
    return torch.sigmoid(linear(ctx, f"{name}/wr", xr, p["wr_ffn"],
                                gather=True)) * kv


def rwkv6_decode(ctx: QuantContext, p: dict, x: torch.Tensor,
                 cfg: ModelConfig, state: RWKVState, name: str = "rwkv"
                 ) -> tuple[torch.Tensor, RWKVState]:
    """Single-token time-mix recurrence, O(1) in sequence length: x (B, 1,
    d) after ``state``.  r / k / v and the state in fp32; the bonus ``u``
    weighs the token's own k v^T in the output, and the new state is
    ``w * S + k v^T``.  Returns (time-mix output, new state); the new
    state's ``x_prev_ffn`` is the given one (the caller sets it)."""
    b, s, d = x.shape  # s == 1
    h = _heads(cfg)

    mixed = _ddlerp(x, state.x_prev_att, p["mu"], p["lora_mix_a"],
                    p["lora_mix_b"])
    xr, xk, xv, xw, xg = (mixed[i] for i in range(5))
    r = linear(ctx, f"{name}/wr", xr, p["wr"], **_ROWS).reshape(
        b, h, HEAD_DIM)
    k = linear(ctx, f"{name}/wk", xk, p["wk"], **_ROWS).reshape(
        b, h, HEAD_DIM)
    v = linear(ctx, f"{name}/wv", xv, p["wv"], **_ROWS).reshape(
        b, h, HEAD_DIM)
    g = _silu(linear(ctx, f"{name}/wg", xg, p["wg"], **_ROWS))

    w_dd = torch.tanh(xw @ p["lora_w_a"].to(x.dtype)) \
        @ p["lora_w_b"].to(x.dtype)
    w = torch.exp(-torch.exp(torch.clamp(
        p["w0"].to(torch.float32) + w_dd.to(torch.float32)[:, 0],
        -8.0, 0.5))).reshape(b, h, HEAD_DIM)

    rf, kf, vf = (t.to(torch.float32) for t in (r, k, v))
    s_prev = state.wkv.to(torch.float32)                    # (B,H,Dk,Dv)
    kv = torch.einsum("bhk,bhv->bhkv", kf, vf)
    out = torch.einsum("bhk,bhkv->bhv", rf, s_prev
                       + p["u"].to(torch.float32)[None, :, :, None] * kv)
    new_wkv = w[..., None] * s_prev + kv
    out = out.reshape(b, 1, d).to(x.dtype)
    out = rmsnorm(out, p["ln_x"], cfg.norm_eps) * g
    att_out = linear(ctx, f"{name}/wo", out, p["wo"], **_ROWS)
    return att_out, RWKVState(x_prev_att=x, x_prev_ffn=state.x_prev_ffn,
                              wkv=new_wkv)
