"""Analytical hardware-cost model — reproduces the paper's Table 5 comparison.

The paper synthesized RTL units (UMC 40nm, 500 MHz, 32-bit input / 8-bit
output) for the three requantization mechanisms.  No synthesis flow exists
offline, so we *seed* the model with the paper's measured constants and
combine them with quantization-op counts extracted from our graphs/HLO.
Energy per op = power / frequency (one requant per cycle, as in the paper's
throughput-normalized comparison).

Measured constants (paper Table 5):

    op type          power(mW)   area(um^2)
    scaling factor   30.6        502.7
    codebook         228.8       1787.6
    bit-shifting     15.5        198.2

Derived: bit-shift is ~2x cheaper than scaling factor, ~14.8x power /
~9.0x area cheaper than codebook — matching the abstract's ~15x / ~9x claim.

A copy of ``repro.core.hwcost`` (pure Python).  The op counters read only
config fields; a config without an ``ssm`` sub-config (the port's dense
``ModelConfig``) has no recurrent state to requantize.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

__all__ = [
    "QuantOpCost",
    "TABLE5",
    "CLOCK_HZ",
    "energy_per_op_pj",
    "energy_uj",
    "HardwareReport",
    "estimate",
    "memory_access_bytes",
    "forward_quant_ops_per_token",
]

CLOCK_HZ = 500e6  # paper's synthesis clock


@dataclasses.dataclass(frozen=True)
class QuantOpCost:
    name: str
    power_mw: float
    area_um2: float

    @property
    def energy_pj(self) -> float:
        """pJ per requantization op at the synthesis clock."""
        return self.power_mw * 1e-3 / CLOCK_HZ * 1e12


TABLE5: Mapping[str, QuantOpCost] = {
    "scaling_factor": QuantOpCost("scaling_factor", 30.6, 502.7),
    "codebook": QuantOpCost("codebook", 228.8, 1787.6),
    "bit_shifting": QuantOpCost("bit_shifting", 15.5, 198.2),
}


def energy_per_op_pj(kind: str) -> float:
    return TABLE5[kind].energy_pj


def energy_uj(kind: str, n_quant_ops: int) -> float:
    """Total requant energy in uJ for ``n_quant_ops`` ops of ``kind`` —
    the scalar the live obs gauges read at every snapshot (DESIGN §14),
    without building a full :class:`HardwareReport` per read."""
    return TABLE5[kind].energy_pj * n_quant_ops * 1e-6


@dataclasses.dataclass
class HardwareReport:
    kind: str
    n_quant_ops: int          # element-wise requantizations executed
    energy_uj: float          # total requant energy
    area_um2: float           # one requant unit's area (per-PE overhead)
    vs_bit_shift_energy: float

    def row(self) -> str:
        return (f"{self.kind},{self.n_quant_ops},{self.energy_uj:.3f},"
                f"{self.area_um2:.1f},{self.vs_bit_shift_energy:.2f}x")


def estimate(kind: str, n_quant_ops: int) -> HardwareReport:
    """Energy/area of executing ``n_quant_ops`` requantizations with a unit
    of the given kind."""
    c = TABLE5[kind]
    ref = TABLE5["bit_shifting"]
    return HardwareReport(
        kind=kind,
        n_quant_ops=n_quant_ops,
        energy_uj=energy_uj(kind, n_quant_ops),
        area_um2=c.area_um2,
        vs_bit_shift_energy=c.energy_pj / ref.energy_pj,
    )


def forward_quant_ops_per_token(cfg) -> int:
    """Per-token quantization ops of a W8A8 dense-transformer forward.

    Extends the Table-5 accounting from the KV path to the full forward
    (DESIGN §13).  Counts only the DYNAMIC per-token ops the requant unit
    executes at serve time: the Eq.-1 activation quantization at each
    unified-module input boundary plus the fused Eq.-5 bit-shift
    requantization of each module's int32 output.  Weight and bias codes
    are produced once at engine build (:func:`repro_torch.core.qmodel.quantize_params`)
    and amortize to zero per token; KV-cache quantization is counted
    separately by the engine's existing KV counters.

    Per layer (GQA dims): inputs to wq/wk/wv (3*d_model, the shared
    post-norm activation is quantized once per projection — each module
    has its own N_x grid), wo (n_heads*head_dim), w1/w3 (2*d_model) and
    w2 (d_ff); outputs of wq (n_heads*head_dim), wk/wv
    (2*n_kv_heads*head_dim), wo (d_model), w1/w3 (2*d_ff) and w2
    (d_model).  Plus the lm_head boundary: d_model in, vocab_padded out.
    """
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    q_dim = cfg.n_heads * hd
    kv_dim = cfg.n_kv_heads * hd
    act_in = 3 * d + q_dim + 2 * d + cfg.d_ff
    requant_out = q_dim + 2 * kv_dim + d + 2 * cfg.d_ff + d
    head = d + cfg.vocab_padded
    return cfg.n_layers * (act_in + requant_out) + head


def state_quant_ops_per_step(cfg) -> int:
    """Eq.-1 quantization ops to re-quantize ONE sequence's ENTIRE
    recurrent state once, i.e. per engine step on the fixed-slab
    substrate (DESIGN §16).

    This is the recurrent counterpart of the per-token KV write: a
    transformer quantizes ``n_layers * n_kv_heads * head_dim * 2`` new
    elements per token and the cost of touching the cache grows with
    context; a recurrent layer re-quantizes its fixed-size state slab
    once per step, so the per-step cost is CONTEXT-FREE.  Counted
    whether the slab is stored int8 (ops performed) or fp32 (the same
    ops as the counterfactual ``avoided`` bucket), so
    ``requant_ops_per_token`` compares across storage modes.

    RWKV6 per layer: the (H, 64, 64) wkv matrix plus the two d_model
    token-shift rows.  Mamba2 per layer: the (H, P, N) SSD state plus
    the (d_conv-1, d_conv_in) rolling conv window.  Hybrid stacks count
    the Mamba slab for every layer (the shared attention block's KV is
    on the ordinary per-token accounting).  Zero on pure attention.
    """
    s = getattr(cfg, "ssm", None)
    if s is None:
        return 0
    if s.kind == "rwkv6":
        n_heads = cfg.d_model // 64            # HEAD_DIM = 64
        return cfg.n_layers * (n_heads * 64 * 64 + 2 * cfg.d_model)
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    d_conv_in = d_inner + 2 * s.n_groups * s.d_state
    per_layer = (n_heads * s.head_dim * s.d_state
                 + (s.d_conv - 1) * d_conv_in)
    return cfg.n_layers * per_layer


def memory_access_bytes(n_elements: int, bits: int) -> int:
    """Storage/traffic for one tensor — the paper's ~4x memory-access claim
    (8-bit vs fp32) falls out of bits/32."""
    return n_elements * bits // 8
