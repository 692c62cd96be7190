"""Dataflow-based unified-module construction — the paper's §1.2.1.

The paper's hypothesis: *fewer quantization operations incur less information
loss* (and fewer hardware requant units).  Given a layer graph, this module
applies the Fig. 1 fusion rules to decide where quantization points live:

  (a) bare linear/conv                      -> quantize after the op
  (b) linear/conv followed by ReLU           -> ONE quant point after ReLU,
      unsigned code, no intermediate writeback
  (c) residual add followed by ReLU          -> align shortcut/branch grids,
      ONE quant point after the add+ReLU
  (d) residual add without ReLU              -> ONE signed quant point after add
  BN/RMSNorm                                 -> folded into the adjacent linear
                                                (no quant point of its own)

The output is a :class:`QuantPlan`: an ordered list of
:class:`UnifiedModule` s, each owning exactly one output quantization point
plus its weight/bias points.  The plan drives (i) Algorithm-1 calibration
order (N_x of module k+1 = N_o of module k along each edge), (ii) the
integer serve path, and (iii) the hardware-cost bench (quant-op counts for
naive vs. joint placement).

A copy of ``repro.core.dataflow``: pure Python apart from
:class:`QuantizedTensor`, a plain dataclass over a torch tensor here (the
reference registers it as a JAX pytree).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Sequence

import torch

__all__ = [
    "OpKind",
    "OpNode",
    "UnifiedModule",
    "QuantPlan",
    "build_plan",
    "QuantizedTensor",
    "count_quant_ops",
]


class OpKind(enum.Enum):
    LINEAR = "linear"          # matmul / conv — has weights (+bias)
    RELU = "relu"
    GELU = "gelu"              # smooth activations: quant point goes AFTER
    SILU_GATE = "silu_gate"    # SwiGLU gate product silu(a)*b
    ADD = "add"                # residual addition (two quantized operands)
    NORM = "norm"              # BatchNorm / RMSNorm — folded, never a q-point
    SOFTMAX = "softmax"        # stays high precision (paper quantizes none)
    EMBED = "embed"            # table lookup; output quantized like (a)
    OUTPUT = "output"          # graph sink


@dataclasses.dataclass
class OpNode:
    """One primitive op in the layer graph (SSA-ish: inputs are node names)."""

    name: str
    kind: OpKind
    inputs: tuple[str, ...] = ()
    has_bias: bool = False
    # residual ADD: which input is the shortcut (for alignment bookkeeping)
    meta: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class UnifiedModule:
    """A fused region with exactly one activation quantization point.

    ``case`` is the paper's Fig. 1 label.  ``ops`` lists the fused op names
    in execution order.  ``out_unsigned`` is True for case (b)/(c) where a
    ReLU precedes the quant point.
    """

    name: str
    case: str                       # 'a' | 'b' | 'c' | 'd' | 'embed'
    ops: tuple[str, ...]
    weight_points: tuple[str, ...]  # ops owning a weight quant point
    bias_points: tuple[str, ...]
    out_unsigned: bool
    inputs: tuple[str, ...]         # upstream unified-module names (N_x edges)


@dataclasses.dataclass
class QuantPlan:
    modules: list[UnifiedModule]
    n_naive_points: int   # quantize-after-every-op baseline (DoReFa placement)
    n_joint_points: int   # this plan's activation quant points

    def module(self, name: str) -> UnifiedModule:
        for m in self.modules:
            if m.name == name:
                return m
        raise KeyError(name)


def _consumers(nodes: Sequence[OpNode]) -> dict[str, list[OpNode]]:
    out: dict[str, list[OpNode]] = {n.name: [] for n in nodes}
    for n in nodes:
        for i in n.inputs:
            if i in out:
                out[i].append(n)
    return out


def build_plan(nodes: Sequence[OpNode]) -> QuantPlan:
    """Apply the Fig. 1 fusion rules over a topologically-ordered op list.

    Rules, in priority order (greedy over the topo order, single pass —
    mirrors the paper's by-construction restructuring, not a search):

      1. NORM nodes are absorbed into their unique LINEAR consumer (folding).
      2. LINEAR with a single RELU consumer fuses -> case (b).
      3. ADD with a single RELU consumer fuses -> case (c); bare ADD -> (d).
      4. LINEAR/EMBED otherwise -> case (a)/'embed'.
      5. GELU/SILU_GATE close the module of their producing LINEAR (quant
         point after the nonlinearity, the case-(b) generalization).
    """
    by_name = {n.name: n for n in nodes}
    cons = _consumers(nodes)
    absorbed: set[str] = set()     # ops already folded into a module
    modules: list[UnifiedModule] = []
    # naive baseline: one activation quant op after every value-producing op
    naive = sum(1 for n in nodes
                if n.kind not in (OpKind.NORM, OpKind.OUTPUT, OpKind.SOFTMAX))

    # map op name -> unified module that produces its output
    producer_mod: dict[str, str] = {}

    def upstream_modules(op: OpNode) -> tuple[str, ...]:
        ups = []
        for i in op.inputs:
            seen = i
            # walk through folded norms to the real producer
            while seen in by_name and by_name[seen].kind == OpKind.NORM:
                seen = by_name[seen].inputs[0]
            if seen in producer_mod:
                ups.append(producer_mod[seen])
        return tuple(dict.fromkeys(ups))

    for n in nodes:
        if n.name in absorbed or n.kind in (OpKind.NORM, OpKind.OUTPUT,
                                            OpKind.SOFTMAX):
            continue

        if n.kind in (OpKind.LINEAR, OpKind.EMBED):
            nexts = cons.get(n.name, [])
            fused_act = None
            if len(nexts) == 1 and nexts[0].kind in (OpKind.RELU, OpKind.GELU,
                                                     OpKind.SILU_GATE):
                fused_act = nexts[0]
            ops = (n.name,) + ((fused_act.name,) if fused_act else ())
            case = ("b" if fused_act and fused_act.kind == OpKind.RELU
                    else "a" if not fused_act else "b")
            if n.kind == OpKind.EMBED:
                case = "embed"
            m = UnifiedModule(
                name=f"um_{n.name}", case=case, ops=ops,
                weight_points=(n.name,) if n.kind == OpKind.LINEAR else (n.name,),
                bias_points=(n.name,) if n.has_bias else (),
                out_unsigned=bool(fused_act and fused_act.kind == OpKind.RELU),
                inputs=upstream_modules(n),
            )
            if fused_act:
                absorbed.add(fused_act.name)
                producer_mod[fused_act.name] = m.name
            producer_mod[n.name] = m.name
            modules.append(m)

        elif n.kind == OpKind.ADD:
            nexts = cons.get(n.name, [])
            fused_relu = None
            if len(nexts) == 1 and nexts[0].kind == OpKind.RELU:
                fused_relu = nexts[0]
            ops = (n.name,) + ((fused_relu.name,) if fused_relu else ())
            m = UnifiedModule(
                name=f"um_{n.name}", case="c" if fused_relu else "d",
                ops=ops, weight_points=(), bias_points=(),
                out_unsigned=fused_relu is not None,
                inputs=upstream_modules(n),
            )
            if fused_relu:
                absorbed.add(fused_relu.name)
                producer_mod[fused_relu.name] = m.name
            producer_mod[n.name] = m.name
            modules.append(m)

        elif n.kind in (OpKind.RELU, OpKind.GELU, OpKind.SILU_GATE):
            # un-fused activation (producer had multiple consumers): its own
            # quant point, case (b) semantics without the writeback saving.
            m = UnifiedModule(
                name=f"um_{n.name}", case="b", ops=(n.name,),
                weight_points=(), bias_points=(),
                out_unsigned=n.kind == OpKind.RELU,
                inputs=upstream_modules(n),
            )
            producer_mod[n.name] = m.name
            modules.append(m)

    return QuantPlan(modules=modules, n_naive_points=naive,
                     n_joint_points=len(modules))


def count_quant_ops(plan: QuantPlan) -> dict[str, int]:
    """Quant-op counts for the hardware-cost comparison (Table 5 bench)."""
    return {
        "naive_activation_points": plan.n_naive_points,
        "joint_activation_points": plan.n_joint_points,
        "weight_points": sum(len(m.weight_points) for m in plan.modules),
        "bias_points": sum(len(m.bias_points) for m in plan.modules),
        "saved": plan.n_naive_points - plan.n_joint_points,
    }


@dataclasses.dataclass
class QuantizedTensor:
    """Integer codes + the power-of-two grid they live on.

    ``codes`` is an int8/int16/int32 tensor, ``n`` the fractional bit,
    matching the paper's deploy artifact split: integer tensors + shift
    constants.
    """

    codes: torch.Tensor
    n: int
    bits: int = 8
    unsigned: bool = False

    def dequant(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return (self.codes.to(torch.float32) * (2.0 ** (-self.n))).to(dtype)

    @property
    def shape(self):
        return self.codes.shape
