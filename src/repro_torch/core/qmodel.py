"""Quantized-execution context — how the paper's scheme enters the models.

PyTorch counterpart of ``repro.core.qmodel`` for the modes this slice
serves:

* ``fp``  — float reference; the projection is a plain ``torch.matmul``
  (the JAX package leaves that product to XLA, outside any kernel).
* ``int`` — deploy path: activations quantized at unified-module
  boundaries, int8 x int8 -> int32 products with a single bit-shift
  requantization per module through ``kernels.ops.int8_matmul`` (the
  hand-written CUDA kernel on a CUDA tensor, its plain version on the
  CPU).

``fake`` / ``fake_sf`` and Algorithm-1 calibration belong to the next
slice.  The context carries the table (module name -> fractional bits);
uncalibrated modules use the static ``ModuleBits`` defaults.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Mapping, Optional

import torch

from repro_torch.core import integer_ops
from repro_torch.core.qscheme import dequant, quant

__all__ = ["QuantMode", "ModuleBits", "QuantContext", "qlinear",
           "module_name_for_path", "quantize_weight_tree",
           "DEFAULT_N_W", "DEFAULT_N_X", "DEFAULT_N_O"]

# Static fall-back fractional bits: transformer weights are ~N(0, 0.02)
# so n_w=8 keeps |w|<0.5 in range; activations post-norm are O(1..10) so
# n_x=4.
DEFAULT_N_W = 8
DEFAULT_N_X = 4
DEFAULT_N_O = 4


class QuantMode(enum.Enum):
    FP = "fp"
    FAKE = "fake"        # not ported yet
    FAKE_SF = "fake_sf"  # not ported yet
    INT = "int"


@dataclasses.dataclass(frozen=True)
class ModuleBits:
    """Fractional bits for one unified module."""

    n_x: int = DEFAULT_N_X
    n_w: int = DEFAULT_N_W
    n_b: Optional[int] = None
    n_o: int = DEFAULT_N_O
    out_unsigned: bool = False


@dataclasses.dataclass(frozen=True)
class QuantContext:
    """Static quantization configuration threaded through a forward."""

    mode: QuantMode = QuantMode.FP
    bits: int = 8
    table: Mapping[str, ModuleBits] = dataclasses.field(default_factory=dict)

    def bits_for(self, name: str) -> ModuleBits:
        return self.table.get(name, ModuleBits())


def _fp_linear(x, w, b):
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def qlinear(ctx: QuantContext, name: str, x: torch.Tensor, w: torch.Tensor,
            b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One unified-module linear op under the active quantization mode.

    ``x`` is a float activation at the module boundary; the result is a
    float activation, exact (``fp``) or on the module's output grid
    (``int``).  In ``int`` mode ``w`` may already be int8 codes (from
    :func:`quantize_weight_tree`, bit-identical to quantizing here).
    """
    if w.dtype == torch.int8 and ctx.mode is not QuantMode.INT:
        raise ValueError(
            f"module {name!r}: int8 weight codes reached the "
            f"{ctx.mode.value!r} path — pre-quantized weights require INT "
            "mode")
    if ctx.mode is QuantMode.FP:
        return _fp_linear(x, w, b)
    if ctx.mode is not QuantMode.INT:
        raise NotImplementedError(
            f"QuantMode {ctx.mode.value!r} is not ported yet (ROADMAP "
            "Queue 1 item 5: calibration / fake-quant)")

    mb = ctx.bits_for(name)
    x_int = quant(x, mb.n_x, ctx.bits)
    w_int = w if w.dtype == torch.int8 else quant(w, mb.n_w, ctx.bits)
    n_b = mb.n_b if mb.n_b is not None else mb.n_w
    b_int = None
    if b is not None:
        b_int = b if b.dtype == torch.int8 else quant(b, n_b, ctx.bits)
    spec = integer_ops.LinearQuantSpec(
        n_x=mb.n_x, n_w=mb.n_w, n_b=n_b, n_o=mb.n_o, bits=ctx.bits)
    from repro_torch.kernels import ops as kops
    o_int = kops.int8_matmul(x_int, w_int, b_int, spec)
    return dequant(o_int, mb.n_o, out_dtype=x.dtype)


def module_name_for_path(path_name: str, table: Mapping[str, ModuleBits]
                         ) -> Optional[str]:
    """Longest suffix of a params path (``blocks/3/attn/wq``) present in
    the table; None when no calibrated module matches."""
    parts = path_name.split("/")
    for i in range(len(parts)):
        cand = "/".join(parts[i:])
        if cand in table:
            return cand
    return None


def quantize_weight_tree(params: Any, ctx: QuantContext) -> Any:
    """Convert float matmul weights to int8 codes ONCE, at model build.

    Leaves with ndim >= 2 whose path holds neither 'norm' nor 'embed'
    become ``quant(w, n_w)`` on their module's grid (the table entry for
    the longest matching path suffix, else the defaults) — bit-identical
    to the per-call quantization in :func:`qlinear`'s INT branch, so the
    step then reads int8 weights instead of float ones.  Embeddings and
    norm gains stay float.  Returns a new tree; the input is untouched.
    """
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, f"{path}/{i}" if path else str(i))
                              for i, v in enumerate(node))
        if (isinstance(node, torch.Tensor) and node.ndim >= 2
                and node.dtype != torch.int8
                and "norm" not in path and "embed" not in path):
            mod = module_name_for_path(path, ctx.table)
            mb = ctx.bits_for(mod) if mod is not None else ModuleBits()
            return quant(node, mb.n_w, ctx.bits)
        return node

    return walk(params, "")
