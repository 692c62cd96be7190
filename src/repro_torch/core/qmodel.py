"""Quantized-execution context — how the paper's scheme enters the models.

PyTorch counterpart of ``repro.core.qmodel``:

* ``fp``   — float reference; the projection is a plain ``torch.matmul``
  (the JAX package leaves that product to XLA, outside any kernel).
  Inside :func:`capture_activations` every module's (input, weight,
  bias) is recorded for Algorithm-1 calibration.
* ``fake`` — Eq. (1) in float arithmetic at every quant point.
* ``int``  — deploy path: activations quantized at unified-module
  boundaries, int8 x int8 -> int32 products with a single bit-shift
  requantization per module through ``kernels.ops.int8_matmul`` (the
  hand-written CUDA kernel on a CUDA tensor, its plain version on the
  CPU).

``fake_sf`` (the scaling-factor baseline) waits for ``core/baselines``.  The
context carries the table (module name -> fractional bits) that
``core.lm_calibrate.calibrate_lm`` fills; uncalibrated modules use the
static ``ModuleBits`` defaults.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import enum
from typing import Any, Mapping, Optional

import torch

from repro_torch.core import integer_ops
from repro_torch.core.qscheme import dequant, fake_quant, quant

__all__ = ["QuantMode", "ModuleBits", "QuantContext", "qlinear",
           "capture_activations", "module_name_for_path",
           "quantize_weight_tree", "QuantizedParams", "quantize_params",
           "DEFAULT_N_W", "DEFAULT_N_X", "DEFAULT_N_O"]

# Static fall-back fractional bits: transformer weights are ~N(0, 0.02)
# so n_w=8 keeps |w|<0.5 in range; activations post-norm are O(1..10) so
# n_x=4.
DEFAULT_N_W = 8
DEFAULT_N_X = 4
DEFAULT_N_O = 4


class QuantMode(enum.Enum):
    FP = "fp"
    FAKE = "fake"
    FAKE_SF = "fake_sf"  # not ported yet (core/baselines.py)
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


# Activation capture for Algorithm-1 calibration: while a store is set,
# every FP-mode qlinear records its (input, weight, bias) under its module
# name, FIRST occurrence only — the layers share a module name, so layer 0
# calibrates the stack (the static-shift constraint of the deploy path).
_CAPTURE: contextvars.ContextVar[Optional[dict]] = contextvars.ContextVar(
    "repro_torch_capture", default=None)


@contextlib.contextmanager
def capture_activations():
    """Context in which FP-mode :func:`qlinear` calls record
    ``name -> (x, w, b)`` into the yielded dict, in call order."""
    store: dict[str, tuple] = {}
    token = _CAPTURE.set(store)
    try:
        yield store
    finally:
        _CAPTURE.reset(token)


def qlinear(ctx: QuantContext, name: str, x: torch.Tensor, w: torch.Tensor,
            b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One unified-module linear op under the active quantization mode.

    ``x`` is a float activation at the module boundary; the result is a
    float activation, exact (``fp``) or on the module's output grid
    (``fake``, ``int``).  In ``int`` mode ``w`` may already be int8 codes
    (from :func:`quantize_params` / :func:`quantize_weight_tree`,
    bit-identical to quantizing here).
    """
    if w.dtype == torch.int8 and ctx.mode is not QuantMode.INT:
        raise ValueError(
            f"module {name!r}: int8 weight codes reached the "
            f"{ctx.mode.value!r} path — pre-quantized weights require INT "
            "mode (cfg.matmul_kernel='int8')")
    if ctx.mode is QuantMode.FP:
        store = _CAPTURE.get()
        if store is not None and name not in store:
            store[name] = (x, w, b)
        return _fp_linear(x, w, b)
    if ctx.mode is QuantMode.FAKE_SF:
        raise NotImplementedError(
            "QuantMode 'fake_sf' (the scaling-factor baseline) is not ported "
            "yet (ROADMAP Queue 1 item 3, 'The paper's tables and their "
            "baselines': core/baselines.py)")

    mb = ctx.bits_for(name)
    n_b = mb.n_b if mb.n_b is not None else mb.n_w
    if ctx.mode is QuantMode.FAKE:
        xq = fake_quant(x, mb.n_x, ctx.bits)
        wq = fake_quant(w, mb.n_w, ctx.bits).to(x.dtype)
        bq = None if b is None else fake_quant(b, n_b, ctx.bits).to(x.dtype)
        return _fp_linear(xq, wq, bq)

    x_int = quant(x, mb.n_x, ctx.bits)
    w_int = w if w.dtype == torch.int8 else quant(w, mb.n_w, ctx.bits)
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


def _map_leaves(node, fn, path=""):
    """``fn(path, tensor)`` over every tensor of a nested dict / list
    tree; paths join keys and list indices with '/'."""
    if isinstance(node, dict):
        return {k: _map_leaves(v, fn, f"{path}/{k}" if path else k)
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_map_leaves(v, fn, f"{path}/{i}" if path else str(i))
                          for i, v in enumerate(node))
    return fn(path, node)


def quantize_weight_tree(params: Any, ctx: QuantContext) -> Any:
    """Convert float matmul weights to int8 codes ONCE, at model build.

    Leaves with ndim >= 2 whose path holds neither 'norm' nor 'embed'
    become ``quant(w, n_w)`` on their module's grid (the table entry for
    the longest matching path suffix, else the defaults) — bit-identical
    to the per-call quantization in :func:`qlinear`'s INT branch, so the
    step then reads int8 weights instead of float ones.  Embeddings and
    norm gains stay float.  Returns a new tree; the input is untouched.
    """
    def conv(path, leaf):
        if (isinstance(leaf, torch.Tensor) and leaf.ndim >= 2
                and leaf.dtype != torch.int8
                and "norm" not in path and "embed" not in path):
            mod = module_name_for_path(path, ctx.table)
            mb = ctx.bits_for(mod) if mod is not None else ModuleBits()
            return quant(leaf, mb.n_w, ctx.bits)
        return leaf

    return _map_leaves(params, conv)


@dataclasses.dataclass(frozen=True)
class QuantizedParams:
    """W8A8 deploy weights (``cfg.matmul_kernel='int8'``): ``tree`` is the
    params tree with calibrated matmul weights as int8 codes on the
    INT-mode context's grids, ``converted`` the tree paths that were
    quantized."""

    tree: Any
    converted: tuple = ()


def quantize_params(params: Any, ctx: QuantContext) -> QuantizedParams:
    """Pre-quantize the calibrated matmul weights to int8 codes.

    Only leaves with ndim >= 2 whose path maps onto a calibrated module
    (:func:`module_name_for_path`) convert; embeddings, norm gains and
    biases stay float (a tied LM head reads ``embed.T`` and quantizes on
    the fly to the same codes).  Codes equal ``qlinear``'s on-the-fly
    ``quant(w, n_w)``, so the forward's tokens do not change.  The layers
    are separate leaves here (``blocks/<i>/...``) where the JAX package
    stacks them; all share their module's one grid."""
    converted = []

    def conv(path, leaf):
        mod = module_name_for_path(path, ctx.table)
        if (mod is not None and isinstance(leaf, torch.Tensor)
                and leaf.ndim >= 2 and leaf.dtype != torch.int8
                and "embed" not in path):
            converted.append(path)
            return quant(leaf, ctx.bits_for(mod).n_w, ctx.bits)
        return leaf

    tree = _map_leaves(params, conv)
    return QuantizedParams(tree=tree, converted=tuple(converted))
