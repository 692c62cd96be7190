"""Quantized-execution context — how the paper's scheme enters the models.

PyTorch counterpart of ``repro.core.qmodel``:

* ``fp``   — float reference; the projection is a plain ``torch.matmul``
  (the JAX package leaves that product to XLA, outside any kernel).
  Inside :func:`capture_activations` every module's (input, weight,
  bias) is recorded for Algorithm-1 calibration.
* ``fake`` — Eq. (1) in float arithmetic at every quant point.
* ``fake_sf`` — the scaling-factor baseline of the paper's Tables 1 and 3
  (``core.baselines.scale_quant``: per-tensor float scales on weights
  AND activations, rounded half to even), float arithmetic; it needs no
  calibration table.
* ``int``  — deploy path: activations quantized at unified-module
  boundaries (``kernels.ops.quantize_multi``, K3: one launch a module
  input), int8 x int8 -> int32 products with a single bit-shift
  requantization per module through ``kernels.ops.int8_matmul`` (K2),
  whose epilogue writes the module's dequantized float output itself
  (the hand-written CUDA kernels on a CUDA tensor, their plain versions
  on the CPU).
  :func:`qlinears` takes modules that read one activation and quantizes
  it once, in one launch, for all of them.

The context carries the table (module name -> fractional bits) that
``core.lm_calibrate.calibrate_lm`` fills; uncalibrated modules use the
static ``ModuleBits`` defaults.

On a tensor-parallel mesh (``distributed.sharding.activation_sharding``)
each rank holds its slices: a column-cut module (``wq``, ``w1``, the LM
head) is exact as it is, per output column; a row-cut one (``wo``,
``w2``: ``qlinear(..., reduce=True)``) holds this rank's rows of K, and
its ranks' partial products are summed over the model axis: in INT mode
K2's int32 partials (K2's rank-split form), the epilogue once after the
sum, so the output is one rank's bit for bit; in the float modes fp32
partials rounded once to the activation dtype (one rank's up to the
summation order).  ``fake_sf`` takes each statistic over the whole
tensor (a max all-reduce).  In training the row-cut sum and a column-cut
module's input go through ``distributed.collectives`` (the same forward
values; the backward sums the input's gradient over the model axis).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import enum
from typing import Any, Mapping, Optional

import torch

from repro_torch.core import integer_ops
from repro_torch.core.baselines import abs_max, scale_quant
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.collectives import (copy_to_model,
                                                 gather_from_model,
                                                 reduce_from_model)
from repro_torch.core.qscheme import fake_quant, quant, storage_dtype

__all__ = ["QuantMode", "ModuleBits", "QuantContext", "qlinear", "qlinears",
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
    FAKE_SF = "fake_sf"  # scaling-factor baseline (IOA/TensorRT-style W8A8)
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


def _fp_linear(x, w, b, mesh=None):
    """``x @ w + b`` in x's dtype; on a ``mesh`` (a row-cut module) the
    ranks' fp32 partials are summed, then rounded once, before the bias
    (``reduce_from_model``: the sum's gradient is each rank's own)."""
    if mesh is None:
        y = torch.matmul(x, w.to(x.dtype))
    else:
        y = reduce_from_model(torch.matmul(x.to(torch.float32),
                                           w.to(torch.float32)),
                              mesh).to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def _scale_quant_tp(t: torch.Tensor, bits: int, mesh):
    """``scale_quant`` of a tensor that may be cut over ``mesh``'s model
    axis: its statistic all-reduced to the whole tensor's."""
    if mesh is None:
        return scale_quant(t, bits)
    return scale_quant(t, bits,
                       amax=mesh.all_reduce(abs_max(t), "model", op="max"))


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
            b: Optional[torch.Tensor] = None, *, reduce: bool = False,
            split_input: bool = False, gather: bool = False,
            whole: bool = False) -> torch.Tensor:
    """One unified-module linear op under the active quantization mode.

    ``x`` is a float activation at the module boundary; the result is a
    float activation, exact (``fp``) or on the module's output grid
    (``fake``, ``int``).  In ``int`` mode ``w`` may already be int8 codes
    (from :func:`quantize_params` / :func:`quantize_weight_tree`,
    bit-identical to quantizing here).  ``reduce``: the module is row-cut
    on a tensor-parallel mesh (``x`` and ``w`` hold this rank's rows of
    K, ``b`` is whole), and its ranks' partial products are summed over
    the model axis (the module docstring); without such a mesh in scope
    it changes nothing.  Any other module on such a mesh is column-cut
    (``x`` whole, ``w`` this rank's columns): in training its input's
    gradient, each rank's partial, is summed over the model axis
    (``copy_to_model``).

    Three forms the other families' rules ask for (no mesh in scope,
    they change nothing):

    * ``split_input`` (with ``reduce``): the rules cut the module's
      contract dim but ``x`` is whole on every rank (RWKV6's ``w[rkvgo]``,
      mamba2's ``w_in``): the rank takes its block of x's last dim, then
      the row-cut sum.  Elementwise quantization makes the block's codes
      the whole x's codes of the block, so INT stays one rank's bit for
      bit.  In training x's gradient, each rank's block (zeros elsewhere),
      is summed over the model axis.
    * ``gather``: a column-cut module whose output a norm or a residual
      reads whole (mamba2's ``w_out``, zamba2's ``shared/in_proj``,
      RWKV6's ``wr_ffn``): the ranks' output columns are gathered over the
      model axis.  Each column is computed over the whole K, so this is
      exact in every mode.
    * ``whole``: the rules leave the weight whole (MLA's ``wq_a`` and
      ``wkv_a``): x, w and the output are every rank's, and so is x's
      gradient, which is not summed.
    """
    mesh = shd.tp_mesh()
    if mesh is not None and not whole and (split_input or not reduce):
        x = copy_to_model(x, mesh)
    if mesh is not None and split_input:
        k = x.shape[-1] // mesh.shape["model"]
        x = x.narrow(-1, mesh.coords["model"] * k, k)
    y = _qlinear(ctx, name, x, w, b, mesh, mesh if reduce else None)
    if mesh is not None and gather:
        y = gather_from_model(y, mesh, -1)
    return y


def _qlinear(ctx: QuantContext, name: str, x: torch.Tensor,
             w: torch.Tensor, b: Optional[torch.Tensor], mesh,
             row_mesh) -> torch.Tensor:
    """:func:`qlinear` past its input's collective: ``mesh`` the
    tensor-parallel mesh in scope (or None), ``row_mesh`` it for a row-cut
    module."""
    if w.dtype == torch.int8 and ctx.mode is not QuantMode.INT:
        raise ValueError(
            f"module {name!r}: int8 weight codes reached the "
            f"{ctx.mode.value!r} path — pre-quantized weights require INT "
            "mode (cfg.matmul_kernel='int8')")
    if ctx.mode is QuantMode.FP:
        store = _CAPTURE.get()
        if store is not None and name not in store:
            if mesh is not None:
                raise ValueError(
                    "calibration captures whole modules: calibrate before "
                    "the weights are cut over a mesh")
            store[name] = (x, w, b)
        return _fp_linear(x, w, b, row_mesh)
    if ctx.mode is QuantMode.FAKE_SF:
        # the competing scheme: per-tensor float scales, accuracy
        # reference of costly requant hardware
        return _fp_linear(_scale_quant_tp(x, ctx.bits, mesh),
                          _scale_quant_tp(w, ctx.bits, mesh).to(x.dtype),
                          None if b is None else
                          _scale_quant_tp(b, ctx.bits, mesh).to(x.dtype),
                          row_mesh)

    mb = ctx.bits_for(name)
    n_b = mb.n_b if mb.n_b is not None else mb.n_w
    if ctx.mode is QuantMode.FAKE:
        xq = fake_quant(x, mb.n_x, ctx.bits)
        wq = fake_quant(w, mb.n_w, ctx.bits).to(x.dtype)
        bq = None if b is None else fake_quant(b, n_b, ctx.bits).to(x.dtype)
        return _fp_linear(xq, wq, bq, row_mesh)

    return _int_linears(ctx, [name], x, [w], [b], row_mesh)[0]


def qlinears(ctx: QuantContext, names, x: torch.Tensor, ws,
             bs=None) -> list[torch.Tensor]:
    """Unified modules that read the same activation ``x``: ``[qlinear(ctx,
    names[i], x, ws[i], bs[i]) ...]``, each output identical to that call.

    In ``int`` mode ``x`` is quantized ONCE for all of them (at most three
    distinct input grids ``n_x``; calibration may give them different
    ones).  In the other modes it is the loop over :func:`qlinear`, so a
    capture records the same names in the same order."""
    bs = [None] * len(names) if bs is None else list(bs)
    mesh = shd.tp_mesh()
    if mesh is not None:    # column-cut: one gradient sum for all of them
        x = copy_to_model(x, mesh)
    if ctx.mode is not QuantMode.INT:
        return [_qlinear(ctx, n, x, w, b, mesh, None)
                for n, w, b in zip(names, ws, bs)]
    return _int_linears(ctx, names, x, ws, bs)


def _int_linears(ctx: QuantContext, names, x: torch.Tensor, ws,
                 bs, row_mesh=None) -> list[torch.Tensor]:
    """INT mode: one K3 launch writes ``x``'s codes on every distinct input
    grid of the modules, then one K2 launch a module, its epilogue writing
    the module's float output (x's dtype) on the module's output grid.
    Float weights and biases (not pre-quantized) are quantized here by K3,
    to the codes ``quantize_weight_tree`` would give.  With ``row_mesh``
    (row-cut modules) K2's rank-split form instead: this rank's int32
    partial, an int32 sum over the model axis, the epilogue once."""
    from repro_torch.kernels import ops as kops
    mbs = [ctx.bits_for(n) for n in names]
    codes = kops.quantize_multi(x, [mb.n_x for mb in mbs], ctx.bits)
    out = []
    for mb, x_int, w, b in zip(mbs, codes, ws, bs):
        n_b = mb.n_b if mb.n_b is not None else mb.n_w
        w_int = w if w.dtype == torch.int8 else kops.quantize_act(
            w, mb.n_w, ctx.bits)
        b_int = None
        if b is not None:
            b_int = b if b.dtype == torch.int8 else kops.quantize_act(
                b, n_b, ctx.bits)
        spec = integer_ops.LinearQuantSpec(
            n_x=mb.n_x, n_w=mb.n_w, n_b=n_b, n_o=mb.n_o, bits=ctx.bits)
        if row_mesh is None:
            out.append(kops.int8_matmul(x_int, w_int, b_int, spec,
                                        out_float=x.dtype))
            continue
        acc = row_mesh.all_reduce(kops.int8_matmul_partial(x_int, w_int),
                                  "model")
        out.append(kops.int8_matmul_finish(acc, b_int, spec,
                                           out_float=x.dtype))
    return out


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


def quantize_weight_tree(params: Any, ctx: QuantContext,
                         name_fn=None) -> Any:
    """Convert float matmul weights to int8 codes ONCE, at model build.

    Each converted leaf becomes ``quant(w, n_w)`` on its module's grid
    (the table entry, else the defaults) -- bit-identical to the per-call
    quantization in :func:`qlinear`'s INT branch, so the step then reads
    int8 weights instead of float ones.  By default the leaves with ndim
    >= 2 whose path holds neither 'norm' nor 'embed' convert, each on the
    grid of the longest path suffix in the table.  With ``name_fn``,
    ``name_fn(path, leaf)`` names the module whose ``qlinear`` call reads
    the leaf (``models.model.qlinear_weight``), whose grid it takes, or
    returns None to keep the leaf float.  Embeddings and norm gains stay
    float.  A stack of matrices (ndim >= 3: the MoE experts, (E, K, N))
    converts slice by slice into one int8 stack, the same codes without
    the whole stack's fp32 temporaries (deepseek-v3's stacks hold 3.76 G
    elements each).  Returns a new tree; the input is untouched.
    """
    def conv(path, leaf):
        if not isinstance(leaf, torch.Tensor) or leaf.dtype == torch.int8:
            return leaf
        if name_fn is not None:
            mod = name_fn(path, leaf)
            if mod is None:
                return leaf
        elif leaf.ndim >= 2 and "norm" not in path and "embed" not in path:
            mod = module_name_for_path(path, ctx.table)
        else:
            return leaf
        mb = ctx.bits_for(mod) if mod is not None else ModuleBits()
        if leaf.ndim < 3:
            return quant(leaf, mb.n_w, ctx.bits)
        codes = torch.empty(leaf.shape, dtype=storage_dtype(ctx.bits),
                            device=leaf.device)
        for i in range(leaf.shape[0]):
            codes[i] = quant(leaf[i], mb.n_w, ctx.bits)
        return codes

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
