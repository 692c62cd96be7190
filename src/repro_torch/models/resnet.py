"""The paper's own model family: ResNet with BatchNorm, the faithful
reproduction vehicle for Tables 1-3 / Fig. 2.

PyTorch counterpart of ``repro.models.resnet``, NHWC activations and
HWIO weights throughout as the reference.  The path exercises every
element of the paper:

* BN folding into conv weights/biases at inference (paper §1.2.1),
* Fig. 1 cases a-d (conv / conv+ReLU / residual+ReLU / residual),
* Algorithm 1 sequential calibration over the dataflow plan,
* the integer-only deploy path (int8 codes + shift constants), with
  unsigned post-ReLU codes.

On the card the integer forward runs on the hand-written kernels: K3
quantizes the image and the head input, the convolution kernel
(``csrc/int_conv.cu``, implicit GEMM, no im2col matrix) computes every
convolution, each block's conv2 with the residual add as its epilogue
(K7's arithmetic), and K2 the head (at CONFIG width 15, 1 and 2
launches a forward).

The float convolutions run with TF32 off (``torch.backends.cudnn`` allows
TF32 for fp32 convolutions by default), whatever the caller's global
setting, so the calibration table does not depend on it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import numpy as np
import torch

from repro_torch.configs.resnet_paper import ResNetConfig
from repro_torch.core import calibrate, dataflow, integer_ops, qscheme
from repro_torch.core.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.common import Initializer

__all__ = ["init_resnet", "resnet_forward", "fold_bn", "build_resnet_plan",
           "quantize_resnet", "resnet_int_forward", "QuantizedResNet",
           "from_jax_resnet_params", "from_jax_quantized_resnet"]

Device = Optional[Union[str, torch.device]]


def _stride(si: int, blk_i: int) -> int:
    return 2 if (blk_i == 0 and si > 0) else 1


def init_resnet(cfg: ResNetConfig, *, generator: torch.Generator,
                device: Device = None) -> dict:
    """Random fp32 weights (fan-in scaled truncated normal) and identity
    BN statistics on ``device`` (default ``cuda``), drawn from
    ``generator`` on its own device, so one CPU generator gives the same
    weights on the card and on the CPU.  Not the JAX package's numbers:
    tests carry its weights over with :func:`from_jax_resnet_params`."""
    dev = resolve_device(device)
    init = Initializer(generator, torch.float32, generator.device)
    p: dict = {"stem": _conv_init(init, 3, cfg.stages[0], 3)}
    blocks = []
    for si, ch in enumerate(cfg.stages):
        for bi in range(cfg.blocks_per_stage):
            cin = cfg.stages[max(si - 1, 0)] if bi == 0 else ch
            blk = {"conv1": _conv_init(init, cin, ch, 3),
                   "conv2": _conv_init(init, ch, ch, 3)}
            if cin != ch:
                blk["proj"] = _conv_init(init, cin, ch, 1)
            blocks.append(blk)
    p["blocks"] = blocks
    p["head"] = {"w": init.dense((cfg.stages[-1], cfg.n_classes)),
                 "b": init.zeros((cfg.n_classes,))}
    return _tree_map(lambda t: t.to(dev), p)


def _tree_map(fn, t: Any) -> Any:
    """``fn`` on every leaf of a tree of dicts and lists (tuples become
    lists)."""
    if isinstance(t, dict):
        return {k: _tree_map(fn, v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_tree_map(fn, v) for v in t]
    return fn(t)


def _conv_init(init: Initializer, cin: int, cout: int, k: int) -> dict:
    return {"w": init.dense((k, k, cin, cout), fan_in=k * k * cin),
            "bn_gamma": init.ones((cout,)),
            "bn_beta": init.zeros((cout,)),
            "bn_mean": init.zeros((cout,)),
            "bn_var": init.ones((cout,))}


def fold_bn(conv: dict, eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Paper §1.2.1: merge BN into the conv's weights and bias.

    y = gamma * (conv(x) - mean) / sqrt(var + eps) + beta
      = conv(x; W * s) + (beta - mean * s),  s = gamma / sqrt(var + eps)
    """
    s = conv["bn_gamma"] / torch.sqrt(conv["bn_var"] + eps)
    return conv["w"] * s, conv["bn_beta"] - conv["bn_mean"] * s


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          stride: int = 1) -> torch.Tensor:
    """fp32 NHWC x HWIO convolution with XLA's "SAME" padding, + bias."""
    kh, kw = w.shape[0], w.shape[1]
    ph = integer_ops.same_padding(x.shape[1], kh, stride)
    pw = integer_ops.same_padding(x.shape[2], kw, stride)
    xp = torch.nn.functional.pad(x.permute(0, 3, 1, 2),
                                 (pw[0], pw[1], ph[0], ph[1]))
    y = torch.nn.functional.conv2d(xp, w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1) + b


def _fp32_convs():
    """cuDNN without TF32, for this block only."""
    return torch.backends.cudnn.flags(
        enabled=torch.backends.cudnn.enabled,
        benchmark=torch.backends.cudnn.benchmark,
        deterministic=torch.backends.cudnn.deterministic, allow_tf32=False)


def resnet_forward(p: dict, x: torch.Tensor, cfg: ResNetConfig,
                   collect: Optional[dict] = None) -> torch.Tensor:
    """FP reference forward (BN folded) of NHWC images -> logits.
    ``collect`` captures intermediate module outputs for calibration
    (name -> tensor)."""

    def log(name, v):
        if collect is not None:
            collect[name] = v
        return v

    relu = torch.relu
    with torch.no_grad(), _fp32_convs():
        w, b = fold_bn(p["stem"])
        h = log("stem", relu(_conv(x, w, b)))
        bi = 0
        for si, _ in enumerate(cfg.stages):
            for blk_i in range(cfg.blocks_per_stage):
                blk = p["blocks"][bi]
                stride = _stride(si, blk_i)
                w1, b1 = fold_bn(blk["conv1"])
                h1 = log(f"b{bi}/conv1", relu(_conv(h, w1, b1, stride)))
                w2, b2 = fold_bn(blk["conv2"])
                h2 = log(f"b{bi}/conv2", _conv(h1, w2, b2))       # case (a)
                if "proj" in blk:
                    wp, bp = fold_bn(blk["proj"])
                    sc = log(f"b{bi}/proj", _conv(h, wp, bp, stride))
                else:
                    sc = h
                h = log(f"b{bi}/add", relu(h2 + sc))              # case (c)
                bi += 1
        pooled = torch.mean(h, dim=(1, 2))
        return log("head", pooled @ p["head"]["w"] + p["head"]["b"])


def build_resnet_plan(cfg: ResNetConfig) -> dataflow.QuantPlan:
    """The op graph fed to the Fig. 1 fusion rules."""
    K = dataflow.OpKind
    nodes = [dataflow.OpNode("stem", K.LINEAR, ("in",), has_bias=True),
             dataflow.OpNode("stem_relu", K.RELU, ("stem",))]
    prev = "stem_relu"
    bi = 0
    for si, _ in enumerate(cfg.stages):
        for blk_i in range(cfg.blocks_per_stage):
            n1, n2 = f"b{bi}/conv1", f"b{bi}/conv2"
            nodes += [
                dataflow.OpNode(n1, K.LINEAR, (prev,), has_bias=True),
                dataflow.OpNode(f"{n1}_relu", K.RELU, (n1,)),
                dataflow.OpNode(n2, K.LINEAR, (f"{n1}_relu",), has_bias=True),
            ]
            sc = prev
            if blk_i == 0 and si > 0:
                nodes.append(dataflow.OpNode(f"b{bi}/proj", K.LINEAR, (prev,),
                                             has_bias=True))
                sc = f"b{bi}/proj"
            nodes += [
                dataflow.OpNode(f"b{bi}/add", K.ADD, (n2, sc)),
                dataflow.OpNode(f"b{bi}/add_relu", K.RELU, (f"b{bi}/add",)),
            ]
            prev = f"b{bi}/add_relu"
            bi += 1
    nodes.append(dataflow.OpNode("head", K.LINEAR, (prev,), has_bias=True))
    return dataflow.build_plan(nodes)


@dataclasses.dataclass
class QuantizedResNet:
    """Deploy artifacts: integer codes + shift bookkeeping (paper §1.2)."""

    weights: dict            # name -> int8 W codes (HWIO, or (C, classes))
    biases: dict             # name -> int8 B codes
    specs: dict              # name -> LinearQuantSpec, or (n_a, n_b, n_o)
    report: calibrate.CalibrationReport
    n_in: int                # input activation fractional bits


def quantize_resnet(p: dict, x_calib: torch.Tensor, cfg: ResNetConfig,
                    n_bits: int = 8, tau: int = 4) -> QuantizedResNet:
    """Algorithm 1 over the dataflow plan, sequential along the network,
    on the device ``p`` and ``x_calib`` lie on.

    Follows the paper: a single calibration batch, grid search per
    unified module, the chosen N_o threads forward as the next module's
    N_x.
    """
    collect: dict = {}
    resnet_forward(p, x_calib, cfg, collect=collect)
    report = calibrate.CalibrationReport()
    weights, biases, specs = {}, {}, {}
    fq = qscheme.fake_quant

    # input quantization point (images in [0, 1])
    n_in = (n_bits - 1) - qscheme.search_window(x_calib, 0)[1]
    xq = fq(x_calib, n_in, n_bits)

    def calibrate_conv(name, conv, x_in, n_x, o_ref, stride, fuse_relu):
        w, b = fold_bn(conv)

        def apply(xx, wq, bq):
            y = _conv(xx, wq, bq, stride)
            return torch.relu(y) if fuse_relu else y

        r = calibrate.calibrate_linear_module(
            x_in, w, b, o_ref, apply, bits=n_bits, tau=tau,
            out_unsigned=fuse_relu)
        report.add(name, r)
        weights[name] = qscheme.quant(w, r.n_w, n_bits)
        biases[name] = qscheme.quant(b, r.n_b, n_bits)
        specs[name] = integer_ops.LinearQuantSpec(
            n_x=n_x, n_w=r.n_w, n_b=r.n_b, n_o=r.n_o, bits=n_bits,
            out_unsigned=fuse_relu)
        out = apply(x_in, fq(w, r.n_w, n_bits), fq(b, r.n_b, n_bits))
        return fq(out, r.n_o, n_bits, fuse_relu), r.n_o

    with torch.no_grad(), _fp32_convs():
        h, n_h = calibrate_conv("stem", p["stem"], xq, n_in, collect["stem"],
                                1, True)
        bi = 0
        for si, _ in enumerate(cfg.stages):
            for blk_i in range(cfg.blocks_per_stage):
                blk = p["blocks"][bi]
                stride = _stride(si, blk_i)
                h1, n1 = calibrate_conv(f"b{bi}/conv1", blk["conv1"], h, n_h,
                                        collect[f"b{bi}/conv1"], stride, True)
                h2, n2 = calibrate_conv(f"b{bi}/conv2", blk["conv2"], h1, n1,
                                        collect[f"b{bi}/conv2"], 1, False)
                if "proj" in blk:
                    sc, n_sc = calibrate_conv(f"b{bi}/proj", blk["proj"], h,
                                              n_h, collect[f"b{bi}/proj"],
                                              stride, False)
                else:
                    sc, n_sc = h, n_h
                # Fig. 1(c): residual add + ReLU, one joint quant point; the
                # operands on their grids as signed codes, as the reference
                a_int = qscheme.quant(h2, n2, n_bits)
                b_int = qscheme.quant(sc, n_sc, n_bits)
                r = calibrate.calibrate_add_module(
                    qscheme.dequant(a_int, n2), qscheme.dequant(b_int, n_sc),
                    collect[f"b{bi}/add"], bits=n_bits, out_unsigned=True,
                    apply_relu=True)
                report.add(f"b{bi}/add", r)
                specs[f"b{bi}/add"] = (n2, n_sc, r.n_o)
                h = fq(torch.relu(h2 + sc), r.n_o, n_bits, True)
                n_h = r.n_o
                bi += 1

        # classifier head (case a)
        pooled = torch.mean(h, dim=(1, 2))

        def apply_head(xx, wq, bq):
            return xx @ wq + bq

        r = calibrate.calibrate_linear_module(
            pooled, p["head"]["w"], p["head"]["b"], collect["head"],
            apply_head, bits=n_bits, tau=tau)
    report.add("head", r)
    weights["head"] = qscheme.quant(p["head"]["w"], r.n_w, n_bits)
    biases["head"] = qscheme.quant(p["head"]["b"], r.n_b, n_bits)
    specs["head"] = integer_ops.LinearQuantSpec(
        n_x=n_h, n_w=r.n_w, n_b=r.n_b, n_o=r.n_o, bits=n_bits)
    return QuantizedResNet(weights=weights, biases=biases, specs=specs,
                           report=report, n_in=n_in)


def resnet_int_forward(q: QuantizedResNet, x: torch.Tensor,
                       cfg: ResNetConfig) -> torch.Tensor:
    """Integer-only inference (Eq. 3/4): 8-bit codes end to end, bit
    shifts between modules, no floats until the head's input and the
    final logits dequant.  Runs on the device of ``q``'s codes and ``x``.

    The global average pool sums the last block's codes in int32 (exact)
    and scales once; the reference's fp32 mean of the dequantized codes
    is exact too while the sum stays below 2^24 codes, as it does here."""
    xi = ops.quantize_act(x, q.n_in, 8)                               # K3
    hi = integer_ops.int_conv2d(xi, q.weights["stem"], q.biases["stem"],
                                q.specs["stem"], apply_relu=True)
    n_h = q.specs["stem"].n_o
    bi = 0
    for si, _ in enumerate(cfg.stages):
        for blk_i in range(cfg.blocks_per_stage):
            stride = _stride(si, blk_i)
            name = f"b{bi}"
            h1 = integer_ops.int_conv2d(hi, q.weights[f"{name}/conv1"],
                                        q.biases[f"{name}/conv1"],
                                        q.specs[f"{name}/conv1"],
                                        stride=stride, apply_relu=True)
            sp = q.specs.get(f"{name}/proj")
            if isinstance(sp, integer_ops.LinearQuantSpec):
                sc = integer_ops.int_conv2d(hi, q.weights[f"{name}/proj"],
                                            q.biases[f"{name}/proj"], sp,
                                            stride=stride)
            else:
                sc = hi
            # conv2 and the Fig. 1(c) residual add + ReLU in one call (on
            # the card one launch: the add is the convolution's epilogue)
            n_a, n_b, n_o = q.specs[f"{name}/add"]
            hi = integer_ops.int_conv2d(h1, q.weights[f"{name}/conv2"],
                                        q.biases[f"{name}/conv2"],
                                        q.specs[f"{name}/conv2"],
                                        residual=(sc, n_a, n_b, n_o))
            n_h = n_o
            bi += 1
    hw = hi.shape[1] * hi.shape[2]
    pooled = qscheme.dequant(hi.to(torch.int32).sum(dim=(1, 2)), n_h) / hw
    pi = ops.quantize_act(pooled, q.specs["head"].n_x, 8)             # K3
    logits_i = integer_ops.int_linear(pi, q.weights["head"],
                                      q.biases["head"], q.specs["head"])
    return qscheme.dequant(logits_i, q.specs["head"].n_o)


def _to_tensor(a: Any, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(dev)


def from_jax_resnet_params(np_tree: dict, *, device: Device = None) -> dict:
    """The JAX package's ResNet param tree (as numpy arrays:
    ``jax.tree.map(np.asarray, params)``) as the port's params on
    ``device`` (default ``cuda``).  Nothing here imports JAX."""
    dev = resolve_device(device)
    return _tree_map(lambda a: _to_tensor(a, dev), np_tree)


def from_jax_quantized_resnet(qr: Any, *, device: Device = None
                              ) -> QuantizedResNet:
    """The JAX package's ``QuantizedResNet`` (codes as numpy-convertible
    arrays, specs as its ``LinearQuantSpec`` or ``(n_a, n_b, n_o)``
    tuples, read by attribute) as the port's, on ``device`` (default
    ``cuda``): the int8 codes stay int8, so both packages run the same
    deploy artifact."""
    dev = resolve_device(device)
    specs = {}
    for name, s in qr.specs.items():
        if isinstance(s, tuple):
            specs[name] = tuple(int(v) for v in s)
        else:
            specs[name] = integer_ops.LinearQuantSpec(
                n_x=int(s.n_x), n_w=int(s.n_w), n_b=int(s.n_b),
                n_o=int(s.n_o), bits=int(s.bits),
                out_unsigned=bool(s.out_unsigned))
    report = calibrate.CalibrationReport()
    for name, r in qr.report.results.items():
        report.add(name, calibrate.CalibResult(
            n_w=r.n_w, n_b=r.n_b, n_o=r.n_o, error=float(r.error),
            fp_norm=float(r.fp_norm), elapsed_s=float(r.elapsed_s)))
    return QuantizedResNet(
        weights={k: _to_tensor(v, dev) for k, v in qr.weights.items()},
        biases={k: _to_tensor(v, dev) for k, v in qr.biases.items()},
        specs=specs, report=report, n_in=int(qr.n_in))
