"""Competing quantization mechanisms the paper compares against (a copy
of ``repro.core.baselines`` in PyTorch, held to it bit for bit).

* ``scale_quant``  — arbitrary-float per-tensor scale (TensorRT / IOA
  style): int8 codes + one fp32 multiplier per tensor.  Better range fit
  than power-of-two, but the requant unit needs a 32-bit multiplier
  (Table 5: ~2x the bit-shifter's power/area).
* ``codebook_quant`` — k-means codebook (Deep Compression style): 4-bit
  indices into a 16-entry fp table.  Best compression, but the
  encode/decode unit costs ~15x power (Table 5).

Both reproduce the accuracy columns of Tables 1/3; ``core/hwcost.py``
carries their hardware constants.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["scale_quant", "abs_max", "codebook_quant"]


def scale_quant(x: torch.Tensor, bits: int = 8,
                amax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Symmetric per-tensor float-scale fake quantization: fp32 math, the
    scale clamped at 1e-12, codes rounded half to even (``torch.round``,
    as ``jnp.round``; not Eq. 1's half away from zero), the result in
    ``x``'s dtype.  ``amax`` (fp32, 0-d) stands for ``max|x|`` where ``x``
    is one rank's slice of a tensor cut over a mesh: the all-reduced max
    of the ranks' :func:`abs_max`, so the grid is the whole tensor's.

    The scale is ``max|x|`` times the fp32 reciprocal of ``hi``, as the
    reference computes it wherever it is compiled (its models, under
    ``jit`` and ``scan``): XLA rewrites the division by the constant
    ``hi`` so.  The reference called eagerly divides, and the two differ
    in the scale's last bit on some tensors."""
    hi = 2.0 ** (bits - 1) - 1
    xf = x.to(torch.float32)
    if amax is None:
        amax = abs_max(x)
    scale = torch.clamp(amax * float(np.float32(1.0 / hi)), min=1e-12)
    q = torch.clamp(torch.round(xf / scale), -hi - 1, hi)
    return (q * scale).to(x.dtype)


def abs_max(x: torch.Tensor) -> torch.Tensor:
    """``max|x|`` in fp32 (0-d): :func:`scale_quant`'s statistic."""
    return x.to(torch.float32).abs().max()


def codebook_quant(x: torch.Tensor, bits: int = 4, iters: int = 10,
                   seed: int = 0) -> torch.Tensor:
    """k-means codebook fake quantization (2^bits entries, Lloyd's), in
    numpy on the host as the reference computes it; the result in ``x``'s
    dtype on ``x``'s device.  Deterministic: ``seed`` keeps the
    reference's signature, which draws nothing from it either."""
    flat = x.detach().to(torch.float32).cpu().numpy().ravel()
    k = 1 << bits
    # init centroids at quantiles (stable for heavy-tailed weights)
    centroids = np.quantile(flat, np.linspace(0.01, 0.99, k))
    for _ in range(iters):
        idx = np.argmin(np.abs(flat[:, None] - centroids[None, :]), axis=1)
        for j in range(k):
            sel = flat[idx == j]
            if sel.size:
                centroids[j] = sel.mean()
    idx = np.argmin(np.abs(flat[:, None] - centroids[None, :]), axis=1)
    out = centroids[idx].reshape(tuple(x.shape))
    return torch.from_numpy(out).to(device=x.device, dtype=x.dtype)
