"""Gradient compression (PyTorch counterpart of
``repro.optim.compression``): the paper's power-of-two quantization
reused as a codec for the gradients' all-reduce.  Each leaf's int8 codes
on the finest power-of-two grid covering its max |g| (Eq. 6's
max-heuristic), summed as int32 and shifted back.

``quantize_grads_po2`` / ``dequantize_grads_po2`` work on any tree of the
port's (one grid a leaf: where the reference stacks the layers into one
leaf, the port's per-layer leaves take a grid each).  ``compressed_psum``
is the all-reduce itself over an axis of a (data, model) mesh of ranks
(``launch.mesh``); as in the reference, the train step does not call it.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.qscheme import int_bounds, round_half_away
from repro_torch.core.tree import tree_map

__all__ = ["quantize_grads_po2", "dequantize_grads_po2", "compressed_psum"]


def _leaf_n(g: torch.Tensor, bits: int) -> torch.Tensor:
    """Eq. 6's max-heuristic on the device: the fractional bits of the
    finest power-of-two grid whose range covers max|g| (fp32)."""
    int_bits = torch.ceil(torch.log2(g.float().abs().max() + 1e-12) + 1.0)
    return (bits - 1) - torch.clamp(int_bits, -20.0, 20.0)


def quantize_grads_po2(grads: Any, bits: int = 8) -> tuple[Any, Any]:
    """Per-leaf power-of-two quantization -> (int32 codes in the ``bits``
    range, fractional bits as 0-d fp32 tensors)."""
    lo, hi = int_bounds(bits)
    ns = tree_map(lambda g: _leaf_n(g, bits), grads)
    codes = tree_map(lambda g, n: torch.clamp(
        round_half_away(g.float() * torch.exp2(n)), lo, hi).to(torch.int32),
        grads, ns)
    return codes, ns


def dequantize_grads_po2(codes: Any, ns: Any, count: int = 1) -> Any:
    """``codes * 2^-n / count`` in fp32: the mean gradient after an
    integer sum over ``count`` participants."""
    return tree_map(lambda c, n: c.float() * torch.exp2(-n) / count,
                    codes, ns)


def compressed_psum(grads: Any, axis: str, bits: int = 8, *,
                    mesh=None) -> Any:
    """The all-reduce-mean over the mesh axis ``axis`` with the po2
    payload (the reference's, under ``shard_map``): the grid shared by
    the axis's ranks is the coarsest, the smallest ``n`` (an all-reduce
    max of ``-n``, a scalar a leaf), each rank's codes on it are summed
    as int32 (exact), and the sum is shifted back and divided by the
    count, in each gradient's dtype.  ``mesh``: a ``launch.mesh.
    RankMesh``, default the scope's (``distributed.sharding.
    activation_sharding``)."""
    if mesh is None:
        from repro_torch.distributed.sharding import current_mesh
        mesh = current_mesh()
    if mesh is None:
        raise ValueError("compressed_psum reduces over a mesh's axis: pass "
                         "mesh= or call it inside activation_sharding")
    lo, hi = int_bounds(bits)
    ns = tree_map(lambda g: -mesh.all_reduced(-_leaf_n(g, bits), axis,
                                              "max"), grads)
    codes = tree_map(lambda g, n: mesh.all_reduce(torch.clamp(
        round_half_away(g.float() * torch.exp2(n)), lo, hi
    ).to(torch.int32), axis), grads, ns)
    count = mesh.shape[axis]
    return tree_map(lambda c, n, g: (c.float() * torch.exp2(-n) / count
                                     ).to(g.dtype), codes, ns, grads)
