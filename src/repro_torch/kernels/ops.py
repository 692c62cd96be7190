"""Public wrappers around the hand-written kernels.

Each wrapper takes the kernel's plain PyTorch version (``kernels.ref``)
only because the tensor it was given lies on the CPU; for a CUDA tensor
it launches the CUDA kernel or raises — there is no quiet fallback.  The
TPU package's shape rules (small shapes to the reference, lane-multiple
head dims for the ragged kernel) were TPU layout rules and do not carry
over: on a CUDA tensor the kernel launches for every shape.

``LAUNCHES`` counts kernel launches per kernel, one per launch and
nowhere else, so a run can show that its path went through the kernels.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.integer_ops import LinearQuantSpec
from repro_torch.kernels import ref
from repro_torch.kernels.int8_matmul import int8_matmul_cuda
from repro_torch.kernels.ragged_flash import ragged_attention_cuda

__all__ = ["int8_matmul", "ragged_attention", "LAUNCHES",
           "reset_launch_counts"]

# launches per kernel since the last reset (process-wide, like the
# loaded kernel libraries themselves)
LAUNCHES = {"int8_matmul": 0, "ragged_attention": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(t: torch.Tensor, what: str) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"{what}: no kernel for device {t.device}")


def int8_matmul(x_int: torch.Tensor, w_int: torch.Tensor,
                b_int: Optional[torch.Tensor], spec: LinearQuantSpec,
                *, relu: bool = False) -> torch.Tensor:
    """(..., K) int8 @ (K, N) int8 -> (..., N) int8 with fused requant.

    Leading dims (a ragged (T,) token stream, a (B, S) batch) flatten into
    M.  Shift constants come from ``spec``.  With ``relu`` and
    ``spec.out_unsigned`` the output is uint8 on [0, 2^bits - 1]."""
    *batch, k = x_int.shape
    n = w_int.shape[-1]
    unsigned = relu and spec.out_unsigned
    lo, hi = ((0, (1 << spec.bits) - 1) if unsigned
              else (-(1 << (spec.bits - 1)), (1 << (spec.bits - 1)) - 1))
    out_dtype = torch.uint8 if unsigned else torch.int8
    if not _on_cuda(x_int, "int8_matmul"):
        return ref.int8_matmul_ref(x_int, w_int, b_int,
                                   shift=spec.requant_shift,
                                   bias_shift=spec.bias_shift, relu=relu,
                                   lo=lo, hi=hi, out_dtype=out_dtype)
    m = math.prod(batch)
    if m == 0 or n == 0:
        return torch.empty((*batch, n), dtype=out_dtype, device=x_int.device)
    out = int8_matmul_cuda(x_int.reshape(m, k), w_int, b_int,
                           shift=spec.requant_shift,
                           bias_shift=spec.bias_shift, relu=relu, lo=lo,
                           hi=hi, out_dtype=out_dtype)
    LAUNCHES["int8_matmul"] += 1
    return out.reshape(*batch, n)


def ragged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, block_tables: torch.Tensor,
                     q_start: torch.Tensor, q_len: torch.Tensor,
                     kv_len: torch.Tensor, *,
                     kv_frac_bits: Optional[int] = None) -> torch.Tensor:
    """Unified ragged-batch attention over the paged KV pool.

    q (T, H, Dk) is the flattened mixed stream; ``q_start`` / ``q_len``
    / ``kv_len`` (S,) and ``block_tables`` (S, NBmax) say which rows
    belong to which sequence and how much KV each sees (contract in
    ``kernels.ragged_flash``).  Pools are (NB, bs, KVH, D): int8 Eq.-1
    codes on the 2^-``kv_frac_bits`` grid, or floats.  Scores are scaled
    by 1/sqrt(Dk).  Returns (T, H, Dv) with rows no descriptor covers
    exactly zero."""
    if k_pool.dtype == torch.int8:
        if kv_frac_bits is None:
            raise ValueError("int8 KV codes require kv_frac_bits (the "
                             "cache's static Eq.-1 fractional bit)")
        nkv = int(kv_frac_bits)
    else:
        nkv = 0
    if not _on_cuda(q, "ragged_attention"):
        return ref.ragged_attention_ref(
            q, k_pool, v_pool, block_tables, q_start, q_len, kv_len,
            kv_frac_bits=kv_frac_bits)
    if q.shape[0] == 0 or block_tables.shape[0] == 0:
        return torch.zeros((*q.shape[:2], v_pool.shape[-1]), dtype=q.dtype,
                           device=q.device)
    out = ragged_attention_cuda(q, k_pool, v_pool, block_tables, q_start,
                                q_len, kv_len, kv_frac_bits=nkv)
    LAUNCHES["ragged_attention"] += 1
    return out
