"""Public wrappers around the hand-written kernels.

Each wrapper takes the kernel's plain PyTorch version (``kernels.ref``)
only because the tensor it was given lies on the CPU; for a CUDA tensor
it launches the CUDA kernel or raises — there is no quiet fallback.  The
TPU package's shape rules (small shapes to the reference, lane-multiple
head dims for the ragged and flash kernels) were TPU layout rules and do not carry
over: on a CUDA tensor the kernel launches for every shape.

``LAUNCHES`` counts kernel launches per kernel, one per launch and
nowhere else, so a run can show that its path went through the kernels.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.integer_ops import LinearQuantSpec, im2col_same
from repro_torch.core.qscheme import int_bounds
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (flash_decode_cuda,
                                                 flash_prefill_cuda,
                                                 paged_attention_cuda,
                                                 paged_plan_from_positions)
from repro_torch.kernels.int8_matmul import int8_matmul_cuda
from repro_torch.kernels.quantize import quantize_cuda
from repro_torch.kernels.ragged_flash import (RaggedWork,
                                             plan_from_descriptors,
                                             ragged_attention_cuda)
from repro_torch.kernels.residual_requant import residual_requant_cuda

__all__ = ["int8_matmul", "int_conv2d", "quantize_act", "residual_requant",
           "ragged_attention", "paged_attention", "flash_attention",
           "flash_decode", "LAUNCHES", "reset_launch_counts"]

# launches per kernel since the last reset (process-wide, like the
# loaded kernel libraries themselves)
LAUNCHES = {"int8_matmul": 0, "ragged_attention": 0, "paged_attention": 0,
            "flash_prefill": 0, "flash_decode": 0, "quantize": 0,
            "residual_requant": 0}


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
    M.  ``x_int`` may hold uint8 post-ReLU codes.  Shift constants come
    from ``spec``, whose ``bits`` is at most 8.  With ``relu`` and
    ``spec.out_unsigned`` the output is uint8 on [0, 2^bits - 1]."""
    if spec.bits > 8:
        raise ValueError(f"int8_matmul emits 8-bit codes, not {spec.bits}")
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


def int_conv2d(x_int: torch.Tensor, w_int: torch.Tensor,
               b_int: Optional[torch.Tensor], spec: LinearQuantSpec, *,
               stride: int = 1, relu: bool = False) -> torch.Tensor:
    """Integer NHWC x HWIO convolution with XLA's "SAME" padding: the
    im2col gather (plain PyTorch, on the tensor's device) and one K2
    launch over it, the requant epilogue fused.  ``x_int`` holds int8 or
    uint8 codes; returns (B, H', W', Cout) codes as ``int8_matmul``."""
    kh, kw, cin, cout = w_int.shape
    cols, (bsz, ho, wo) = im2col_same(x_int, kh, kw, stride)
    return int8_matmul(cols, w_int.reshape(kh * kw * cin, cout), b_int, spec,
                       relu=relu).reshape(bsz, ho, wo, cout)


def quantize_act(x: torch.Tensor, n: int, bits: int = 8,
                 unsigned: bool = False) -> torch.Tensor:
    """Elementwise Eq.-1 quantization of a float32 / bfloat16 tensor:
    int8 or uint8 codes, int32 when ``bits > 8``."""
    if not _on_cuda(x, "quantize_act"):
        return ref.quantize_ref(x, n=n, bits=bits, unsigned=unsigned)
    lo, hi = int_bounds(bits, unsigned)
    out_dtype = ((torch.uint8 if unsigned else torch.int8) if bits <= 8
                 else torch.int32)
    out = quantize_cuda(x, n=int(n), lo=lo, hi=hi, out_dtype=out_dtype)
    LAUNCHES["quantize"] += 1
    return out


def residual_requant(a_int: torch.Tensor, b_int: torch.Tensor, *, n_a: int,
                     n_b: int, n_o: int, bits: int = 8, relu: bool = False,
                     saturate: bool = False) -> torch.Tensor:
    """Fused Fig. 1(c)/(d) residual add of two int8/uint8 code tensors on
    grids ``n_a`` / ``n_b``, requantized to ``n_o``: uint8 with ``relu``,
    else int8.  A negative requant shift wraps, as the TPU kernel's does,
    or saturates first with ``saturate`` (``integer_ops.int_residual_add``)."""
    if a_int.shape != b_int.shape:
        raise ValueError(f"shape mismatch {tuple(a_int.shape)} + "
                         f"{tuple(b_int.shape)}")
    if not _on_cuda(a_int, "residual_requant"):
        return ref.residual_requant_ref(a_int, b_int, n_a=n_a, n_b=n_b,
                                        n_o=n_o, bits=bits, relu=relu,
                                        saturate=saturate)
    if bits > 8:
        raise ValueError(f"residual_requant emits 8-bit codes, not {bits}")
    n_hi = max(n_a, n_b)
    lo, hi = int_bounds(bits, relu)
    out = residual_requant_cuda(a_int, b_int, sa=n_hi - n_a, sb=n_hi - n_b,
                                shift=n_hi - n_o, relu=relu, lo=lo, hi=hi,
                                saturate=saturate)
    LAUNCHES["residual_requant"] += 1
    return out


def ragged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, block_tables: torch.Tensor,
                     q_start: torch.Tensor, q_len: torch.Tensor,
                     kv_len: torch.Tensor, *,
                     kv_frac_bits: Optional[int] = None,
                     work: Optional[RaggedWork] = None) -> torch.Tensor:
    """Unified ragged-batch attention over the paged KV pool.

    q (T, H, Dk) is the flattened mixed stream; ``q_start`` / ``q_len``
    / ``kv_len`` (S,) and ``block_tables`` (S, NBmax) say which rows
    belong to which sequence and how much KV each sees (contract in
    ``kernels.ragged_flash``).  Pools are (NB, bs, KVH, D): int8 Eq.-1
    codes on the 2^-``kv_frac_bits`` grid, or floats.  Scores are scaled
    by 1/sqrt(Dk).  ``work`` is the kernel's work list for these
    descriptors (``ragged_flash.plan_ragged_work``, on q's device); without
    it one is planned from the descriptors, read back to the host.
    Returns (T, H, Dv) with rows no descriptor covers exactly zero."""
    nkv = ref.kv_frac_bits_of(k_pool, kv_frac_bits)
    if not _on_cuda(q, "ragged_attention"):
        return ref.ragged_attention_ref(
            q, k_pool, v_pool, block_tables, q_start, q_len, kv_len,
            kv_frac_bits=kv_frac_bits)
    if work is None and q.shape[0] and block_tables.shape[0]:
        work = plan_from_descriptors(q_start, q_len, kv_len,
                                     q.shape[1] // k_pool.shape[2], q.device)
    if work is None or work.n_items == 0:
        return torch.zeros((*q.shape[:2], v_pool.shape[-1]), dtype=q.dtype,
                           device=q.device)
    out = ragged_attention_cuda(q, k_pool, v_pool, block_tables, q_start,
                                q_len, kv_len, kv_frac_bits=nkv, work=work)
    LAUNCHES["ragged_attention"] += 1
    return out


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    q_positions: torch.Tensor, *,
                    kv_frac_bits: Optional[int] = None,
                    scale: Optional[float] = None,
                    work: Optional[RaggedWork] = None) -> torch.Tensor:
    """Attention over the serving engine's paged KV block pool (the
    legacy per-shape engine's steps).

    q (B, C, H, Dk): C == 1 is a decode row per slot, C > 1 a prefill
    chunk or a speculative verify chunk.  Pools (NB, bs, KVH, D) hold
    every sequence's blocks, int8 Eq.-1 codes on the 2^-``kv_frac_bits``
    grid or floats; ``block_tables`` (B, W) maps each slot's logical
    blocks to pool blocks (any width: unused tail entries name the trash
    block and are masked); ``q_positions`` (B, C) are the queries'
    absolute positions, and a query attends to kv rows ``<=`` its own.
    Scores are scaled by ``scale`` (default 1/sqrt(Dk)).  ``work`` is
    K4's work list for these positions and this table width
    (``flash_attention.plan_paged_work``, on q's device); without it one
    is planned from the positions, read back to the host.  The CPU path
    takes no plan.  Returns (B, C, H, Dv) in q's dtype."""
    nkv = ref.kv_frac_bits_of(k_pool, kv_frac_bits)
    if not _on_cuda(q, "paged_attention"):
        return ref.paged_attention_ref(q, k_pool, v_pool, block_tables,
                                       q_positions, kv_frac_bits=kv_frac_bits,
                                       scale=scale)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    if work is None:
        work = paged_plan_from_positions(
            q_positions, table_width=block_tables.shape[1],
            block_size=k_pool.shape[1], groups=q.shape[2] // k_pool.shape[2],
            device=q.device)
    out = paged_attention_cuda(q, k_pool, v_pool, block_tables, q_positions,
                               kv_frac_bits=nkv, scale=scale, work=work)
    LAUNCHES["paged_attention"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    kv_frac_bits: Optional[int] = None) -> torch.Tensor:
    """Causal flash attention over a dense cache: q (B, Sq, H, Dk) at
    positions 0..Sq-1 x K/V (B, Skv, KVH, D) -> (B, Sq, H, Dv), scores
    scaled by 1/sqrt(Dk).  K/V may be int8 Eq.-1 codes on the
    2^-``kv_frac_bits`` grid, converted exactly on the card.  Kv rows past
    Sq (an empty cache tail) are masked by causality and never read.

    K5's backward belongs to the training slice: a CUDA ``q`` that
    requires grad raises."""
    nkv = ref.kv_frac_bits_of(k, kv_frac_bits)
    if not _on_cuda(q, "flash_attention"):
        return ref.flash_attention_ref(q, k, v, kv_frac_bits=kv_frac_bits)
    if q.requires_grad:
        raise NotImplementedError(
            "flash_attention on CUDA is forward-only: K5's backward comes "
            "with training (ROADMAP Queue 1 item 7, 'Training and "
            "infrastructure')")
    out = flash_prefill_cuda(q, k, v, kv_frac_bits=nkv)
    LAUNCHES["flash_prefill"] += 1
    return out


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 pos: int, kv_frac_bits: Optional[int] = None
                 ) -> torch.Tensor:
    """One-token decode over a dense cache: q (B, 1, H, Dk) at absolute
    position ``pos`` (a host int) over (B, S_max, KVH, D), kv rows
    ``<= pos`` visible -> (B, 1, H, Dv).  The cache is read in place, up
    to ``pos`` only."""
    nkv = ref.kv_frac_bits_of(k, kv_frac_bits)
    if not _on_cuda(q, "flash_decode"):
        return ref.flash_decode_ref(q, k, v, pos=pos,
                                    kv_frac_bits=kv_frac_bits)
    out = flash_decode_cuda(q, k, v, pos=int(pos), kv_frac_bits=nkv)
    LAUNCHES["flash_decode"] += 1
    return out
