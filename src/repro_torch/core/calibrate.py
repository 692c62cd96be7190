"""Algorithm 1 — grid-search calibration of fractional bits, no fine-tuning.

PyTorch counterpart of ``repro.core.calibrate``.  For each unified
module, search (N_w, N_b, N_o) in the narrowed windows
``[N^max - tau, N^max]`` (Eq. 6) minimizing the joint reconstruction error
``|| O - Q(f(X^q, W^q, B^q), N_o) ||_2`` (Eq. 5), where X^q is the input
already quantized on the upstream grid.  The module output depends only on
(N_w, N_b), so the op runs once per (N_w, N_b) cell and every N_o
candidate is swept on that one output.

The search runs on whatever device its tensors lie on (the LM head's grid
search at full width is about a TFLOP of fp32 products).  The squared
errors are summed in float64, so the devices' different summation orders
move an error by far less than the gap between two real candidates; a
near-tie of the products themselves can still pick differently on two
devices.  A residual add (Fig. 1(c)/(d)) and a standalone quant point
have only N_o free: their operand grids come from upstream.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch.core.qscheme import fake_quant, search_window

__all__ = ["CalibResult", "CalibrationReport", "calibrate_linear_module",
           "calibrate_add_module", "calibrate_output_point"]


@dataclasses.dataclass
class CalibResult:
    """Optimal fractional bits for one unified module + its error."""

    n_w: Optional[int]
    n_b: Optional[int]
    n_o: int
    error: float            # the winning ||O - O^q||_2
    fp_norm: float          # ||O||_2, for relative-error reporting
    elapsed_s: float = 0.0

    @property
    def rel_error(self) -> float:
        return self.error / max(self.fp_norm, 1e-12)


@dataclasses.dataclass
class CalibrationReport:
    """Per-module results in dataflow order (Fig. 2 and the quickstart
    read this)."""

    results: dict[str, CalibResult] = dataclasses.field(default_factory=dict)
    total_s: float = 0.0

    def add(self, name: str, r: CalibResult) -> None:
        self.results[name] = r
        self.total_s += r.elapsed_s

    def shift_histogram(self) -> dict[int, int]:
        """Paper Fig. 2(b): distribution of chosen fractional bits."""
        hist: dict[int, int] = {}
        for r in self.results.values():
            for v in (r.n_w, r.n_o):
                if v is not None:
                    hist[v] = hist.get(v, 0) + 1
        return dict(sorted(hist.items()))


def _l2(a: torch.Tensor, b: torch.Tensor) -> float:
    d = (a.to(torch.float32) - b.to(torch.float32)).reshape(-1)
    return float(torch.sqrt(torch.sum(d.to(torch.float64) ** 2)))


def _norm(o_ref: torch.Tensor) -> float:
    return float(torch.sqrt(torch.sum(o_ref.to(torch.float64) ** 2)))


def _sweep_n_o(o_pre: torch.Tensor, o_ref: torch.Tensor, n_o_cands,
               bits: int, unsigned: bool = False) -> list[float]:
    """Errors of requantizing one pre-activation output at each N_o."""
    return [_l2(o_ref, fake_quant(o_pre, n_o, bits, unsigned))
            for n_o in n_o_cands]


def _output_candidates(o_ref: torch.Tensor, bits: int, tau: int) -> list[int]:
    io_lo, io_hi = search_window(o_ref, tau)
    return [(bits - 1) - k for k in range(io_lo, io_hi + 1)]


def calibrate_linear_module(
    x_q: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    o_ref: torch.Tensor,
    apply_fn: Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor]],
                       torch.Tensor],
    *,
    bits: int,
    tau: int,
    out_unsigned: bool = False,
) -> CalibResult:
    """Algorithm 1 for a weight-bearing module.

    ``x_q`` is the module input already fake-quantized on the upstream
    grid; ``w`` / ``b`` the float weight and bias (b may be None);
    ``o_ref`` the float output on x's unquantized ancestor (Eq. 5's O);
    ``apply_fn(x, w_q, b_q)`` the float pre-quantization output, any
    fused nonlinearity included.  ``out_unsigned`` searches the unsigned
    post-ReLU output grid (Fig. 1(b)).  Ties keep the first candidate in
    (N_w, N_b, N_o) order, as the reference.
    """
    t0 = time.perf_counter()
    iw_lo, iw_hi = search_window(w, tau)
    cand_w = [(bits - 1) - i for i in range(iw_lo, iw_hi + 1)]
    if b is not None:
        ib_lo, ib_hi = search_window(b, tau)
        cand_b = [(bits - 1) - i for i in range(ib_lo, ib_hi + 1)]
    else:
        cand_b = [None]
    cand_o = _output_candidates(o_ref, bits, tau)

    best = (None, None, cand_o[0], float("inf"))
    for n_w in cand_w:
        w_q = fake_quant(w, n_w, bits)
        for n_b in cand_b:
            b_q = None if n_b is None else fake_quant(b, n_b, bits)
            o_pre = apply_fn(x_q, w_q, b_q)
            errs = _sweep_n_o(o_pre, o_ref, cand_o, bits, out_unsigned)
            k = min(range(len(errs)), key=errs.__getitem__)
            if errs[k] < best[3]:
                best = (n_w, n_b, cand_o[k], errs[k])
    return CalibResult(n_w=best[0], n_b=best[1], n_o=best[2], error=best[3],
                       fp_norm=_norm(o_ref),
                       elapsed_s=time.perf_counter() - t0)


def calibrate_output_point(
    o_pre: torch.Tensor,
    o_ref: torch.Tensor,
    *,
    bits: int = 8,
    tau: int = 4,
    out_unsigned: bool = False,
) -> CalibResult:
    """A standalone activation quant point: the N_o whose requantization
    of ``o_pre`` lies nearest ``o_ref`` (first on ties)."""
    t0 = time.perf_counter()
    cand_o = _output_candidates(o_ref, bits, tau)
    errs = _sweep_n_o(o_pre, o_ref, cand_o, bits, out_unsigned)
    k = min(range(len(errs)), key=errs.__getitem__)
    return CalibResult(n_w=None, n_b=None, n_o=cand_o[k], error=errs[k],
                       fp_norm=_norm(o_ref),
                       elapsed_s=time.perf_counter() - t0)


def calibrate_add_module(
    a_q: torch.Tensor,
    b_q: torch.Tensor,
    o_ref: torch.Tensor,
    *,
    bits: int = 8,
    tau: int = 4,
    out_unsigned: bool = False,
    apply_relu: bool = False,
) -> CalibResult:
    """Fig. 1(c)/(d): residual add of the operands ``a_q`` / ``b_q``
    (already on their upstream grids), with an optional ReLU; only N_o
    is free."""
    t0 = time.perf_counter()
    o_pre = a_q.to(torch.float32) + b_q.to(torch.float32)
    if apply_relu:
        o_pre = torch.clamp(o_pre, min=0)
    r = calibrate_output_point(o_pre, o_ref, bits=bits, tau=tau,
                               out_unsigned=out_unsigned)
    r.elapsed_s = time.perf_counter() - t0
    return r
