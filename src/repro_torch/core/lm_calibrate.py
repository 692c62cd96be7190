"""Algorithm 1 applied to transformer LMs (PyTorch counterpart of
``repro.core.lm_calibrate``).

1. Run ONE full-precision forward on a single calibration batch with
   activation capture on: every unified module records its (input,
   weight, bias), first occurrence per module name.
2. Per module, in dataflow order: N_x from the Eq. 6 max-window on the
   captured input (or inherited along a threaded edge), then the grid
   search over (N_w, [N_b,] N_o) of ``calibrate_linear_module``.
3. The result is a ``QuantContext`` table driving fake / int execution.

The layers share one module name, hence one set of fractional bits — the
static-shift constraint that keeps the deploy path's requant shifts
constants.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import qmodel
from repro_torch.core.calibrate import (CalibrationReport,
                                        calibrate_linear_module)
from repro_torch.core.qmodel import ModuleBits, QuantContext, QuantMode
from repro_torch.core.qscheme import fake_quant, search_window

__all__ = ["calibrate_lm", "DATAFLOW_CHAIN"]

# The paper's sequential joint scheme along the two range-preserving
# edges of a transformer block: the upstream module's output grid N_o
# becomes the downstream module's input grid N_x.
#   attn/wo <- attn/wv : attention rows are softmax-convex combinations of
#       V rows, so wo's input lives inside wv's output range;
#   mlp/w2 <- mlp/w1   : |silu(g)| <= |g| bounds the gating factor.
# Keys match module-name suffixes.
DATAFLOW_CHAIN = {"attn/wo": "attn/wv", "mlp/w2": "mlp/w1"}

# Eq. 6's window: each search covers [N^max - TAU, N^max]
TAU = 4
# token rows per module the search runs on (every k-th row is taken)
SAMPLE_ROWS = 2048


def _upstream_of(name: str) -> Optional[str]:
    """``name``'s dataflow upstream under :data:`DATAFLOW_CHAIN`."""
    for suffix, up in DATAFLOW_CHAIN.items():
        if name == suffix or name.endswith("/" + suffix):
            return name[: len(name) - len(suffix)] + up
    return None


def calibrate_lm(forward_fn, params, batch
                 ) -> tuple[QuantContext, "CalibrationReport"]:
    """Calibrate every qlinear module of an LM on the context's default
    bit width.

    ``forward_fn(params, batch, ctx)`` runs the model's forward; only the
    capture matters.  Each module's search runs on at most
    :data:`SAMPLE_ROWS` token rows, every k-th (the paper calibrates on
    one image's worth of activations).  A module chained in
    :data:`DATAFLOW_CHAIN` inherits its upstream's N_o as N_x and is
    calibrated on ``fake_quant(x, N_x)``.  An unchained module also
    searches N_x over the Eq. 6 grid and the two finer ones (clipping
    outliers often wins).  Returns a FAKE-mode context and the per-module
    report.
    """
    bits = QuantContext().bits
    with qmodel.capture_activations() as store, torch.no_grad():
        forward_fn(params, batch, QuantContext(mode=QuantMode.FP))

    report = CalibrationReport()
    table: dict[str, ModuleBits] = {}

    def apply(xx, wq, bq):
        y = xx.to(torch.float32) @ wq.to(torch.float32)
        return y + bq.to(torch.float32) if bq is not None else y

    with torch.no_grad():
        for name, (x, w, b) in store.items():
            x = x.reshape(-1, x.shape[-1])
            if x.shape[0] > SAMPLE_ROWS:
                x = x[:: x.shape[0] // SAMPLE_ROWS][:SAMPLE_ROWS]
            o_ref = apply(x, w, b)
            upstream = _upstream_of(name)
            if upstream is not None and upstream in table:
                n_x = table[upstream].n_o
                r = calibrate_linear_module(fake_quant(x, n_x, bits), w, b,
                                            o_ref, apply, bits=bits, tau=TAU)
            else:
                nx_hi = (bits - 1) - search_window(x, 0)[1]
                best = None
                for n_x in (nx_hi, nx_hi + 1, nx_hi + 2):
                    r = calibrate_linear_module(fake_quant(x, n_x, bits), w,
                                                b, o_ref, apply, bits=bits,
                                                tau=TAU)
                    if best is None or r.error < best[1].error:
                        best = (n_x, r)
                n_x, r = best
            report.add(name, r)
            table[name] = ModuleBits(n_x=n_x, n_w=r.n_w, n_b=r.n_b,
                                     n_o=r.n_o)
    return QuantContext(mode=QuantMode.FAKE, bits=bits, table=table), report
