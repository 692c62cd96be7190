"""One reckoning of each hand-written kernel's work: ``(flops, bytes)``.

Each function takes its kernel wrapper's arguments (``kernels.ops``) and
returns the operations the kernel does on these inputs and the bytes it
must move: each input read once, each output written once.  The same
reckoning gives ``chip_smoke.py``'s bound column (PERF.md §6), so a bound
in that table and a kernel's charge in the dry run
(``launch.dryrun``) or the engine's cost analysis (``obs.profile``) are
one number.  An attention's operations are its QK and PV
multiply-adds (two operations each) over the (query, kv row) pairs it
must score; a requant epilogue or an elementwise kernel counts the
operations its arithmetic does per element.

Where the work depends on the data (the kv rows a ragged step's
sequences see, K6's position, the experts' row counts), the reckoning
reads those values, back to the host, as the bound does.  A tensor on
the ``meta`` device has no values: there the reckoning takes the most its
shapes allow (every row real, every table full, K6 at the cache's last
row, every expert full), which is what a decode cell at ``seq_len`` and
the reference's fixed-shape MoE program do.

The counter hook: ``analysis.CostMode`` registers itself here while it
is active (:func:`active`); each kernel wrapper charges its reckoning to
it once per call (:func:`counted`), with the wrapper's own aten ops (the
plain version's on the CPU and ``meta``, the launcher's allocations on
the card) left uncounted.  ``launch.mesh.RankMesh`` notes each collective
it makes here too (:func:`note_collective`).  Nothing here imports the
counter: with none active a wrapper runs as it did.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Callable, Optional

import torch

__all__ = ["ragged_attention", "paged_attention", "flash_attention",
           "flash_decode", "int8_matmul", "int8_matmul_partial",
           "int8_matmul_finish", "int8_matmul_grouped",
           "int8_matmul_grouped_partial", "quantize_act", "quantize_multi",
           "quantize_scatter", "residual_requant", "int_conv2d",
           "active", "counted", "uncounted", "note_collective"]

# operations per element: K3's Eq.-1 (scale, round, clip: 4 a grid), K7's
# grid alignment, add, ReLU, shift and clip (10)
QUANT_OPS, RESIDUAL_OPS = 4, 10


def _nbytes(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def _host(t: torch.Tensor) -> Optional[torch.Tensor]:
    """``t``'s values on the host, or None on the meta device."""
    return None if t.device.type == "meta" else t.detach().cpu()


def _dims(q, k, v):
    return q.shape[-1], v.shape[-1], k.element_size()


# ---------------------------------------------------------------------------
# attention: K1, K4, K5, K6
# ---------------------------------------------------------------------------

def ragged_attention(q, k_pool, v_pool, block_tables, q_start, q_len, kv_len,
                     **_):
    """K1: q (T, H, Dk) in and out (Dv), the kv rows each sequence's last
    token sees, the descriptors and tables; QK and PV over each token's
    causal rows.  On meta: every stream row real, every table full."""
    t, h = q.shape[0], q.shape[1]
    dk, dv, kv_el = _dims(q, k_pool, v_pool)
    kvh, bs = k_pool.shape[2], k_pool.shape[1]
    ql, kl = _host(q_len), _host(kv_len)
    if ql is None or kl is None:
        t_real, full = t, block_tables.shape[1] * bs
        kv_rows, pairs = block_tables.shape[0] * full, t * full
    else:
        items = list(zip(ql.tolist(), kl.tolist()))
        t_real = sum(a for a, _ in items)
        kv_rows = sum(b for _, b in items)
        pairs = sum(a * (b - a) + a * (a + 1) // 2 for a, b in items)
    n_bytes = (t_real * h * (dk + dv) * q.element_size()
               + kv_rows * kvh * (dk + dv) * kv_el + _nbytes(block_tables)
               + _nbytes(q_start) + _nbytes(q_len) + _nbytes(kv_len))
    return pairs * h * 2 * (dk + dv), n_bytes


def paged_attention(q, k_pool, v_pool, block_tables, q_positions, **_):
    """K4: q (B, C, H, Dk) in and out, each slot's kv rows up to its last
    query's position (within its table), the tables and positions; QK and
    PV over each query's rows.  On meta: every table full."""
    b, c, h = q.shape[0], q.shape[1], q.shape[2]
    dk, dv, kv_el = _dims(q, k_pool, v_pool)
    kvh = k_pool.shape[2]
    last = block_tables.shape[1] * k_pool.shape[1] - 1
    pos = _host(q_positions)
    if pos is None:
        seen, pairs = b * (last + 1), b * c * (last + 1)
    else:
        pos = pos.to(torch.int64).clamp(max=last)
        seen = int((pos.max(dim=1).values + 1).sum())
        pairs = int((pos + 1).sum())
    n_bytes = (b * c * h * (dk + dv) * q.element_size()
               + seen * kvh * (dk + dv) * kv_el + _nbytes(block_tables)
               + _nbytes(q_positions))
    return pairs * h * 2 * (dk + dv), n_bytes


def _causal_pairs(sq: int, skv: int) -> int:
    """sum over i < sq of min(i + 1, skv)."""
    if sq <= skv:
        return sq * (sq + 1) // 2
    return skv * (skv + 1) // 2 + (sq - skv) * skv


def flash_attention(q, k, v, *, causal: bool = True, **_):
    """K5: q (B, Sq, H, Dk) in, (B, Sq, H, Dv) out; causal: the kv rows
    below Sq (an empty cache tail is never read) and each query's rows up
    to its own; non-causal: every kv row, every query over all of them."""
    b, sq, h = q.shape[0], q.shape[1], q.shape[2]
    skv, kvh = k.shape[1], k.shape[2]
    dk, dv, kv_el = _dims(q, k, v)
    rows = min(sq, skv) if causal else skv
    pairs = _causal_pairs(sq, skv) if causal else sq * skv
    n_bytes = ((q.numel() + b * sq * h * dv) * q.element_size()
               + b * rows * kvh * (dk + dv) * kv_el)
    return b * h * 2 * (dk + dv) * pairs, n_bytes


def flash_decode(q, k, v, *, pos, **_):
    """K6: q (B, 1, H, Dk) in and out, the cache's rows up to ``pos`` (the
    rows the live splits of its plan read), one query over each.  A
    position on the meta device counts the cache's last row."""
    b, h = q.shape[0], q.shape[2]
    s_max, kvh = k.shape[1], k.shape[2]
    dk, dv, kv_el = _dims(q, k, v)
    if isinstance(pos, torch.Tensor):
        host = _host(pos)
        p = s_max - 1 if host is None else int(host)
    else:
        p = int(pos)
    rows = min(p, s_max - 1) + 1
    n_bytes = ((q.numel() + b * h * dv) * q.element_size()
               + b * rows * kvh * (dk + dv) * kv_el)
    return b * h * 2 * (dk + dv) * rows, n_bytes


# ---------------------------------------------------------------------------
# K2 and its forms
# ---------------------------------------------------------------------------

def _out_size(out_float) -> int:
    """Bytes an output element: a code, or its float value."""
    return 1 if out_float is None else torch.empty(
        (), dtype=out_float).element_size()


def int8_matmul(x_int, w_int, b_int, spec, *, relu=False, out_float=None):
    """K2: (M, K) codes and the (K, N) weight codes in, the bias, (M, N)
    codes or float values out; 2 M K N operations."""
    k, n = x_int.shape[-1], w_int.shape[-1]
    m = math.prod(x_int.shape[:-1])
    n_bytes = (m * k * x_int.element_size() + _nbytes(w_int) + _nbytes(b_int)
               + m * n * _out_size(out_float))
    return 2 * m * k * n, n_bytes


def int8_matmul_partial(x_int, w_int):
    """K2's rank-split first pass: the product's int32 sums out."""
    k, n = x_int.shape[-1], w_int.shape[-1]
    m = math.prod(x_int.shape[:-1])
    return 2 * m * k * n, (m * k * x_int.element_size() + _nbytes(w_int)
                           + 4 * m * n)


def int8_matmul_finish(acc, b_int, spec, *, relu=False, out_float=None):
    """K2's rank-split finish: the int32 sums in, the epilogue's output
    out; two operations an element (bias, shift)."""
    mn = acc.numel()
    return 2 * mn, (4 * mn + _nbytes(b_int)
                    + mn * _out_size(out_float))


def _grouped(x_int, w_int, counts, rows_cap, out_size: int):
    e, c, k = x_int.shape
    n = w_int.shape[-1]
    segs = counts.shape[1] if counts.ndim == 2 else 1
    cap = c // segs if rows_cap is None else int(rows_cap)
    cap = min(cap, c // segs)
    host = _host(counts)
    if host is None:
        rows, active = e * segs * cap, e
    else:
        per = host.to(torch.int64).reshape(e, segs).clamp(max=cap).sum(1)
        rows, active = int(per.sum()), int((per > 0).sum())
    n_bytes = (active * k * n * w_int.element_size()
               + rows * k * x_int.element_size() + rows * n * out_size)
    return 2 * rows * k * n, n_bytes


def int8_matmul_grouped(x_int, w_int, counts, spec, *, rows_cap=None,
                        out_float=None):
    """K2's grouped form: the live rows (each expert's, or each segment's,
    up to ``rows_cap``) in and out, the weights of the experts that have
    any; 2 rows K N operations.  On meta every expert full."""
    return _grouped(x_int, w_int, counts, rows_cap,
                    _out_size(out_float))


def int8_matmul_grouped_partial(x_int, w_int, counts, *, rows_cap=None):
    """K2's grouped form with the int32 output kind."""
    return _grouped(x_int, w_int, counts, rows_cap, 4)


# ---------------------------------------------------------------------------
# K3, K7, the convolution kernel
# ---------------------------------------------------------------------------

def quantize_act(x, n, bits=8, unsigned=False):
    """K3, one grid: x in, its codes out."""
    return QUANT_OPS * x.numel(), _nbytes(x) + x.numel() * (
        1 if bits <= 8 else 4)


def quantize_multi(x, ns, bits=8):
    """K3's multi-grid form: x read once, one codes tensor a distinct
    grid."""
    g = len(set(int(n) for n in ns))
    return QUANT_OPS * g * x.numel(), _nbytes(x) + g * x.numel()


def quantize_scatter(k, v, index, k_rows, v_rows, *, n):
    """K3's quantize-and-scatter form: K and V rows in, their codes out to
    the pool rows, the row index."""
    el = k.numel() + v.numel()
    return QUANT_OPS * el, _nbytes(k) + _nbytes(v) + el + _nbytes(index)


def residual_requant(a_int, b_int, **_):
    """K7: two code tensors in, one out."""
    return RESIDUAL_OPS * a_int.numel(), (_nbytes(a_int) + _nbytes(b_int)
                                          + a_int.numel())


def int_conv2d(x_int, w_int, b_int, spec, *, stride=1, relu=False,
               residual=None):
    """The convolution kernel (NHWC x HWIO, "SAME"): the input, weights
    and bias in, the (B, H', W', Cout) codes out, and with ``residual``
    the shortcut's codes in too; 2 M K Cout operations (M = B H' W',
    K = kh kw Cin)."""
    bsz, h, w, cin = x_int.shape
    kh, kw, _, cout = w_int.shape
    m = bsz * (-(-h // stride)) * (-(-w // stride))
    n_bytes = (_nbytes(x_int) + _nbytes(w_int) + _nbytes(b_int)
               + m * cout * (1 if residual is None else 2))
    return 2 * m * kh * kw * cin * cout, n_bytes


# ---------------------------------------------------------------------------
# the counter hook
# ---------------------------------------------------------------------------

_ACTIVE: list = []          # the active counters, innermost last


def active():
    """The innermost active counter (``analysis.CostMode``), or None."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def uncounted():
    """Run the body with the active counter (if any) paused: its aten ops
    add nothing (communication staging, a stand-in's fill)."""
    counter = active()
    if counter is None:
        yield
        return
    with counter.paused():
        yield


def counted(name: str, reckoning: Callable):
    """A kernel wrapper that charges ``reckoning(*args, **kwargs)`` to the
    active counter once a call, as ``name``, with its own aten ops paused
    (a wrapper called inside another's pause charges nothing: the outer
    one did)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            counter = active()
            if counter is None or counter.is_paused:
                return fn(*args, **kwargs)
            with counter.paused():
                out = fn(*args, **kwargs)
                flops, n_bytes = reckoning(*args, **kwargs)
            counter.charge(name, flops, n_bytes, out)
            return out
        return wrapper
    return deco


def note_collective(kind: str, result_bytes: int, group: int,
                    link: str) -> None:
    """A collective a mesh made: its kind (``all-reduce``, ``all-gather``,
    ``reduce-scatter``), the bytes of its result, its group's size and
    the slowest link the group crosses (``nvlink`` or ``network``)."""
    counter = active()
    if counter is not None:
        counter.collective(kind, result_bytes, group, link)
