#!/usr/bin/env python3
"""Which fp32 summation order reproduces the JAX package's rms statistic?

The reference (``repro.models.common.rmsnorm``) takes the mean square as an
fp32 ``einsum("...d,...d->...")`` and then ``lax.rsqrt``; the PyTorch port
(``repro_torch.models.common.inv_rms``) evaluates it in float64 and rounds
once.  This diagnostic jits the reference's statistic with XLA on the CPU
and prints, for 256 random rows at each width, the share of rows on which
each candidate order gives other bits:

* the port's float64 value rounded once (computed here in numpy);
* sequential fp32 sums, with and without fused multiply-adds;
* numpy's pairwise fp32 sum;
* XLA's own sum followed by a correctly rounded rsqrt (how much of the
  difference is the rsqrt alone);
* at width 2048, lane-and-accumulator orders: L lanes (element i in lane
  i mod L) times A accumulators (block i // L mod A), each summed
  sequentially with or without FMA, then combined as a tree or in order.

It also prints the share of rows on which the sequential FMA sum equals
XLA's sum before the rsqrt.  Run from the repository root (JAX on the
CPU):

    JAX_PLATFORMS=cpu python3 tools/rms_order_survey.py
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np

EPS = 1e-6
F32 = np.float32


@jax.jit
def _xla_sum(x):
    return jnp.einsum("...d,...d->...", x, x,
                      preferred_element_type=jnp.float32)


@jax.jit
def _xla_inv_rms(x):
    return jax.lax.rsqrt(_xla_sum(x) / x.shape[-1] + EPS)


def _rows(d, seed=0, n=256):
    rng = np.random.default_rng(seed + d)
    return (rng.standard_normal((n, d))
            * rng.uniform(0.01, 30, (n, 1))).astype(F32)


def _sq_add(acc, c, fma):
    """``acc + c*c`` in fp32: one rounding with FMA, two without."""
    if fma:
        return (c.astype(np.float64) ** 2 + acc).astype(F32)
    return (acc + c * c).astype(F32)


def _sequential(x, fma):
    acc = np.zeros(x.shape[:-1], F32)
    for i in range(x.shape[-1]):
        acc = _sq_add(acc, x[..., i], fma)
    return acc


def _combine(parts, tree):
    """fp32 sum of ``parts`` (..., k) as a pairwise tree or in order."""
    if not tree:
        acc = parts[..., 0]
        for j in range(1, parts.shape[-1]):
            acc = (acc + parts[..., j]).astype(F32)
        return acc
    while parts.shape[-1] > 1:
        if parts.shape[-1] % 2:
            parts = np.concatenate([parts, np.zeros_like(parts[..., :1])], -1)
        parts = (parts[..., 0::2] + parts[..., 1::2]).astype(F32)
    return parts[..., 0]


def _lanes(x, lanes, accs, fma, tree):
    n, d = x.shape
    acc = np.zeros((n, accs, lanes), F32)
    for blk in range(d // lanes):
        a = blk % accs
        acc[:, a] = _sq_add(acc[:, a], x[:, blk * lanes:(blk + 1) * lanes],
                            fma)
    per_acc = _combine(acc, tree)          # lanes of each accumulator
    return _combine(per_acc, tree)


def _inv_rms(s, d):
    """A correctly rounded fp32 rsqrt of the fp32 mean square ``s / d``."""
    ms = ((s / F32(d)).astype(F32) + F32(EPS)).astype(np.float64)
    return (1.0 / np.sqrt(ms)).astype(F32)


def _port(x):
    x64 = x.astype(np.float64)
    return (1.0 / np.sqrt((x64 * x64).sum(-1) / x.shape[-1] + EPS)
            ).astype(F32)


def main():
    for d in (16, 64, 128, 2048):
        x = _rows(d)
        ref = np.asarray(_xla_inv_rms(jnp.asarray(x)))
        xla_sum = np.asarray(_xla_sum(jnp.asarray(x)))
        cands = {
            "port (float64, rounded once)": _port(x),
            "sequential fp32 sum": _inv_rms(_sequential(x, False), d),
            "sequential FMA sum": _inv_rms(_sequential(x, True), d),
            "pairwise fp32 sum (numpy)": _inv_rms(
                (x * x).sum(-1, dtype=F32), d),
            "XLA's own sum, exact rsqrt": _inv_rms(xla_sum, d),
        }
        print(f"width {d}: rows differing from the reference's inv_rms: "
              + "; ".join(f"{k} {float((v != ref).mean()):.3f}"
                          for k, v in cands.items()))
        print(f"width {d}: rows whose sequential FMA sum equals XLA's sum: "
              f"{float((_sequential(x, True) == xla_sum).mean()):.3f}")
        if d != 2048:
            continue
        best = None
        for lanes, accs, fma, tree in itertools.product(
                (4, 8, 16), (1, 2, 4, 8), (False, True), (False, True)):
            s = _lanes(x, lanes, accs, fma, tree)
            rate = float((s != xla_sum).mean())
            if best is None or rate < best[0]:
                best = (rate, lanes, accs, fma, tree)
        print(f"width {d}: lane orders (4/8/16 lanes x 1/2/4/8 accumulators, "
              f"FMA or not, tree or in-order combine): the closest sum, "
              f"{best[1]} lanes x {best[2]} accumulators, FMA {best[3]}, "
              f"tree {best[4]}, differs from XLA's on {best[0]:.3f} of rows")


if __name__ == "__main__":
    main()
