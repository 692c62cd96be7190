"""Profiling + energy hooks for the serving engine (PyTorch counterpart
of ``repro.obs.profile``).

* **`torch.profiler` capture windows** — :meth:`Profiler.capture` wraps a
  run of the engine in ``torch.profiler.profile`` (CPU activity, and the
  CUDA activity when the engine runs on the card) and exports the run as
  a Chrome trace into ``profile_dir``; :meth:`Profiler.step_annotation`
  puts a ``torch.profiler.record_function`` range named
  ``"{dispatch}#{step}"`` around each dispatch, so every kernel a step
  launches is attributed to its step in that trace.
* **Per-compiled-shape cost analysis** (the reference's
  ``profile_cost=True``, XLA's AOT ``cost_analysis``) has no PyTorch
  counterpart and raises ``NotImplementedError``.
* **Energy accounting** — :class:`EnergyAccount` turns the engine's
  Table-5 requant counters into a live energy proxy per token, split by
  phase (prefill / decode / spec-wasted).  The proxy is the Table-5
  bit-shifting energy of the requant ops attributed to each phase (KV
  ops + W8A8 forward boundary ops), and it reconciles *exactly* with the
  engine's hwcost counters: the sum over phases of ``quant_ops`` equals
  ``requant_ops_performed + requant_ops_forward``.

``torch.profiler`` is imported inside the methods that use it: a
disabled Profiler (the default) does nothing at all.
"""
from __future__ import annotations

import contextlib
import os
from typing import Optional

from ..core import hwcost

__all__ = ["Profiler", "EnergyAccount", "ENERGY_PHASES"]

ENERGY_PHASES = ("prefill", "decode", "spec_wasted")

_OFF = contextlib.nullcontext()


class EnergyAccount:
    """Per-phase requant-op ledger → Table-5 energy proxy.

    The engine calls :meth:`charge` at each commit point with the phase,
    the number of requant ops the step executed, and the number of
    useful tokens it produced (the rejected rows for ``spec_wasted`` —
    wasted draft work has energy but no useful tokens, which is why it
    gets its own bucket)."""

    def __init__(self, kind: str = "bit_shifting"):
        if kind not in hwcost.TABLE5:
            raise ValueError(f"unknown Table-5 unit kind {kind!r}")
        self.kind = kind
        self.quant_ops = {p: 0 for p in ENERGY_PHASES}
        self.tokens = {p: 0 for p in ENERGY_PHASES}

    def charge(self, phase: str, quant_ops: int, tokens: int) -> None:
        self.quant_ops[phase] += quant_ops
        self.tokens[phase] += tokens

    def reset(self) -> None:
        for p in ENERGY_PHASES:
            self.quant_ops[p] = 0
            self.tokens[p] = 0

    @property
    def total_quant_ops(self) -> int:
        return sum(self.quant_ops.values())

    def energy_uj(self, phase: str) -> float:
        return hwcost.energy_uj(self.kind, self.quant_ops[phase])

    def uj_per_token(self, phase: str) -> Optional[float]:
        """Energy proxy per USEFUL token of the phase.  ``spec_wasted``
        divides by the *emitted* decode tokens instead — its meaning is
        'wasted energy amortized over what we actually kept'."""
        ops = self.quant_ops[phase]
        toks = self.tokens["decode"] if phase == "spec_wasted" \
            else self.tokens[phase]
        if toks == 0:
            return None if ops == 0 else float("inf")
        return hwcost.energy_uj(self.kind, ops) / toks

    def proxy_uj_per_token(self) -> Optional[float]:
        """The headline live gauge: total requant energy over total
        useful (prefill-fed + decode-emitted) tokens."""
        toks = self.tokens["prefill"] + self.tokens["decode"]
        if toks == 0:
            return None
        return hwcost.energy_uj(self.kind, self.total_quant_ops) / toks

    def report(self) -> dict:
        out: dict = {"unit": self.kind}
        for p in ENERGY_PHASES:
            uj = self.energy_uj(p)
            upt = self.uj_per_token(p)
            out[p] = {
                "quant_ops": self.quant_ops[p],
                "tokens": self.tokens[p],
                "energy_uj": round(uj, 6),
                "uj_per_token": None if upt is None
                else round(upt, 9),
            }
        total = self.proxy_uj_per_token()
        out["total_quant_ops"] = self.total_quant_ops
        out["total_energy_uj"] = round(
            hwcost.energy_uj(self.kind, self.total_quant_ops), 6)
        out["proxy_uj_per_token"] = None if total is None \
            else round(total, 9)
        return out


class Profiler:
    """Optional ``torch.profiler`` wrapper.

    ``profile_dir=None`` (the default) makes every method a no-op; the
    engine constructs one unconditionally so call sites stay
    unconditional too.  ``device_type`` says whether the capture records
    the CUDA activity (``"cuda"``) or the CPU's alone (``"cpu"``).
    ``cost=True`` raises: XLA's per-shape cost analysis has no PyTorch
    counterpart yet."""

    def __init__(self, *, profile_dir: Optional[str] = None,
                 cost: bool = False, device_type: str = "cuda"):
        if cost:
            raise NotImplementedError(
                "profile_cost=True (XLA's AOT cost analysis per compiled "
                "shape) has no PyTorch counterpart in repro_torch yet "
                "(ROADMAP Queue 1 item 8, 'Multi-device and analysis', "
                "with the XLA-HLO tools)")
        self.profile_dir = profile_dir
        self.device_type = device_type
        self.trace_files: list[str] = []
        self.annotated = 0

    @property
    def enabled(self) -> bool:
        return self.profile_dir is not None

    # -- capture windows --------------------------------------------------

    @contextlib.contextmanager
    def capture(self):
        """Wrap a whole engine run in a profiler window; on exit the run
        is exported as ``trace_{n}.json`` (Chrome trace) into
        ``profile_dir``."""
        if self.profile_dir is None:
            yield
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device_type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(self.profile_dir, exist_ok=True)
        with profile(activities=acts) as prof:
            yield
        path = os.path.join(self.profile_dir,
                            f"trace_{len(self.trace_files)}.json")
        prof.export_chrome_trace(path)
        self.trace_files.append(path)

    def step_annotation(self, name: str, step: int):
        """Context manager delimiting one dispatch inside the profiler
        trace (a shared no-op context when profiling is off)."""
        if self.profile_dir is None:
            return _OFF
        from torch.profiler import record_function
        self.annotated += 1
        return record_function(f"{name}#{step}")

    def report(self) -> Optional[dict]:
        """Where the capture went (None when disabled)."""
        if not self.enabled:
            return None
        return {"profile_dir": self.profile_dir,
                "trace_files": list(self.trace_files),
                "annotated_dispatches": self.annotated}

    def reset(self) -> None:
        self.annotated = 0
