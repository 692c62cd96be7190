"""Fault tolerance: heartbeats, straggler detection, elastic re-meshing,
and a supervising restart loop (a copy of the JAX package's
``repro.distributed.fault_tolerance``, which holds no device code).

The mechanisms run on the host, driven by injectable clocks and failure
events, so every policy is unit-testable on the CPU.  ``launch/train.py``
beats the monitor each step; ``launch/fault_tolerant_train.py`` runs the
restart loop:

  RunSupervisor.run() -> while True:
      restore the latest committed checkpoint (Checkpointer)
      plan a mesh for the CURRENTLY healthy device count (ElasticPlanner)
      train until failure or preemption (HeartbeatMonitor watches steps)
      on failure: drop the lost devices, loop

Straggler mitigation: per-step host timings feed an EWMA; hosts slower than
``straggler_factor`` x the p50 for ``patience`` consecutive steps are
reported.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

__all__ = ["HeartbeatMonitor", "ElasticPlanner", "RunSupervisor",
           "MeshPlan"]


@dataclasses.dataclass
class HostStat:
    ewma: float = 0.0
    slow_streak: int = 0
    alive: bool = True
    last_beat: Optional[float] = None  # None until the first beat


class HeartbeatMonitor:
    """Tracks per-host step durations and liveness."""

    def __init__(self, n_hosts: int, timeout_s: float = 60.0,
                 straggler_factor: float = 1.5, patience: int = 5,
                 clock: Callable[[], float] = time.monotonic):
        self.stats = [HostStat() for _ in range(n_hosts)]
        self.timeout_s = timeout_s
        self.straggler_factor = straggler_factor
        self.patience = patience
        self.clock = clock

    def beat(self, host: int, step_s: float) -> None:
        st = self.stats[host]
        st.ewma = step_s if st.ewma == 0 else 0.8 * st.ewma + 0.2 * step_s
        st.last_beat = self.clock()

    def _p50(self) -> float:
        vals = sorted(s.ewma for s in self.stats if s.alive and s.ewma > 0)
        return vals[len(vals) // 2] if vals else 0.0

    def check(self) -> dict:
        """Returns {'dead': [...], 'stragglers': [...]} and updates streaks."""
        now = self.clock()
        dead, stragglers = [], []
        p50 = self._p50()
        for i, st in enumerate(self.stats):
            if not st.alive:
                continue
            if st.last_beat is not None and now - st.last_beat > self.timeout_s:
                st.alive = False
                dead.append(i)
                continue
            if p50 > 0 and st.ewma > self.straggler_factor * p50:
                st.slow_streak += 1
                if st.slow_streak >= self.patience:
                    stragglers.append(i)
            else:
                st.slow_streak = 0
        return {"dead": dead, "stragglers": stragglers}

    def mark_dead(self, host: int) -> None:
        self.stats[host].alive = False

    def alive_count(self) -> int:
        return sum(s.alive for s in self.stats)


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple
    axes: tuple
    n_devices: int
    dropped: int       # devices idled to make a rectangular mesh


class ElasticPlanner:
    """Chooses the largest valid mesh for the surviving device count.

    Policy: keep the model axis FIXED (TP degree is baked into layer sizes
    and checkpoint layout); shrink the data axis to the largest value such
    that data*model <= devices; idle the remainder.  Re-sharding after a
    plan change is checkpoint-reload (params are data-replicated, so only
    the batch split changes) — the cheapest correct elastic step.
    """

    def __init__(self, model_axis: int, pod_size: Optional[int] = None):
        self.model_axis = model_axis
        self.pod_size = pod_size

    def plan(self, n_devices: int) -> MeshPlan:
        if n_devices < self.model_axis:
            raise RuntimeError(
                f"{n_devices} devices cannot host model axis "
                f"{self.model_axis} — unrecoverable without re-sharding "
                f"checkpoints to a smaller TP degree")
        data = n_devices // self.model_axis
        if self.pod_size and n_devices > self.pod_size:
            pods = n_devices // self.pod_size
            data_per_pod = self.pod_size // self.model_axis
            used = pods * data_per_pod * self.model_axis
            return MeshPlan(shape=(pods, data_per_pod, self.model_axis),
                            axes=("pod", "data", "model"),
                            n_devices=used, dropped=n_devices - used)
        used = data * self.model_axis
        return MeshPlan(shape=(data, self.model_axis),
                        axes=("data", "model"),
                        n_devices=used, dropped=n_devices - used)


class RunSupervisor:
    """Restart loop: run -> fail -> restore -> re-mesh -> continue.

    ``train_segment(plan, start_step) -> (last_step, failure | None)`` is the
    injectable work function (launch/train.py provides the real one; tests
    provide failure-injecting fakes).
    """

    def __init__(self, planner: ElasticPlanner, checkpointer,
                 train_segment: Callable, max_restarts: int = 100):
        self.planner = planner
        self.ckpt = checkpointer
        self.train_segment = train_segment
        self.max_restarts = max_restarts
        self.restarts = 0
        self.history: list[dict] = []

    def run(self, n_devices: int, total_steps: int) -> int:
        step = self.ckpt.latest_step() or 0
        devices = n_devices
        while step < total_steps:
            plan = self.planner.plan(devices)
            last_step, failure = self.train_segment(plan, step, total_steps)
            self.history.append({"from": step, "to": last_step,
                                 "devices": plan.n_devices,
                                 "failure": failure})
            step = last_step
            if failure is None:
                break
            self.restarts += 1
            if self.restarts > self.max_restarts:
                raise RuntimeError("restart budget exhausted")
            devices -= failure.get("lost_devices", 0)
            # resume from the last COMMITTED step, not the crashed one
            step = self.ckpt.latest_step() or 0
        return step
