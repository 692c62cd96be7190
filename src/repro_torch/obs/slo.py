"""SLO objectives + rolling-window burn-rate monitoring (DESIGN §15).

An :class:`SLObjective` is a percentile-style target over one signal:
"``metric`` must stay <= ``target`` for all but ``budget_frac`` of the
observations in the last ``window_s`` seconds".  Two signal families:

* **request** objectives (``metric`` in ``ttft``/``tpot``/``e2e``) are
  fed from the tracer's per-request timelines: each COMPLETED request
  contributes one observation per objective, stamped at its ``done``
  time.  ``target=0.5, budget_frac=0.05`` therefore reads as
  "p95(TTFT) <= 500 ms over the window".
* **gauge** objectives name a registry metric (e.g.
  ``energy.proxy_uj_per_token`` for the Table-5 energy-per-token
  budget, ``pool.utilization`` for a pool-pressure ceiling) and sample
  it once per :meth:`SLOMonitor.evaluate` tick (one tick per engine
  step).  ``None`` samples (metric not yet defined, e.g. no tokens
  emitted) are skipped, not counted against the budget.

**Burn rate** is the standard error-budget derivative:
``burn = (bad / total) / budget_frac`` over the rolling window — 1.0
means violations arrive exactly at the rate that exhausts the budget,
2.0 means twice that.  An alert FIRES when ``burn >=
burn_threshold`` with at least ``min_samples`` observations in the
window, and CLEARS when it drops back below; both transitions append a
structured record to :attr:`SLOMonitor.alerts` and emit a tracer event
(``slo.alert`` / ``slo.recover``, lane ``slo``) so alerts line up with
the dispatch spans that caused them in the Perfetto view.

The monitor is deliberately passive about time: the engine passes
``now`` (its own ``_now()``, real or virtual clock) into
:meth:`evaluate`, so SLO evaluation is deterministic under the flight
recorder's virtual clock (obs/replay.py).

Pure Python (stdlib only).  A copy of ``repro.obs.slo``, held to the
same behaviour by ``tests/test_torch_obs.py``.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Optional

__all__ = ["SLObjective", "SLOMonitor", "REQUEST_METRICS",
           "default_slos"]

# timeline-derived per-request latency signals (Timeline property names)
REQUEST_METRICS = ("ttft", "tpot", "e2e")


@dataclasses.dataclass(frozen=True)
class SLObjective:
    """One objective: ``metric <= target`` for all but ``budget_frac``
    of the observations in a ``window_s`` rolling window."""
    name: str
    metric: str                  # REQUEST_METRICS member or registry name
    target: float
    budget_frac: float = 0.05
    window_s: float = 60.0
    burn_threshold: float = 1.0
    min_samples: int = 1

    def __post_init__(self):
        if not self.name:
            raise ValueError("objective needs a name")
        if not 0.0 < self.budget_frac <= 1.0:
            raise ValueError(f"{self.name}: budget_frac must be in "
                             f"(0, 1], got {self.budget_frac}")
        if self.window_s <= 0.0:
            raise ValueError(f"{self.name}: window_s must be > 0")
        if self.min_samples < 1:
            raise ValueError(f"{self.name}: min_samples must be >= 1")

    @property
    def kind(self) -> str:
        return "request" if self.metric in REQUEST_METRICS else "gauge"


def default_slos(*, ttft_s: Optional[float] = 0.5,
                 e2e_s: Optional[float] = 5.0,
                 tpot_s: Optional[float] = None,
                 energy_uj_per_token: Optional[float] = None,
                 pool_utilization: Optional[float] = 0.98,
                 budget_frac: float = 0.05, window_s: float = 60.0,
                 burn_threshold: float = 1.0,
                 min_samples: int = 1) -> list[SLObjective]:
    """The stock objective set; pass ``None`` to drop one."""
    mk = lambda name, metric, target: SLObjective(  # noqa: E731
        name, metric, target, budget_frac=budget_frac,
        window_s=window_s, burn_threshold=burn_threshold,
        min_samples=min_samples)
    objs = []
    if ttft_s is not None:
        objs.append(mk("ttft", "ttft", ttft_s))
    if tpot_s is not None:
        objs.append(mk("tpot", "tpot", tpot_s))
    if e2e_s is not None:
        objs.append(mk("e2e", "e2e", e2e_s))
    if energy_uj_per_token is not None:
        objs.append(mk("energy_per_token", "energy.proxy_uj_per_token",
                       energy_uj_per_token))
    if pool_utilization is not None:
        objs.append(mk("pool_pressure", "pool.utilization",
                       pool_utilization))
    return objs


class SLOMonitor:
    """Rolling-window burn-rate evaluator over a set of objectives.

    ``tracer`` feeds the request objectives (and receives the alert
    events); ``value_fn(name) -> value`` feeds the gauge objectives
    (the engine binds it to its metrics registry).  Either may be None
    — the corresponding objective family just never observes."""

    def __init__(self, objectives, *, tracer=None,
                 value_fn: Optional[Callable[[str], object]] = None):
        objectives = list(objectives)
        names = [o.name for o in objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names in {names}")
        self.objectives: dict[str, SLObjective] = \
            {o.name: o for o in objectives}
        self.tracer = tracer
        self.value_fn = value_fn
        self._windows: dict[str, deque] = \
            {n: deque() for n in self.objectives}
        self._seen_done: set = set()
        self._active: dict[str, dict] = {}
        self._last_burn: dict[str, Optional[float]] = \
            {n: None for n in self.objectives}
        self.alerts: list[dict] = []
        self.alerts_fired = 0
        self.evaluations = 0

    # -- observation --------------------------------------------------------

    def observe(self, name: str, t: float, value: float) -> None:
        """Record one observation for objective ``name`` at time ``t``
        (monotone per objective) and trim the window."""
        obj = self.objectives[name]
        win = self._windows[name]
        win.append((t, value <= obj.target))
        cutoff = t - obj.window_s
        while win and win[0][0] < cutoff:
            win.popleft()

    def _ingest(self, now: float) -> None:
        req_objs = [o for o in self.objectives.values()
                    if o.kind == "request"]
        if req_objs and self.tracer is not None:
            for rid, tl in self.tracer.timelines.items():
                if tl.done is None or rid in self._seen_done:
                    continue
                self._seen_done.add(rid)
                for obj in req_objs:
                    v = getattr(tl, obj.metric)
                    if v is not None:
                        self.observe(obj.name, tl.done, v)
        if self.value_fn is not None:
            for obj in self.objectives.values():
                if obj.kind != "gauge":
                    continue
                try:
                    v = self.value_fn(obj.metric)
                except KeyError:
                    continue
                if v is None:
                    continue
                self.observe(obj.name, now, float(v))

    # -- burn rate + alerting ----------------------------------------------

    def burn_rate(self, name: str, now: float):
        """(burn, total, bad) over the window ending at ``now``; burn is
        None when the window is empty."""
        obj = self.objectives[name]
        win = self._windows[name]
        cutoff = now - obj.window_s
        while win and win[0][0] < cutoff:
            win.popleft()
        total = len(win)
        if total == 0:
            return None, 0, 0
        bad = sum(1 for _, ok in win if not ok)
        return (bad / total) / obj.budget_frac, total, bad

    def evaluate(self, now: float) -> None:
        """One monitoring tick: ingest new observations, recompute burn
        rates, fire/clear alerts.  The engine calls this once per step."""
        self.evaluations += 1
        self._ingest(now)
        for obj in self.objectives.values():
            burn, total, bad = self.burn_rate(obj.name, now)
            self._last_burn[obj.name] = burn
            firing = (burn is not None and total >= obj.min_samples
                      and burn >= obj.burn_threshold)
            was = obj.name in self._active
            if firing and not was:
                alert = {"objective": obj.name, "metric": obj.metric,
                         "target": obj.target,
                         "burn_rate": round(burn, 4),
                         "window_total": total, "window_bad": bad,
                         "t": now}
                self._active[obj.name] = alert
                self.alerts.append(alert)
                self.alerts_fired += 1
                if self.tracer is not None:
                    self.tracer.event("slo.alert", "slo", ts=now,
                                      args=dict(alert))
            elif was and not firing:
                del self._active[obj.name]
                if self.tracer is not None:
                    self.tracer.event(
                        "slo.recover", "slo", ts=now,
                        args={"objective": obj.name,
                              "burn_rate": None if burn is None
                              else round(burn, 4)})

    # -- views --------------------------------------------------------------

    @property
    def alerts_active(self) -> int:
        return len(self._active)

    def worst_burn_rate(self) -> Optional[float]:
        burns = [b for b in self._last_burn.values() if b is not None]
        return max(burns) if burns else None

    def status(self) -> dict:
        """Per-objective state (the registry's dynamic ``slo.status``)."""
        out = {}
        for name, obj in self.objectives.items():
            burn = self._last_burn[name]
            win = self._windows[name]
            out[name] = {
                "metric": obj.metric, "target": obj.target,
                "budget_frac": obj.budget_frac,
                "window_s": obj.window_s,
                "window_total": len(win),
                "window_bad": sum(1 for _, ok in win if not ok),
                "burn_rate": None if burn is None else round(burn, 4),
                "firing": name in self._active,
            }
        return out

    def reset(self) -> None:
        for win in self._windows.values():
            win.clear()
        self._seen_done.clear()
        self._active.clear()
        self._last_burn = {n: None for n in self.objectives}
        self.alerts.clear()
        self.alerts_fired = 0
        self.evaluations = 0
