"""Unified metrics registry for the serving stack (DESIGN §14).

One process-local registry of TYPED, DOCUMENTED metrics replaces the
ad-hoc counter attributes and hand-rolled report dicts that grew across
PRs 3–7: every scalar the engine reports is declared exactly once, with
a kind (counter / gauge / histogram), a python type and a help string,
and ``engine.report()`` becomes a *view* of the registry
(:meth:`MetricsRegistry.nested`) instead of a dict assembled by hand —
so renames break the golden-schema test (``tests/test_obs.py``), not a
downstream bench gate three PRs later.

Two metric flavors:

* **Owned** (:class:`Counter`, :class:`Gauge`, :class:`Histogram`) hold
  their own value; hot-path increments are one dict-free attribute add.
* **Bound** (:class:`FuncMetric`) read an EXISTING source at snapshot
  time through a zero-argument callable.  This is how ``PoolStats``,
  ``CacheStats``, the spec-decode acceptance counters and the hwcost
  requant accounting migrate onto the registry without perturbing the
  jax-free host structs the property tests drive directly: the structs
  stay the single source of truth, the registry is the single source of
  *naming, typing and exposition*.  A bound metric may declare
  ``alias_of`` — e.g. ``speculative.retracts`` aliases
  ``pool.retracts`` — so duplicated report fields are documented as
  views of one canonical counter and can never silently diverge.

Exposition: :meth:`MetricsRegistry.snapshot` (flat JSON-able dict),
:meth:`MetricsRegistry.nested` (report-shaped, split on ``.``) and
:meth:`MetricsRegistry.to_prometheus` (text format 0.0.4: ``# HELP`` /
``# TYPE`` pairs, dots mapped to underscores, labeled series as
``name{label="value"}``).

Pure Python (stdlib only) — importable from the host modules
(`kv_pool`, `scheduler`, `prefix_cache`) and cheap enough to leave on.
A copy of ``repro.obs.metrics``: the port keeps its own and imports
nothing of the JAX package (``tests/test_torch_obs.py`` holds the two
copies to the same behaviour).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Optional

__all__ = ["Counter", "Gauge", "Histogram", "FuncMetric",
           "MetricsRegistry", "prom_name"]

_KINDS = ("counter", "gauge", "histogram")


def prom_name(name: str) -> str:
    """Prometheus-legal metric name: dots (the registry's nesting
    separator) become underscores; anything else non-alphanumeric too."""
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def _escape_help(s: str) -> str:
    """HELP-line escaping per exposition format 0.0.4: backslash and
    newline only (double quotes are legal in help text)."""
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label_value(s: str) -> str:
    """Label-value escaping per exposition format 0.0.4: backslash,
    double quote and newline."""
    return (s.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


class _Metric:
    """Common shape: identity + documentation.  ``typ`` is the python
    type of the snapshot value (int/float/bool/str); ``optional`` marks
    metrics whose value may legitimately be None (e.g. a percentile of
    an empty sample set)."""

    kind = "gauge"

    def __init__(self, name: str, help: str, *, typ: type = float,
                 unit: str = "", optional: bool = False,
                 alias_of: Optional[str] = None):
        if not name:
            raise ValueError("metric needs a name")
        if not help:
            raise ValueError(f"metric {name!r} needs a help string — "
                             f"undocumented metrics are what this "
                             f"registry exists to prevent")
        self.name = name
        self.help = help
        self.typ = typ
        self.unit = unit
        self.optional = optional
        self.alias_of = alias_of

    def value(self) -> Any:                      # pragma: no cover
        raise NotImplementedError

    def reset(self) -> None:
        pass

    def describe(self) -> dict:
        d = {"kind": self.kind, "type": self.typ.__name__,
             "help": self.help}
        if self.unit:
            d["unit"] = self.unit
        if self.optional:
            d["optional"] = True
        if self.alias_of:
            d["alias_of"] = self.alias_of
        return d


class Counter(_Metric):
    """Monotonic counter, optionally labeled.

    Unlabeled: ``c.inc(3)``; labeled (``label_names=("phase",)``):
    ``c.inc(3, phase="prefill")``.  ``value()`` returns the int total
    for unlabeled counters and a {label-string: int} dict otherwise
    (label series also expose individually in the prometheus text)."""

    kind = "counter"

    def __init__(self, name: str, help: str, *, label_names=(), typ=int,
                 **kw):
        super().__init__(name, help, typ=typ, **kw)
        self.label_names = tuple(label_names)
        self._total = 0
        self._series: dict[tuple, int] = {}

    def inc(self, n: int = 1, **labels) -> None:
        self._total += n
        if self.label_names:
            key = tuple(labels[k] for k in self.label_names)
            self._series[key] = self._series.get(key, 0) + n

    def get(self, **labels) -> int:
        if not labels:
            return self._total
        return self._series.get(
            tuple(labels[k] for k in self.label_names), 0)

    def value(self):
        if not self.label_names:
            return self._total
        return {",".join(f"{k}={v}" for k, v in zip(self.label_names,
                                                    key)): n
                for key, n in sorted(self._series.items())}

    def reset(self) -> None:
        self._total = 0
        self._series.clear()


class Gauge(_Metric):
    """Set-to-current-value metric (``g.set(v)``, ``g.add(dv)``)."""

    kind = "gauge"

    def __init__(self, name: str, help: str, **kw):
        super().__init__(name, help, **kw)
        self._v: Any = 0

    def set(self, v) -> None:
        self._v = v

    def add(self, dv) -> None:
        self._v += dv

    def value(self):
        return self._v

    def reset(self) -> None:
        self._v = 0


class Histogram(_Metric):
    """Fixed-bucket histogram (prometheus-style cumulative ``le``
    buckets) that ALSO keeps exact percentiles cheap: observations are
    O(1) (bucket increment + sum), and ``percentile`` answers from the
    bucket upper bounds — good enough for step-time monitoring, while
    the trace timelines (obs/trace.py) keep the exact values for the
    report's latency percentiles."""

    kind = "histogram"

    def __init__(self, name: str, help: str, *, buckets, **kw):
        super().__init__(name, help, typ=dict, **kw)
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError(f"histogram {name!r} needs buckets")
        self.buckets = bs + [math.inf]
        self.counts = [0] * len(self.buckets)
        self.sum = 0.0
        self.n = 0

    def observe(self, v: float) -> None:
        self.sum += v
        self.n += 1
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                self.counts[i] += 1
                return

    def percentile(self, q: float):
        """Upper bound of the bucket holding the q-th percentile sample
        (None when empty).  An UPPER bound, never an interpolation —
        monitoring must not under-report tails.

        Contract (vs ``obs.trace.Tracer.derive_latencies``): a
        histogram forgets the samples, so this is bucket-bound — the
        error vs the exact rank statistic is non-negative and at most
        the width of the bucket the sample landed in.  The trace
        timelines keep exact samples and the report's ``timeline``
        percentiles use THOSE; the two must not be conflated (pinned by
        ``tests/test_obs.py::
        test_histogram_percentile_vs_exact_error_bound``)."""
        if self.n == 0:
            return None
        rank = max(1, math.ceil(q / 100.0 * self.n))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return self.buckets[i]
        return self.buckets[-1]               # pragma: no cover

    def value(self):
        return {"count": self.n, "sum": round(self.sum, 6),
                "buckets": {("+Inf" if math.isinf(ub) else repr(ub)): c
                            for ub, c in zip(self.buckets, self.counts)}}

    def reset(self) -> None:
        self.counts = [0] * len(self.buckets)
        self.sum = 0.0
        self.n = 0


class FuncMetric(_Metric):
    """Registry-bound view of an external source: ``fn`` is evaluated at
    snapshot time.  ``kind`` says how the value behaves over time
    (counter vs gauge) for the prometheus exposition."""

    def __init__(self, name: str, help: str, fn: Callable[[], Any], *,
                 kind: str = "gauge", **kw):
        super().__init__(name, help, **kw)
        if kind not in _KINDS:
            raise ValueError(f"unknown metric kind {kind!r}")
        self.kind = kind
        self.fn = fn

    def value(self):
        return self.fn()


class MetricsRegistry:
    """Ordered registry of uniquely named metrics.

    Registration order is report order: :meth:`nested` builds the
    report dict by splitting names on ``.`` in insertion order, so the
    engine registers metrics in the exact section layout its report has
    always had."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}

    # -- registration -----------------------------------------------------

    def register(self, metric: _Metric):
        if metric.name in self._metrics:
            raise ValueError(f"metric {metric.name!r} already registered")
        self._metrics[metric.name] = metric
        return metric

    def check_aliases(self) -> None:
        """Every ``alias_of`` must name a registered canonical metric.
        Deferred from :meth:`register` so sections can alias across the
        report's insertion order; the engine calls this once after its
        full registration (and the golden-schema test again)."""
        for m in self._metrics.values():
            if m.alias_of is not None and m.alias_of not in self._metrics:
                raise ValueError(
                    f"{m.name!r} aliases unknown metric {m.alias_of!r}")

    def counter(self, name, help, **kw) -> Counter:
        return self.register(Counter(name, help, **kw))

    def gauge(self, name, help, **kw) -> Gauge:
        return self.register(Gauge(name, help, **kw))

    def histogram(self, name, help, *, buckets, **kw) -> Histogram:
        return self.register(Histogram(name, help, buckets=buckets, **kw))

    def func(self, name, help, fn, **kw) -> FuncMetric:
        return self.register(FuncMetric(name, help, fn, **kw))

    # -- access -----------------------------------------------------------

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __len__(self) -> int:
        return len(self._metrics)

    def get(self, name: str) -> _Metric:
        return self._metrics[name]

    def names(self) -> list[str]:
        return list(self._metrics)

    def reset(self) -> None:
        """Zero every OWNED metric (bound metrics follow their source)."""
        for m in self._metrics.values():
            m.reset()

    # -- exposition -------------------------------------------------------

    def describe(self) -> dict[str, dict]:
        """{name: {kind, type, help, ...}} — the machine-readable schema
        the golden test and the CI schema diff consume."""
        return {name: m.describe() for name, m in self._metrics.items()}

    def get_value(self, name: str) -> Any:
        """Current value of one metric by dotted name (KeyError when
        not registered) — the SLO monitor's gauge-objective read."""
        return self._metrics[name].value()

    def snapshot(self) -> dict[str, Any]:
        """Flat {dotted-name: value} snapshot, JSON-serializable."""
        return {name: m.value() for name, m in self._metrics.items()}

    def nested(self) -> dict:
        """Snapshot nested by the ``.`` separator, insertion-ordered —
        the engine report's exact shape."""
        out: dict = {}
        for name, m in self._metrics.items():
            parts = name.split(".")
            node = out
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = m.value()
        return out

    def to_prometheus(self) -> str:
        """Text exposition (format 0.0.4).  Non-numeric metrics (strings,
        booleans-as-config) surface as ``name_info{value="..."} 1`` so
        the scrape keeps the full schema without type abuse.  HELP text
        and label values are escaped per the format spec (``\\`` and
        newline in help; ``\\``, ``"`` and newline in label values) —
        round-trip pinned by ``tests/test_obs.py``."""
        lines: list[str] = []
        for name, m in self._metrics.items():
            pn = prom_name(name)
            help_ = _escape_help(m.help)
            if isinstance(m, Histogram):
                lines.append(f"# HELP {pn} {help_}")
                lines.append(f"# TYPE {pn} histogram")
                cum = 0
                for ub, c in zip(m.buckets, m.counts):
                    cum += c
                    le = "+Inf" if math.isinf(ub) else repr(ub)
                    lines.append(f'{pn}_bucket{{le="{le}"}} {cum}')
                lines.append(f"{pn}_sum {m.sum}")
                lines.append(f"{pn}_count {m.n}")
                continue
            v = m.value()
            if isinstance(m, Counter) and m.label_names:
                lines.append(f"# HELP {pn} {help_}")
                lines.append(f"# TYPE {pn} {m.kind}")
                for key, n in sorted(m._series.items()):
                    lbl = ",".join(
                        f'{k}="{_escape_label_value(str(val))}"'
                        for k, val in zip(m.label_names, key))
                    lines.append(f"{pn}{{{lbl}}} {n}")
                lines.append(f"{pn}_total {m._total}")
                continue
            if isinstance(v, bool):
                v = int(v)
            if v is None or isinstance(v, str) or isinstance(v, dict):
                lines.append(f"# HELP {pn} {help_}")
                lines.append(f"# TYPE {pn} gauge")
                sval = "none" if v is None else str(v)
                lines.append(f'{pn}_info{{value='
                             f'"{_escape_label_value(sval)}"}} 1')
                continue
            lines.append(f"# HELP {pn} {help_}")
            lines.append(f"# TYPE {pn} {m.kind}")
            lines.append(f"{pn} {v}")
        return "\n".join(lines) + "\n"
