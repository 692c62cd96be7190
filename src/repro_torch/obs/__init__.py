"""Serving observability layer of the port: metrics registry, structured
event tracing, profiling + energy hooks, workload flight recorder
(capture/replay) and SLO burn-rate monitoring.

``metrics``/``trace``/``schema``/``slo``/``replay`` are stdlib-only
copies of the JAX package's ``repro.obs`` modules (the port imports
nothing of that package); ``profile`` runs on ``torch.profiler``.
"""
from repro_torch.obs.metrics import (Counter, FuncMetric, Gauge, Histogram,
                                     MetricsRegistry, prom_name)
from repro_torch.obs.profile import ENERGY_PHASES, EnergyAccount, Profiler
from repro_torch.obs.replay import (ReplayResult, WorkloadRecord,
                                    capture_workload, diff_decisions,
                                    engine_fingerprint, replay_workload)
from repro_torch.obs.schema import (GOLDEN_SCHEMA, PORT_EXTRAS, diff_schema,
                                    schema_of)
from repro_torch.obs.slo import SLObjective, SLOMonitor, default_slos
from repro_torch.obs.trace import Timeline, Tracer, validate_chrome_trace

__all__ = [
    "Counter", "Gauge", "Histogram", "FuncMetric", "MetricsRegistry",
    "prom_name",
    "Tracer", "Timeline", "validate_chrome_trace",
    "Profiler", "EnergyAccount", "ENERGY_PHASES",
    "GOLDEN_SCHEMA", "PORT_EXTRAS", "schema_of", "diff_schema",
    "WorkloadRecord", "ReplayResult", "capture_workload",
    "replay_workload", "diff_decisions", "engine_fingerprint",
    "SLObjective", "SLOMonitor", "default_slos",
]
