"""Fault tolerance (heartbeats, elastic re-meshing, the restart loop) and,
in ``distributed.sharding``, the (data, model) mesh's partition rules."""
from repro_torch.distributed.fault_tolerance import (  # noqa: F401
    ElasticPlanner, HeartbeatMonitor, MeshPlan, RunSupervisor)

__all__ = ["HeartbeatMonitor", "ElasticPlanner", "MeshPlan",
           "RunSupervisor"]
