"""The port's copy of the fault-tolerance policies
(``tests/test_fault_tolerance.py``'s five cases on it: heartbeats,
stragglers, elastic re-mesh, the supervised restart loop resuming from
the committed step), the same decisions as the JAX package's on one
scripted run, the ``fault_tolerant_train`` twin surviving its injected
failure, and ``ShardedLoader``: its batches the stream's (the JAX
package's numbers), its position through ``state()`` / ``restore()``,
``close()`` ending its thread.  A few seconds."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.data import ShardedLoader, SyntheticLMStream
from repro_torch.distributed.fault_tolerance import (ElasticPlanner,
                                                     HeartbeatMonitor,
                                                     RunSupervisor)
from repro_torch.launch import fault_tolerant_train
from tests.torch_threads import one_torch_thread  # noqa: F401


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_straggler_detection_needs_patience():
    clock = FakeClock()
    mon = HeartbeatMonitor(4, straggler_factor=1.5, patience=3, clock=clock)
    for step in range(6):
        clock.t += 1
        for h in range(4):
            mon.beat(h, 2.0 if h == 2 else 1.0)   # host 2 is 2x slower
        res = mon.check()
        if step < 2:
            assert res["stragglers"] == []
    assert 2 in mon.check()["stragglers"]


def test_dead_host_detection_by_timeout():
    clock = FakeClock()
    mon = HeartbeatMonitor(3, timeout_s=10, clock=clock)
    for h in range(3):
        mon.beat(h, 1.0)
    clock.t = 5
    mon.beat(0, 1.0)
    mon.beat(1, 1.0)          # host 2 silent since t=0
    clock.t = 12
    res = mon.check()
    assert res["dead"] == [2]
    assert mon.alive_count() == 2


def test_elastic_planner_shrinks_data_axis():
    p = ElasticPlanner(model_axis=16)
    plan = p.plan(256)
    assert plan.shape == (16, 16) and plan.dropped == 0
    plan = p.plan(250)           # lost 6 devices
    assert plan.shape == (15, 16) and plan.dropped == 250 - 240
    with pytest.raises(RuntimeError):
        p.plan(8)                # cannot host the TP degree


def test_elastic_planner_multi_pod():
    p = ElasticPlanner(model_axis=16, pod_size=256)
    plan = p.plan(512)
    assert plan.shape == (2, 16, 16) and plan.axes[0] == "pod"


def test_supervisor_restart_resumes_from_committed_step(tmp_path):
    ck = Checkpointer(str(tmp_path))
    calls = []

    def train_segment(plan, start, total):
        calls.append((plan.n_devices, start))
        for s in range(start + 1, min(start + 5, total) + 1):
            ck.save(s, {"w": torch.zeros(())}, blocking=True)
        last = min(start + 5, total)
        if len(calls) == 1:          # one failure, 16 devices lost
            return last, {"lost_devices": 16}
        return last, None

    sup = RunSupervisor(ElasticPlanner(model_axis=16), ck, train_segment)
    final = sup.run(n_devices=256, total_steps=10)
    assert final == 10
    assert sup.restarts == 1
    assert calls[0][0] == 256 and calls[1][0] == 240  # re-meshed smaller
    assert calls[1][1] == 5                            # resumed at commit


def test_policies_decide_as_the_references():
    """One scripted run of heartbeats and plans through both packages'
    policies: the same reports and plans."""
    from repro.distributed import fault_tolerance as jft
    from repro_torch.distributed import fault_tolerance as tft
    out = []
    for ft in (jft, tft):
        clock = FakeClock()
        mon = ft.HeartbeatMonitor(6, timeout_s=4, straggler_factor=1.3,
                                  patience=2, clock=clock)
        rng = np.random.default_rng(0)
        log = []
        for step in range(30):
            clock.t += 1
            for h in range(6):
                if h == 5 and step > 10:
                    continue               # host 5 goes silent
                mon.beat(h, float(rng.uniform(0.8, 1.2)
                                  * (1.6 if h == 1 else 1.0)))
            log.append(mon.check())
        plans = [dataclasses.astuple(ft.ElasticPlanner(8, pod_size=64)
                                     .plan(n)) for n in (8, 63, 64, 130, 512)]
        out.append((log, plans, mon.alive_count()))
    assert out[0] == out[1]
    assert any(r["stragglers"] for r in out[0][0])
    assert any(r["dead"] for r in out[0][0])


def test_fault_tolerant_twin(tmp_path):
    res = fault_tolerant_train.run(device="cpu", ckpt_dir=str(tmp_path))
    assert res["final_step"] == 25 and res["restarts"] == 1
    assert [(h["devices"], h["from"], h["to"]) for h in res["history"]] == \
        [(256, 0, 12), (240, 10, 25)]
    assert all(np.isfinite(v) for v in res["losses"].values())


def test_loader_batches_are_the_streams():
    from repro.data import SyntheticLMStream as JStream
    stream = SyntheticLMStream(300, 16, 4, seed=7)
    jstream = JStream(300, 16, 4, seed=7)
    loader = ShardedLoader(stream, "cpu", start_step=3, depth=2)
    try:
        for want_step in range(3, 8):
            step, b = next(loader)
            assert step == want_step
            want = jstream.batch(step)
            assert set(b) == set(want) == {"tokens", "labels", "mask"}
            for k, v in want.items():
                assert b[k].device.type == "cpu"
                assert np.array_equal(b[k].numpy(), v) and \
                    b[k].numpy().dtype == v.dtype
        assert loader.state() == {"step": 8, "seed": 7}
    finally:
        loader.close()
    assert not loader._thread.is_alive()


def test_loader_state_restore():
    stream = SyntheticLMStream(300, 8, 2, seed=1)
    loader = ShardedLoader(stream, "cpu")
    for _ in range(4):
        next(loader)
    state = loader.state()
    loader.close()
    assert not loader._thread.is_alive()
    resumed = ShardedLoader.restore(SyntheticLMStream(300, 8, 2, seed=99),
                                    "cpu", state, depth=3)
    try:
        step, b = next(resumed)
        assert step == 4 and resumed.stream.seed == 1
        assert np.array_equal(b["tokens"].numpy(), stream.batch(4)["tokens"])
    finally:
        resumed.close()
    assert not resumed._thread.is_alive()
