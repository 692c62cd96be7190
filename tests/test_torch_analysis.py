"""The port's cost analysis (``repro_torch.launch.analysis``) against the
reference's (``repro.launch.analysis``), and the counts it takes.

* ``collective_traffic`` over records that mirror the reference test's
  HLO fixture gives the reference parser's totals; the ``CostSample``
  algebra is the reference's; the roofline terms use the H100's rates,
  a collective's group on the slowest link it crosses.
* Count invariance: for a smoke config of each family, a decode step, a
  prefill step and a train step counted on the meta device give exactly
  the FLOPs, bytes and peak live bytes counted on CPU tensors.
* Collectives: two gloo ranks of a dense smoke decode on (1, 2) record
  the collectives ``CountingMesh``'s trace of the same step records.
* ``obs.profile.Profiler(cost=True)`` memoizes one entry a shape key."""
import dataclasses

import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from repro.launch import analysis as JA  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.qmodel import QuantContext, QuantMode  # noqa: E402
from repro_torch.launch import analysis as TA  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.launch.mesh import (CountingMesh, RankMesh,  # noqa: E402
                                     make_production_mesh, run_ranks)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim.schedule import warmup_cosine  # noqa: E402
from tests import analysis_cases  # noqa: E402
from tests.test_analysis import HLO  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

# the reference fixture's collectives as the port records them
RECORDS = [("all-reduce", 128 * 512 * 4, 4),
           ("all-gather", 64 * 1024 * 2, 8),
           ("reduce-scatter", 16 * 256 * 4, 4),
           ("collective-permute", 1024, 2)]


def test_collective_traffic_matches_reference_parser():
    want = JA.collective_traffic(HLO)
    got = TA.collective_traffic(RECORDS)
    assert {k: got[k] for k in want} == want
    assert got["network"] == 0.0
    linked = TA.collective_traffic([r + ("network",) for r in RECORDS[:2]]
                                   + RECORDS[2:])
    assert linked["network"] == want["all-reduce"] + want["all-gather"]
    with pytest.raises(ValueError, match="unknown collective"):
        TA.collective_traffic([("broadcast", 4, 2)])


@pytest.mark.parametrize("w", [0.0, 0.5, 2.0, 7.25])
def test_cost_sample_algebra_matches_reference(w):
    pairs = [(10.0, 100.0, {"all-reduce": 5.0, "total": 5.0}),
             (1.0, 10.0, {"all-gather": 2.0, "total": 2.0})]
    ja, jb = (JA.CostSample(*p) for p in pairs)
    ta, tb = (TA.CostSample(*p) for p in pairs)
    jc, tc = ja.scaled(w) + jb, ta.scaled(w) + tb
    assert (tc.flops, tc.bytes_hbm, tc.collectives) == \
        (jc.flops, jc.bytes_hbm, jc.collectives)


def test_roofline_terms_h100():
    t = TA.roofline_terms(TA.CostSample(989e12, 0.0, {"total": 0.0}))
    assert t["dominant"] == "compute" and abs(t["t_compute_s"] - 1) < 1e-12
    t = TA.roofline_terms(TA.CostSample(0.0, 3.35e12, {"total": 0.0}))
    assert t["dominant"] == "memory" and abs(t["t_memory_s"] - 1) < 1e-12
    # 450 GB over NVLink and 50 GB across nodes: a second each
    t = TA.roofline_terms(TA.CostSample(0.0, 0.0, {"total": 500e9,
                                                   "network": 50e9}))
    assert t["dominant"] == "collective"
    assert abs(t["t_collective_s"] - 2.0) < 1e-12


def test_mesh_records_what_each_collective_means():
    """A reduce-scatter is noted as one (its result, the shard), a group
    inside one node of 8 cards on NVLink, one across nodes on the
    network; a collective over an axis of one rank is no collective."""
    t = torch.ones(8, 4)
    small, prod = CountingMesh(1, 2), CountingMesh(16, 16)
    with TA.CostMode() as mode:
        small.reduce_scatter(t, "model", 0)
        small.all_reduce(t, "model")
        small.all_gather(t, "model", 1)
        small.all_reduce(t, "data")
    assert mode.records == [("reduce-scatter", 64, 2, "nvlink"),
                            ("all-reduce", 128, 2, "nvlink"),
                            ("all-gather", 256, 2, "nvlink")]
    with TA.CostMode() as mode:
        prod.all_reduce(t, "model")
        prod.all_gather(t, "data", 0)
    assert mode.records == [("all-reduce", 128, 16, "network"),
                            ("all-gather", 16 * 128, 16, "network")]
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).shape == {"data": 32,
                                                          "model": 16}


def test_cost_mode_bytes_and_peak():
    """Each op's operands as bytes (a view nothing), the multiplies as
    FLOPs, and as peak the storages the call makes while they live: an
    in-place write into a tensor made before adds none."""
    cache = torch.zeros(1024)
    x = torch.ones(64, 32)
    w = torch.ones(32, 16)
    with TA.CostMode() as mode:
        y = x @ w                           # 8 KiB + 2 KiB in, 4 KiB out
        cache[:16].copy_(y[0])              # views, then in place
        z = (y + 1).sum()                   # 4 KiB more beside y, freed
        del y
    assert mode.flops == 2 * 64 * 32 * 16
    # the product, the copy's two operands and its output, the add, the sum
    assert mode.bytes == 4 * (64 * 32 + 32 * 16 + 64 * 16) + 4 * 3 * 16 \
        + 4 * 2 * 64 * 16 + 4 * (64 * 16 + 1)
    # y, y + 1 and the sum at once; the sum alone after
    assert mode.peak == 4 * (2 * 64 * 16 + 1) and mode.live == 4
    assert z.item() == 64 * 16 * 33


# ---------------------------------------------------------------------------
# count invariance: meta against CPU
# ---------------------------------------------------------------------------

FAMILIES = ["qwen3_1_7b", "chameleon_34b", "granite_moe_3b_a800m",
            "rwkv6_3b", "zamba2_2_7b", "whisper_large_v3"]


def _counted(arch, kind, dev):
    cfg = dataclasses.replace(get_smoke_config(arch), attn_kernel="flash")
    ctx = QuantContext(mode=QuantMode.FP)
    params = M.init_params(cfg, 0, device=dev)
    b, s = 2, 12
    batch = {"tokens": (torch.arange(b * s, dtype=torch.int32) % 50
                        ).reshape(b, s).to(dev)}
    if cfg.family == "audio":
        batch["encoder_features"] = torch.zeros(
            (b, cfg.encdec.encoder_seq, cfg.d_model), dtype=torch.bfloat16,
            device=dev)
    prefill = S.build_prefill_step(cfg, ctx, max_seq=s + 4)
    if kind == "train":
        opt = S.pick_optimizer(cfg)
        state = opt.init(params)
        batch = dict(batch, labels=batch["tokens"].clone(),
                     mask=torch.ones((b, s), device=dev))
        step = S.build_train_step(cfg, ctx, opt,
                                  warmup_cosine(3e-4, 10, 100))
        with TA.CostMode() as mode:
            step(params, state, batch)
        return mode
    with torch.no_grad():
        if kind == "prefill":
            with TA.CostMode() as mode:
                prefill(params, batch)
            return mode
        _, cache = prefill(params, batch)
        tokens = torch.ones((b, 1), dtype=torch.int32, device=dev)
        pos = torch.tensor(s + 3, dtype=torch.int32).to(dev)
        with TA.CostMode() as mode:
            S.build_serve_step(cfg, ctx)(params, tokens, cache, pos)
    return mode


@pytest.mark.parametrize("kind", ["decode", "prefill", "train"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_counts_on_meta_equal_counts_on_cpu(arch, kind):
    cpu, meta = _counted(arch, kind, "cpu"), _counted(arch, kind, "meta")
    assert cpu.flops > 0 and cpu.bytes > 0
    assert (meta.flops, meta.bytes, meta.peak) == \
        (cpu.flops, cpu.bytes, cpu.peak)
    assert meta.kernels == cpu.kernels


# ---------------------------------------------------------------------------
# the collectives of a mesh: gloo ranks against the stand-in's trace
# ---------------------------------------------------------------------------

def test_gloo_ranks_record_the_counting_mesh_trace():
    ranks = run_ranks(analysis_cases.decode_records, (1, 2), device="cpu",
                      backend="gloo", threads=1)
    traced = analysis_cases.decode_records(CountingMesh(1, 2))
    assert traced and all(r == traced for r in ranks)
    kinds = {r[0] for r in traced}
    assert kinds == {"all-reduce", "all-gather"}
    assert all(r[2] == 2 and r[3] == "nvlink" for r in traced)
    # on a layout, with no ranks, a collective cannot run
    with pytest.raises(KeyError):
        RankMesh(1, 2).all_reduce(torch.ones(2), "model")


# ---------------------------------------------------------------------------
# the engine's per-shape cost table
# ---------------------------------------------------------------------------

def test_profiler_cost_for_memoizes_a_key():
    from repro_torch.obs.profile import Profiler
    off = Profiler()
    assert not off.enabled and off.report() is None
    with off.cost_for("k"):
        torch.ones(4) + 1
    assert off.shape_costs == {}
    prof = Profiler(cost=True, device_type="cpu")
    x = torch.ones(64, 32)
    w = torch.ones(32, 16)
    with prof.cost_for(("ragged", 8, 2)):
        x @ w
    with prof.cost_for(("ragged", 8, 2)):
        (x @ w) @ w.T           # not counted: the key has its entry
    entry = prof.shape_costs[("ragged", 8, 2)]
    assert entry["flops"] == 2 * 64 * 32 * 16
    assert entry["bytes_accessed"] == 4 * (64 * 32 + 32 * 16 + 64 * 16)
    assert entry["peak_bytes"] == 4 * 64 * 16
    rep = prof.report()
    assert list(rep["cost_analysis"]) == ["('ragged', 8, 2)"]
    prof.reset()
    assert prof.shape_costs and prof.report()["annotated_dispatches"] == 0
