"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package ``repro``, and the port's
entry points refuse to fall back to the CPU when no GPU is present."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro") or top.startswith("jax")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_repro_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_import_without_jax_loads_no_repro_module():
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from repro_torch.kernels.flash_attention import paged_attention_cuda\n"
        "from repro_torch.serving.spec import NgramDrafter, verify_tokens\n"
        "from repro_torch.obs import (MetricsRegistry, Tracer, SLOMonitor,\n"
        "    GOLDEN_SCHEMA, PORT_EXTRAS, EnergyAccount, Profiler,\n"
        "    WorkloadRecord, replay_workload)\n"
        "Profiler(); EnergyAccount()\n"
        "from repro_torch.data import ShardedLoader\n"
        "from repro_torch.checkpoint import Checkpointer\n"
        "from repro_torch.distributed import RunSupervisor\n"
        "from repro_torch.optim import adamw\n"
        "from repro_torch.launch.train import train\n"
        "adamw()\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None and"
        " (m == 'repro' or m.startswith(('repro.', 'jax')))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.qmodel import QuantContext
    from repro_torch.launch import quickstart
    from repro_torch.launch.serve import serve, serve_engine
    from repro_torch.models.model import init_cache, init_params
    from repro_torch.models.resnet import (from_jax_resnet_params,
                                           init_resnet)
    from repro_torch.serving.engine import ServingEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("qwen3_1_7b")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_engine("qwen3_1_7b", n_requests=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve("qwen3_1_7b")
    for arch in ("granite_moe_3b_a800m", "deepseek_v3_671b",
                 "whisper_large_v3"):
        with pytest.raises(RuntimeError, match="CUDA"):
            serve(arch)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, {}, QuantContext())
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg)
    rcfg = get_smoke_config("resnet_paper")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_resnet(rcfg, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        from_jax_resnet_params({})
    with pytest.raises(RuntimeError, match="CUDA"):
        quickstart.run()
    with pytest.raises(RuntimeError, match="CUDA"):
        quickstart.main([])
    from repro_torch.data import ShardedLoader, SyntheticLMStream
    from repro_torch.launch import fault_tolerant_train, train_small_lm
    from repro_torch.launch.train import train
    with pytest.raises(RuntimeError, match="CUDA"):
        train("llama3_2_1b", 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedLoader(SyntheticLMStream(16, 4, 1))
    with pytest.raises(RuntimeError, match="CUDA"):
        train_small_lm.run(1)
    with pytest.raises(RuntimeError, match="CUDA"):
        fault_tolerant_train.run()
    # the CPU is taken only when asked for
    assert init_params(cfg, device="cpu")["embed"].device.type == "cpu"
    assert init_resnet(rcfg, generator=torch.Generator(),
                       device="cpu")["stem"]["w"].device.type == "cpu"


def test_unported_paths_raise():
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.qmodel import QuantContext
    from repro_torch.launch.serve import serve_engine
    from repro_torch.serving.engine import ServingEngine
    cfg = get_smoke_config("qwen3_1_7b")
    # observability is ported: tracing, the flight recorder and SLO
    # monitoring construct, as do speculative decoding and the legacy
    # per-shape steps
    for kw in (dict(trace=True), dict(record=True), dict(slo=True),
               dict(trace=True, record=True, slo=True, spec_k=2,
                    ragged=False),
               dict(spec_k=2), dict(ragged=False),
               dict(spec_k=2, ragged=False)):
        ServingEngine(cfg, {}, QuantContext(), device="cpu", **kw)
    # the recurrent and hybrid substrates construct, and refuse
    # speculative decoding (fixed-size state cannot retract a draft)
    for arch in ("rwkv6_3b", "zamba2_2_7b"):
        rcfg = get_smoke_config(arch)
        ServingEngine(rcfg, {}, QuantContext(), device="cpu")
        with pytest.raises(ValueError, match="speculative decoding"):
            ServingEngine(rcfg, {}, QuantContext(), device="cpu", spec_k=2)
    # the per-shape cost analysis is ported: an engine with profile_cost
    # constructs, its profiler counting
    eng = ServingEngine(cfg, {}, QuantContext(), device="cpu",
                        profile_cost=True)
    assert eng.profiler.cost and eng.profiler.enabled
    # the scaling-factor baseline is ported: a fake_sf engine serves,
    # uncalibrated (the reference calibrates only fake and int)
    out = serve_engine("qwen3_1_7b", device="cpu", n_requests=1,
                       mode="fake_sf", calibrate=True)
    assert out["report"]["completed"] == 1
    assert out["ctx"].mode.value == "fake_sf" and not out["ctx"].table
