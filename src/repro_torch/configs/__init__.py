"""Config registry: ``get_config(arch_id)`` and smoke-scale variants.

Only the dense GQA architectures the port serves are registered; other
architecture ids raise ``NotImplementedError`` naming the ROADMAP queue.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

__all__ = ["ARCH_IDS", "ModelConfig", "get_config", "get_smoke_config"]

ARCH_IDS = ["qwen3_1_7b"]

# canonical CLI ids (dashes) -> module names
_ALIAS = {i.replace("_", "-"): i for i in ARCH_IDS}


def _module(arch: str):
    mod_name = _ALIAS.get(arch, arch).replace("-", "_")
    if mod_name not in ARCH_IDS:
        raise NotImplementedError(
            f"architecture {arch!r} is not ported to repro_torch yet "
            f"(have {ARCH_IDS}; ROADMAP Queue 1 lists the rest)")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE_CONFIG
