"""Config registry: ``get_config(arch_id)`` and smoke-scale variants.

Only the architectures the port serves are registered: the dense GQA
transformers (qwen3 1.7B and 32B, llama3.2 1B, deepseek 67B, and the
early-fusion chameleon 34B, family ``vlm``, whose image tokens share the
text vocabulary), the mixtures of experts granite-moe 3B and DeepSeek-V3
(family ``moe``, the latter with latent attention), the audio
encoder-decoder whisper-large-v3 (family ``audio``), the recurrent RWKV6
and the hybrid zamba2 (each a ``ModelConfig``) and the paper's ResNet
(``resnet_paper``, a ``ResNetConfig``); other architecture ids raise
``NotImplementedError`` naming the ROADMAP queue.
"""
from __future__ import annotations

import importlib
from typing import Union

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.resnet_paper import ResNetConfig

__all__ = ["ARCH_IDS", "ModelConfig", "ResNetConfig", "get_config",
           "get_smoke_config", "supported_shapes"]

ARCH_IDS = ["qwen3_1_7b", "llama3_2_1b", "qwen3_32b", "deepseek_67b",
            "chameleon_34b", "granite_moe_3b_a800m", "deepseek_v3_671b",
            "whisper_large_v3", "rwkv6_3b", "zamba2_2_7b", "resnet_paper"]

# canonical CLI ids (dashes) -> module names
_ALIAS = {i.replace("_", "-"): i for i in ARCH_IDS}


def _module(arch: str):
    mod_name = _ALIAS.get(arch, arch).replace("-", "_")
    if mod_name not in ARCH_IDS:
        raise NotImplementedError(
            f"architecture {arch!r} is not ported to repro_torch yet "
            f"(have {ARCH_IDS}; ROADMAP Queue 1 lists the rest)")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(arch: str) -> Union[ModelConfig, ResNetConfig]:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> Union[ModelConfig, ResNetConfig]:
    return _module(arch).SMOKE_CONFIG


def supported_shapes(cfg: ModelConfig) -> list[str]:
    """Which assigned shape cells apply to this arch (``base.SHAPES``):
    every one but ``long_500k``, which only a sub-quadratic arch takes."""
    names = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
    if not cfg.sub_quadratic:
        names.remove("long_500k")
    return names
