"""Config registry: ``get_config(arch)`` / ``get_smoke_config(arch)``.

One module per assigned architecture (plus the paper's own Llama-2 models);
each exposes ``full_config()`` (exact published dims) and ``smoke_config()``
(same family, tiny dims, runnable on CPU).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (LokiConfig, ModelConfig, MoEConfig,
                                ShapeConfig, SHAPES, SSMConfig, TrainConfig,
                                shape_by_name)

ARCH_MODULES: Dict[str, str] = {
    "whisper-small": "repro_torch.configs.whisper_small",
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "gemma-7b": "repro_torch.configs.gemma_7b",
    "nemotron-4-15b": "repro_torch.configs.nemotron_4_15b",
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b",
    "llava-next-mistral-7b": "repro_torch.configs.llava_next_mistral_7b",
    # the paper's own evaluation models
    "llama2-7b": "repro_torch.configs.llama2_7b",
    "llama2-13b": "repro_torch.configs.llama2_13b",
}

ARCHS: List[str] = list(ARCH_MODULES)
ASSIGNED_ARCHS: List[str] = ARCHS[:10]


def _mod(arch: str):
    if arch not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; have {ARCHS}")
    return importlib.import_module(ARCH_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).full_config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _mod(arch).smoke_config()


__all__ = [
    "ARCHS", "ASSIGNED_ARCHS", "LokiConfig", "ModelConfig", "MoEConfig",
    "SHAPES", "SSMConfig", "ShapeConfig", "TrainConfig", "get_config",
    "get_smoke_config", "shape_by_name",
]
