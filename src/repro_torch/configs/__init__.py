"""Architecture registry: ``get_config(arch_id)`` and shape helpers."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    DECODE_32K,
    LONG_500K,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    PREFILL_32K,
    RopeScaling,
    SHAPES,
    SMOKE_DECODE,
    SMOKE_SHAPE,
    ShapeSpec,
    TRAIN_4K,
    applicable_shapes,
    reduced,
)

# arch id -> module name
_REGISTRY = {
    "rwkv6-1.6b": "rwkv6_1_6b",
    "stablelm-3b": "stablelm_3b",
    "stablelm-12b": "stablelm_12b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "starcoder2-15b": "starcoder2_15b",
    "whisper-small": "whisper_small",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "deepseek-v2-lite": "deepseek_v2_lite",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "mellum2-12b-a2.5b": "mellum2_12b_a2_5b",
}

ARCH_IDS = tuple(_REGISTRY)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    mod = importlib.import_module(f"repro_torch.configs.{_REGISTRY[arch_id]}")
    return mod.CONFIG


def all_configs() -> dict:
    return {a: get_config(a) for a in ARCH_IDS}
