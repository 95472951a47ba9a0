"""Architecture registry of the port: the reference's ten
architectures, the dense stablelm-1.6b, qwen2.5-14b, internvl2-1b
(vision prefix), musicgen-medium (audio tokens), llama3-405b and
nemotron-4-340b (priced by ``launch/tier_cost.py``; served at smoke
width), the MoE qwen2-moe-a2.7b and mixtral-8x7b, the hybrid hymba-1.5b
and the attention-free rwkv6-7b.
"""

from __future__ import annotations

import importlib
from typing import Tuple

from repro_torch.models.common import ModelConfig

_MODULES = {
    "stablelm-1.6b": "stablelm_1_6b",
    "hymba-1.5b": "hymba_1_5b",
    "rwkv6-7b": "rwkv6_7b",
    "qwen2.5-14b": "qwen2_5_14b",
    "internvl2-1b": "internvl2_1b",
    "musicgen-medium": "musicgen_medium",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "mixtral-8x7b": "mixtral_8x7b",
    "llama3-405b": "llama3_405b",
    "nemotron-4-340b": "nemotron_4_340b",
}

ARCHS: Tuple[str, ...] = tuple(_MODULES)


def _module(arch: str):
    if arch in _MODULES:
        return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    raise ValueError(f"unknown architecture {arch!r}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
