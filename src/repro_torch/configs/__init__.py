"""Architecture registry of the port.

Eight of the reference's ten architectures are ported: the dense
stablelm-1.6b, qwen2.5-14b, internvl2-1b (vision prefix) and
musicgen-medium (audio tokens), the MoE qwen2-moe-a2.7b and
mixtral-8x7b, the hybrid hymba-1.5b and the attention-free rwkv6-7b.
The other two raise ``NotImplementedError`` naming the ROADMAP item
that will port them.
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
}

#: the reference's other architectures, by the ROADMAP item that ports them
_LATER = {
    "llama3-405b": "item 6, the tensor-parallel endpoint",
    "nemotron-4-340b": "item 6, the tensor-parallel endpoint",
}

ARCHS: Tuple[str, ...] = tuple(_MODULES)


def _module(arch: str):
    if arch in _MODULES:
        return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    if arch in _LATER:
        raise NotImplementedError(
            f"{arch!r} is not ported yet; ROADMAP.md queue 1 ports it with "
            f"{_LATER[arch]}")
    raise ValueError(f"unknown architecture {arch!r}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
