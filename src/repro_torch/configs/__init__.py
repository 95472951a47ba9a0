"""Architecture registry of the port.

The dense stablelm-1.6b, the hybrid hymba-1.5b and the attention-free
rwkv6-7b are ported.  Every other architecture of the reference
registry raises ``NotImplementedError`` naming the ROADMAP item that
will port its family.
"""

from __future__ import annotations

import importlib
from typing import Tuple

from repro_torch.models.common import ModelConfig

_MODULES = {
    "stablelm-1.6b": "stablelm_1_6b",
    "hymba-1.5b": "hymba_1_5b",
    "rwkv6-7b": "rwkv6_7b",
}

#: the reference's other architectures, by the ROADMAP item that ports them
_LATER = {
    "qwen2.5-14b": "the dense-family follow-up (qkv bias)",
    "llama3-405b": "the tensor-parallel endpoint",
    "nemotron-4-340b": "the tensor-parallel endpoint",
    "internvl2-1b": "the dense-family follow-up (vision prefix)",
    "musicgen-medium": "the dense-family follow-up (audio tokens)",
    "qwen2-moe-a2.7b": "MoE",
    "mixtral-8x7b": "MoE",
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
