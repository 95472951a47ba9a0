"""Architecture registry of the port: the reference's ten
architectures, the dense stablelm-1.6b, qwen2.5-14b, internvl2-1b
(vision prefix), musicgen-medium (audio tokens), llama3-405b and
nemotron-4-340b (priced by ``launch/tier_cost.py``; served at smoke
width), the MoE qwen2-moe-a2.7b and mixtral-8x7b, the hybrid hymba-1.5b
and the attention-free rwkv6-7b.

Each architecture pairs with the reference's four input shapes
(:data:`SHAPES`); :func:`input_specs` gives a cell's model inputs as
tensors on the ``meta`` device (shape and dtype, no storage), so the dry
run (``launch/dryrun.py``) sizes the full configurations without
allocating them.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Tuple

import torch

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


# --------------------------------------------------------------------------
# Shapes: seq_len x global_batch (``repro/configs/__init__.py:40-70``)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

#: long_500k needs sub-quadratic attention: the SSM / hybrid / windowed
#: architectures run it, the full-attention ones skip it
LONG_CONTEXT_ARCHS = ("rwkv6-7b", "hymba-1.5b", "mixtral-8x7b")


def cell_is_valid(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in LONG_CONTEXT_ARCHS
    return True


def valid_cells() -> List[Tuple[str, str]]:
    """Every valid (arch, shape) cell."""
    return [(a, s) for a in ARCHS for s in SHAPES if cell_is_valid(a, s)]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """A cell's model inputs as ``meta`` tensors (no storage):

    train:   {tokens, labels}           (+patches for vision frontends)
    prefill: {tokens}                   (+patches)
    decode:  {tokens (B,), t (B,)}
    """
    B, S = shape.global_batch, shape.seq_len
    if shape.kind not in ("train", "prefill", "decode"):
        raise ValueError(shape.kind)
    if shape.kind == "decode":
        return {"tokens": _meta((B,), torch.int32),
                "t": _meta((B,), torch.int32)}
    specs: Dict[str, torch.Tensor] = {}
    if cfg.frontend == "vision":
        P = cfg.num_patches
        specs["patches"] = _meta((B, P, cfg.d_model), cfg.compute_dtype)
        S -= P
    specs["tokens"] = _meta((B, S), torch.int32)
    if shape.kind == "train":
        specs["labels"] = _meta((B, S), torch.int32)
    return specs
