"""Per-configuration training presets: gradient accumulation and the
moment dtype, the reference's rule (``repro/launch/presets.py``).

* ``accum_steps`` keeps a microbatch's activations (remat layer
  boundaries plus the CE chunk's logits) within memory: 16 at 100 B
  parameters and more, 8 at 30 B, 4 at 5 B, else 2, capped at the global
  batch and halved until it divides it.
* ``moment_dtype``: bfloat16 Adam moments at 100 B parameters and more,
  else float32.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_loop import TrainConfig


def train_preset(cfg: ModelConfig, global_batch: int) -> TrainConfig:
    n = cfg.param_count()
    if n >= 100e9:
        accum, moment_dtype = 16, torch.bfloat16
    elif n >= 30e9:
        accum, moment_dtype = 8, torch.float32
    elif n >= 5e9:
        accum, moment_dtype = 4, torch.float32
    else:
        accum, moment_dtype = 2, torch.float32
    accum = min(accum, global_batch)
    while global_batch % accum:
        accum //= 2
    return TrainConfig(opt=OptimizerConfig(moment_dtype=moment_dtype),
                       accum_steps=max(accum, 1))
