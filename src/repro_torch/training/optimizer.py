"""AdamW with a linear-warmup cosine schedule, over the flat parameter
dict: the counterpart of ``repro/training/optimizer.py``.

Moments are stored in ``moment_dtype`` (float32 by default, bfloat16 for
the configurations of 100 B parameters and more); the update is computed
in float32 and cast back to each parameter's dtype.  Unlike the
reference, which returns new trees, :func:`apply_updates` writes the new
parameters and moments **in place** into the tensors it is given (the
counterpart of the reference step's ``donate_argnums=(0,)``: a
full-width state is tens of gigabytes).

The schedule, the bias corrections and the clip factor are float32, as
the reference computes them; ``lr`` and the corrections are rounded on
the host (numpy float32), where the reference rounds them in XLA, so
they may differ from its values in the last bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    end_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # moment storage dtype; the update math is float32 either way
    moment_dtype: torch.dtype = torch.float32


class OptState(NamedTuple):
    step: torch.Tensor       # () int32, on the host
    mu: Params               # first moment, same keys as the params
    nu: Params               # second moment


def init(params: Params, cfg: OptimizerConfig = OptimizerConfig()
         ) -> OptState:
    """Zero moments beside each parameter, and step 0."""
    def zeros():
        return {k: torch.zeros(p.shape, dtype=cfg.moment_dtype,
                               device=p.device) for k, p in params.items()}
    return OptState(torch.zeros((), dtype=torch.int32), zeros(), zeros())


def abstract_state(params: Params, cfg: OptimizerConfig = OptimizerConfig()
                   ) -> OptState:
    """The state's shapes and dtypes as tensors on the ``meta`` device
    (no storage): the counterpart of the reference's ShapeDtypeStructs,
    for sizing memory and as a checkpoint template."""
    def zeros():
        return {k: torch.empty(p.shape, dtype=cfg.moment_dtype,
                               device="meta") for k, p in params.items()}
    return OptState(torch.empty((), dtype=torch.int32, device="meta"),
                    zeros(), zeros())


def schedule(cfg: OptimizerConfig, step: int) -> np.float32:
    """Linear warmup -> cosine decay to ``end_lr_frac * peak``, in
    float32."""
    f = np.float32
    s = f(step)
    warm = s / f(max(cfg.warmup_steps, 1))
    total = f(max(cfg.total_steps - cfg.warmup_steps, 1))
    frac = np.clip((s - f(cfg.warmup_steps)) / total, f(0.0), f(1.0))
    cos = f(cfg.end_lr_frac) + f(1 - cfg.end_lr_frac) * f(0.5) * (
        f(1) + np.cos(f(np.pi) * frac))
    return f(cfg.peak_lr) * (warm if s < cfg.warmup_steps else cos)


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares (a 0-dim
    float32 tensor on the leaves' device)."""
    return torch.sqrt(sum(l.float().square().sum() for l in tree.values()))


def _decay_mask(path: str) -> bool:
    """Weight decay applies to matrices, not norms/biases (standard rule)."""
    leaf = path.split("/")[-1]
    return not (leaf in ("scale", "bias") or leaf.startswith("b"))


def step_factors(cfg: OptimizerConfig, step: int) -> Tuple[float, float,
                                                          float]:
    """(lr, 1 - b1**step, 1 - b2**step) of update ``step``, float32 on
    the host."""
    lr = float(schedule(cfg, step))
    b1t = float(np.float32(1.0) - np.float32(cfg.b1) ** np.float32(step))
    b2t = float(np.float32(1.0) - np.float32(cfg.b2) ** np.float32(step))
    return lr, b1t, b2t


def clip_factor(cfg: OptimizerConfig, gnorm: torch.Tensor) -> torch.Tensor:
    return torch.clamp(cfg.grad_clip / gnorm.clamp_min(1e-9), max=1.0)


@torch.no_grad()
def update_leaf(cfg: OptimizerConfig, path: str, p: torch.Tensor,
                g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                clip: torch.Tensor, factors: Tuple[float, float, float]
                ) -> None:
    """One AdamW step of one parameter (or one block of it), written in
    place into ``p``, ``mu`` and ``nu``; ``factors`` from
    :func:`step_factors`."""
    lr, b1t, b2t = factors
    g = g.float() * clip
    m = cfg.b1 * mu.float() + (1 - cfg.b1) * g
    v = cfg.b2 * nu.float() + (1 - cfg.b2) * g.square()
    del g
    upd = (m / b1t) / (torch.sqrt(v / b2t) + cfg.eps)
    mu.copy_(m)
    nu.copy_(v)
    del m, v
    p32 = p.float()
    if _decay_mask(path):
        upd = upd + cfg.weight_decay * p32
    p.copy_(p32 - lr * upd)


@torch.no_grad()
def apply_updates(cfg: OptimizerConfig, params: Params, grads: Params,
                  state: OptState) -> Tuple[Params, OptState,
                                            Dict[str, torch.Tensor]]:
    """One AdamW step on the flat param dict, in place.  Returns (params,
    state', info) with the same parameter and moment tensors, updated,
    and info = {"grad_norm", "lr"}."""
    gnorm = global_norm(grads)
    clip = clip_factor(cfg, gnorm)
    step = int(state.step) + 1
    factors = step_factors(cfg, step)
    for path, p in params.items():
        update_leaf(cfg, path, p, grads[path], state.mu[path],
                    state.nu[path], clip, factors)
    info = {"grad_norm": gnorm,
            "lr": torch.tensor(factors[0], dtype=torch.float32)}
    return params, OptState(torch.tensor(step, dtype=torch.int32),
                            state.mu, state.nu), info
