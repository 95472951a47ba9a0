"""Int8 gradient compression with error feedback: the counterpart of
``repro/training/compression.py``'s ``compress`` / ``decompress``.

Each gradient leaf plus its carried residual is quantized to int8 with a
per-leaf float32 scale; the residual of the quantization is carried to
the next step (error feedback, Karimireddy et al., 2019).  On one device
the train step quantizes and dequantizes in place of the cross-replica
mean.  ``jnp.round`` and ``torch.round`` both round half to even, and the
division is IEEE, so with the absmax scale ``q`` and the scales equal
the reference's bit for bit.

The int8 ring all-reduce over a data axis (``ring_allreduce_int8``,
``allreduce_compressed``) belongs to sharded training, not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    enabled: bool = False
    dtype: torch.dtype = torch.int8
    # quantile used for the scale (max is noise-sensitive; 0 = use absmax)
    clip_quantile: float = 0.0


def init_error(params: Params) -> Params:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def quantile(a: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(a.reshape(-1), q)`` (linear interpolation) of a
    float32 tensor, as the reference computes it: the rank ``q * (n - 1)``
    in float32, the two neighbouring order statistics, and their float32
    weights; NaN if any element is.  ``torch.quantile`` refuses inputs
    of more than 2**24 elements, so the order statistics come from
    ``torch.kthvalue``."""
    flat = a.reshape(-1)
    f32 = torch.float32
    n = torch.tensor(flat.numel(), dtype=f32)
    rank = torch.tensor(q, dtype=f32) * (n - 1)
    low, high = torch.floor(rank), torch.ceil(rank)
    hi_w = rank - low
    lo_w = 1 - hi_w
    lo_i = int(low.clamp(0, n - 1)) + 1            # kthvalue's k is 1-based
    hi_i = int(high.clamp(0, n - 1)) + 1
    lo_v = torch.kthvalue(flat, lo_i).values
    hi_v = lo_v if hi_i == lo_i else torch.kthvalue(flat, hi_i).values
    out = lo_v * lo_w.to(a.device) + hi_v * hi_w.to(a.device)
    return torch.where(flat.isnan().any(), torch.nan, out)


def _scale_for(leaf: torch.Tensor, cfg: CompressionConfig) -> torch.Tensor:
    a = leaf.float().abs()
    s = quantile(a, cfg.clip_quantile) if cfg.clip_quantile > 0 else a.max()
    return s.clamp_min(1e-12) / 127.0


def compress(grads: Params, error: Params, cfg: CompressionConfig
             ) -> Tuple[Params, Params, Params]:
    """Quantize (grad + carried error) to int8.  Returns (q, scales,
    new_error)."""
    qs, ss, es = {}, {}, {}
    for k in grads:
        g32 = grads[k].float() + error[k]
        s = _scale_for(g32, cfg)
        q = torch.clamp(torch.round(g32 / s), -127, 127).to(cfg.dtype)
        qs[k], ss[k] = q, s
        es[k] = g32 - q.float() * s          # residual -> error feedback
    return qs, ss, es


def decompress(qs: Params, scales: Params) -> Params:
    return {k: qs[k].float() * scales[k] for k in qs}
