"""Hymba — hybrid-head LM: attention and SSM heads run *in parallel* in
every layer (arXiv:2411.13676), their outputs rms-normed and averaged.

The counterpart of ``repro/models/hymba.py``, following its code: the
attention branch pre-norms its input inside ``attention_block``, the SSM
branch reads the raw residual ``x``, and the two outputs are each
rms-normed and averaged with a factor of 0.5 before the MLP.  Most layers
use sliding-window attention; ``cfg.global_layers`` keep full attention,
so the layers' KV caches differ in width (``transformer.cache_groups``).
The stack is the Python loop of ``transformer.forward``, so every layer
knows its index statically; the reference's scan-mode arguments
(``window_override``, ``meta``) have no counterpart.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models import ssm, transformer
from repro_torch.models.common import (ModelConfig, ParamSpec, Params,
                                       rms_norm, stack_layers)

Cache = Dict[str, torch.Tensor]


def layer_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    t = {**{f"attn/{k}": v for k, v in transformer.attn_specs(cfg).items()},
         **{f"ssm/{k}": v for k, v in ssm.ssm_specs(cfg, d).items()},
         **{f"mlp/{k}": v for k, v in transformer.mlp_specs(cfg).items()}}
    # per-branch output norms (the paper normalizes before averaging)
    t["attn_out_norm/scale"] = ParamSpec((d,), ("embed",), "ones")
    t["ssm_out_norm/scale"] = ParamSpec((d,), ("embed",), "ones")
    return t


def param_table(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    return {**transformer.head_specs(cfg),
            **stack_layers(layer_specs(cfg), cfg.num_layers)}


def hymba_layer(cfg: ModelConfig, p: Params, x: torch.Tensor,
                positions: torch.Tensor, cache: Optional[Cache], mode: str,
                rows: Optional[torch.Tensor] = None, rope=None,
                paging=None, layer_idx: Optional[int] = None):
    """cache = this layer's {"k", "v", "pos" (attention), "h", "conv"
    (SSM)} views, written in place, or None (train: the zero state, and
    the layer returns (x, {}))."""
    if cache is not None:
        attn_cache = {k: cache[k] for k in ("k", "v", "pos")}
        state = {"h": cache["h"], "conv": cache["conv"]}
    else:
        attn_cache = None
        state = ssm.init_state(cfg, x.shape[0], x.device)
    a = transformer.attention_block(cfg, p, x, positions, attn_cache, mode,
                                    rows, rope=rope, paging=paging,
                                    layer_idx=layer_idx)
    s = ssm.ssm_block(cfg, p, x, state, mode, rows)
    fused = 0.5 * (rms_norm(a, p["attn_out_norm/scale"], cfg.norm_eps)
                   + rms_norm(s, p["ssm_out_norm/scale"], cfg.norm_eps))
    x = x + fused
    x = x + transformer.mlp_block(cfg, p, x)
    return (x, {}) if mode == "train" else x


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> Cache:
    """The attention caches of ``transformer.init_cache`` (rolling stacks
    for the window layers, ``max_len`` for the global ones) plus the SSM
    state of every layer: h (L,B,I,N) float32, conv (L,B,K-1,I)."""
    cache = transformer.init_cache(cfg, batch, max_len, device)
    for name, leaf in ssm.init_state(cfg, batch, "meta").items():
        cache[name] = torch.zeros((cfg.num_layers, *leaf.shape),
                                  dtype=leaf.dtype, device=device)
    return cache
