"""Uniform model API over the ported families (dense only so far).

The counterpart of ``repro/models/model_zoo.py``::

    param_table(cfg)                   -> {path: ParamSpec}
    init(cfg, generator)               -> params (on the generator's device)
    prefill(cfg, params, batch, cache, lengths=None) -> (last_logits, cache)
    decode(cfg, params, cache, tokens, t, active=None, page_tables=None)
                                       -> (logits, cache)
    init_cache(cfg, batch, max_len, device) -> cache
    init_paged_pool(cfg, total_pages, page_size, device) -> page pool

Other families raise ``NotImplementedError`` until their slice is ported.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models import common, transformer
from repro_torch.models.common import ModelConfig, Params


def _dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (ROADMAP.md, "
            f"queue 1); only 'dense' is")


def param_table(cfg: ModelConfig) -> Dict[str, common.ParamSpec]:
    _dense(cfg)
    return transformer.param_table(cfg)


def init(cfg: ModelConfig, generator: torch.Generator) -> Params:
    """Seeded parameters, drawn on ``generator.device``."""
    return common.init_params(param_table(cfg), cfg.param_dtype, generator)


def prefill(cfg: ModelConfig, params: Params, batch, cache, lengths=None):
    _dense(cfg)
    return transformer.prefill(cfg, params, batch, cache, lengths=lengths)


def decode(cfg: ModelConfig, params: Params, cache, tokens, t, active=None,
           page_tables=None):
    _dense(cfg)
    return transformer.decode_step(cfg, params, cache, tokens, t, active,
                                   page_tables)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    _dense(cfg)
    return transformer.init_cache(cfg, batch, max_len, device)


def init_paged_pool(cfg: ModelConfig, total_pages: int, page_size: int,
                    device=None):
    _dense(cfg)
    return transformer.init_paged_pool(cfg, total_pages, page_size, device)
