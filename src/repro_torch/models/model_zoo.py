"""Uniform model API over the ported families, keyed by ``cfg.family``.

The counterpart of ``repro/models/model_zoo.py``::

    param_table(cfg)                   -> {path: ParamSpec}
    init(cfg, generator)               -> params (on the generator's device)
    prefill(cfg, params, batch, cache, lengths=None) -> (last_logits, cache)
    decode(cfg, params, cache, tokens, t, active=None, page_tables=None)
                                       -> (logits, cache)
    init_cache(cfg, batch, max_len, device) -> cache
    init_paged_pool(cfg, total_pages, page_size, device) -> page pool

Every family of the reference is ported: ``dense``, ``moe``, ``hymba``
and ``rwkv6``.  ``dense`` and ``moe`` page their KV cache alike (a
sliding-window config smaller than the context still raises in
``decode_step``: the reference keeps those rolling rows per slot).
hymba's paged pool is not ported yet (ROADMAP item 4), and rwkv6 has no
leaf to page (its state does not grow with the context).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.models import common, hymba, moe, rwkv6, transformer
from repro_torch.models.common import ModelConfig, Params


class Family(NamedTuple):
    layer_fn: transformer.LayerFn
    table_fn: Callable[[ModelConfig], Dict[str, common.ParamSpec]]
    cache_fn: Callable[..., Dict[str, torch.Tensor]]
    #: None where the family's paged tier is not ported
    paged_pool_fn: Optional[Callable[..., Dict[str, torch.Tensor]]]


_FAMILIES = {
    "dense": Family(transformer.dense_layer, transformer.param_table,
                    transformer.init_cache, transformer.init_paged_pool),
    "moe": Family(moe.moe_layer, moe.param_table, transformer.init_cache,
                  transformer.init_paged_pool),
    "hymba": Family(hymba.hymba_layer, hymba.param_table, hymba.init_cache,
                    None),
    "rwkv6": Family(rwkv6.rwkv_layer, rwkv6.param_table, rwkv6.init_cache,
                    None),
}


def family(cfg: ModelConfig) -> Family:
    fam = _FAMILIES.get(cfg.family)
    if fam is None:
        raise ValueError(f"unknown model family {cfg.family!r}; the "
                         f"families are {sorted(_FAMILIES)}")
    return fam


def param_table(cfg: ModelConfig) -> Dict[str, common.ParamSpec]:
    return family(cfg).table_fn(cfg)


def init(cfg: ModelConfig, generator: torch.Generator) -> Params:
    """Seeded parameters, drawn on ``generator.device``."""
    return common.init_params(param_table(cfg), cfg.param_dtype, generator)


def prefill(cfg: ModelConfig, params: Params, batch, cache, lengths=None):
    return transformer.prefill(cfg, params, batch, cache, lengths=lengths,
                               layer_fn=family(cfg).layer_fn)


def decode(cfg: ModelConfig, params: Params, cache, tokens, t, active=None,
           page_tables=None):
    return transformer.decode_step(cfg, params, cache, tokens, t, active,
                                   page_tables, family(cfg).layer_fn)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    return family(cfg).cache_fn(cfg, batch, max_len, device)


def init_paged_pool(cfg: ModelConfig, total_pages: int, page_size: int,
                    device=None):
    fn = family(cfg).paged_pool_fn
    if fn is None:
        raise NotImplementedError(
            f"the paged pool of the {cfg.family!r} family is not ported "
            f"(ROADMAP.md queue 1, item 4: the reference pages its global "
            f"layers and keeps rolling-window rows and recurrent state per "
            f"slot)")
    return fn(cfg, total_pages, page_size, device)
