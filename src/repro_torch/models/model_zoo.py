"""Uniform model API over the ported families, keyed by ``cfg.family``.

The counterpart of ``repro/models/model_zoo.py``::

    param_table(cfg)                   -> {path: ParamSpec}
    init(cfg, generator)               -> params (on the generator's device)
    loss(cfg, params, batch)           -> (loss, metrics)   # train step body
    loss_terms(cfg, params, batch)     -> the loss's sums (one data replica)
    combine_loss(cfg, [terms, ...])    -> (loss, metrics) of their rows
    prefill(cfg, params, batch, cache, lengths=None) -> (last_logits, cache)
    decode(cfg, params, cache, tokens, t, active=None, page_tables=None,
           paged=())                   -> (logits, cache)
    init_cache(cfg, batch, max_len, device) -> cache
    paged_leaves(cfg, max_len)         -> names of the leaves a pool pages
    init_paged_pool(cfg, slots, max_len, total_pages, page_size, row)
                                       -> page pool

Every family of the reference is ported: ``dense``, ``moe``, ``hymba``
and ``rwkv6``.  A paged pool pages a cache leaf by the reference's rule
(``repro/serving/engine.py:196-204``): its length axis follows the slot
axis and has extent ``max_len``.  So the dense and MoE families page
every attention stack while ``max_len`` stays below their window,
hymba pages its global layers and keeps its rolling-window stacks and
SSM state per slot, and rwkv6 has no leaf to page (its state does not
grow with the context).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.models import common, hymba, moe, rwkv6, transformer
from repro_torch.models.common import ModelConfig, Params


class Family(NamedTuple):
    layer_fn: transformer.LayerFn
    table_fn: Callable[[ModelConfig], Dict[str, common.ParamSpec]]
    cache_fn: Callable[..., Dict[str, torch.Tensor]]
    #: a layer's aux losses from its (replica-summed) aux sums
    aux_fn: Optional[Callable[[ModelConfig, Dict], Dict]] = None


_FAMILIES = {
    "dense": Family(transformer.dense_layer, transformer.param_table,
                    transformer.init_cache),
    "moe": Family(moe.moe_layer, moe.param_table, transformer.init_cache,
                  moe.aux_from_sums),
    "hymba": Family(hymba.hymba_layer, hymba.param_table, hymba.init_cache),
    "rwkv6": Family(rwkv6.rwkv_layer, rwkv6.param_table, rwkv6.init_cache),
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


def loss_terms(cfg: ModelConfig, params: Params, batch) -> Dict:
    """The loss of ``batch``'s rows as sums (``transformer.loss_terms``)."""
    return transformer.loss_terms(cfg, params, batch, family(cfg).layer_fn)


def _sum(parts):
    """The sum of ``parts`` in order, on the first one's device (a
    number stays a number)."""
    out = parts[0]
    for x in parts[1:]:
        out = out + (x.to(out.device) if isinstance(x, torch.Tensor) else x)
    return out


def combine_loss(cfg: ModelConfig, terms) -> Tuple[torch.Tensor, Dict]:
    """(loss, metrics) of the rows of every ``loss_terms`` in ``terms``
    together: the masked-token mean CE over all their tokens, plus
    ``router_aux_coef * moe_aux`` with each layer's load balance made
    from the sums of every part; metrics ``loss`` (the CE alone),
    ``tokens`` and each aux loss averaged over layers
    (``repro/models/transformer.py:380-396``).  One part gives the
    loss of its own rows."""
    count = _sum([t["tokens"] for t in terms])
    loss = _sum([t["ce_sum"] for t in terms]) / count.clamp_min(1.0)
    metrics = {"loss": loss, "tokens": count}
    aux_fn = family(cfg).aux_fn
    total: Dict[str, torch.Tensor] = {}
    for layer in zip(*(t["layers"] for t in terms)):
        if not layer[0]:
            continue
        sums = {k: _sum([a[k] for a in layer]) for k in layer[0]}
        for k, v in aux_fn(cfg, sums).items():
            total[k] = total.get(k, 0.0) + v
    if total:
        for k, v in total.items():
            metrics[k] = v / cfg.num_layers
        loss = loss + cfg.router_aux_coef * metrics.get("moe_aux", 0.0)
    return loss, metrics


def loss(cfg: ModelConfig, params: Params, batch):
    """(loss, metrics) of one batch: the train step's body."""
    return combine_loss(cfg, [loss_terms(cfg, params, batch)])


def prefill(cfg: ModelConfig, params: Params, batch, cache, lengths=None):
    return transformer.prefill(cfg, params, batch, cache, lengths=lengths,
                               layer_fn=family(cfg).layer_fn)


def decode(cfg: ModelConfig, params: Params, cache, tokens, t, active=None,
           page_tables=None, paged: Tuple[str, ...] = ()):
    return transformer.decode_step(cfg, params, cache, tokens, t, active,
                                   page_tables, paged, family(cfg).layer_fn)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    return family(cfg).cache_fn(cfg, batch, max_len, device)


@functools.lru_cache(maxsize=None)
def len_axes(cfg: ModelConfig, max_len: int) -> Dict[str, Optional[int]]:
    """Per cache leaf, the axis whose extent follows ``max_len``, or None
    for a leaf that has none (recurrent state, a rolling window narrower
    than ``max_len``).  Derived as the reference's ``_cache_len_axes``:
    where the cache's shape changes when ``max_len`` does."""
    a = init_cache(cfg, 1, max_len, "meta")
    b = init_cache(cfg, 1, max_len + 1, "meta")
    return {name: next((i for i, (x, y) in enumerate(zip(a[name].shape,
                                                         b[name].shape))
                        if x != y), None)
            for name in a}


@functools.lru_cache(maxsize=None)
def paged_leaves(cfg: ModelConfig, max_len: int) -> Tuple[str, ...]:
    """The cache leaves a paged pool pages, by the reference's rule: the
    length axis immediately follows the slot axis (axis 1 in every
    family) and has extent ``max_len``.  The other leaves stay per slot
    ("residual")."""
    row = init_cache(cfg, 1, max_len, "meta")
    return tuple(name for name, axis in len_axes(cfg, max_len).items()
                 if axis == 2 and row[name].shape[2] == max_len)


def init_paged_pool(cfg: ModelConfig, slots: int, max_len: int,
                    total_pages: int, page_size: int,
                    row: Dict[str, torch.Tensor]):
    """A paged pool on ``row``'s device: every leaf of
    :func:`paged_leaves` as (n, total_pages + 1, page_size, ...) pages
    (page ``total_pages`` is the null page that pads every table, never
    written), every other leaf per slot as (n, slots, ...), all at the
    init values of ``row``, the single-row ``init_cache(cfg, 1,
    max_len)``.  Raises the reference's ``ValueError`` when no leaf
    pages."""
    paged = paged_leaves(cfg, max_len)
    if not paged:
        raise ValueError(
            f"model family {cfg.family!r} has no pageable cache leaves "
            "(no full-context KV blocks)")
    pool = {}
    for name, leaf in row.items():
        if name in paged:
            page = leaf[:, :, :page_size]
            pool[name] = page.expand(page.shape[0], total_pages + 1,
                                     *page.shape[2:]).clone()
        else:
            pool[name] = leaf.expand(leaf.shape[0], slots,
                                     *leaf.shape[2:]).clone()
    return pool
