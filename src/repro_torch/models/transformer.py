"""Decoder-only transformer stack (the dense family of the reference, and
the layer loop, attention and caches that other families reuse).

The counterpart of ``repro/models/transformer.py``.  Parameters are the
reference's flat dict with per-layer weights stacked on a leading
``layers`` axis; the layer stack is a Python loop over that axis, calling
the family's layer function (``dense_layer`` here; ``hymba.hymba_layer``)
with the layer's index.

The KV cache is a flat dict of stacked leaves, each with the slot (batch)
axis at 1.  Layers whose attention caches have the same width share one
stack: ``{"k", "v": (L, B, W, Hkv, Dh), "pos": (L, B, W) int32}`` when
every layer has the same window (the reference's scan layout), else one
stack per kind, ``"window/k"``... over the sliding-window layers (rolling
width ``min(window, max_len)``) and ``"global/k"``... over the global ones
(width ``max_len``), where the reference keeps a list of per-layer dicts.
A leaf named ``group/key`` stacks the layers of its group, a bare name
every layer (a family's per-layer state, such as hymba's ``h`` and
``conv``); :func:`layer_caches` gives each layer its slices.  ``pos = -1``
marks an empty slot.

Unlike the reference, which returns a new cache, the port writes the
cache **in place** (a full-width cache is gigabytes; copying it per step
would dominate decode) and returns the same dict.  ``decode_step`` takes
an optional per-row ``active`` mask: rows outside it are not written, so
their cache stays bit-for-bit as it was — the contract the reference's
engine gets from ``jnp.where(active, new, old)``.

Modes: ``prefill`` (full sequence, fills the cache), ``decode`` (one
token per row against the cache) and ``train`` (full sequence, no cache;
:func:`loss_terms`).  In ``train`` a layer function returns ``(x, aux)``,
the sums its aux losses are made of (MoE's, ``models/moe.py``), and
:func:`forward` returns ``(x, [aux of each layer])``; prefill and decode
return ``x`` alone.  :func:`loss_terms` gives a batch's loss as sums
(``model_zoo.combine_loss`` divides them), so a sharded step can add the
sums of its data replicas first.  With ``cfg.remat`` each layer (or
group of ``cfg.remat_group`` layers) runs under
``torch.utils.checkpoint``: the backward recomputes it from its input, so
kernel K1 runs twice a layer in a train step.

Decode also runs against a **paged pool**
(``model_zoo.init_paged_pool``): each paged stack as (n, P+1, page,
...) pages, page ``P`` the reserved null page (pos -1 for ever), and a
``(B, ppr)`` page table per step.  Row b's position t lives at page
``table[b, (t % W) // page]``, offset ``t % page`` (``W = ppr * page =
max_len``): the dense rolling layout with one indirection, so attention
reads the pool in place (kernel K3) and the token stream equals the
dense one.  The stacks the pool does not page (hymba's rolling-window
stacks and SSM state) stay per slot in the same dict, and their layers
decode as in a dense cache.  Prefill always fills a dense cache; the
serving engine copies it into pages.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.models import attention
from repro_torch.models.common import (ModelConfig, ParamSpec, Params,
                                       activate, apply_norm, apply_rope,
                                       embed_tokens, layer_slice,
                                       norm_specs, rope_tables,
                                       stack_layers, xent_sums)

Cache = Dict[str, torch.Tensor]

#: the last name parts of the cache leaves with a position axis (axis 2):
#: a decode step writes one position of each row there, and rewrites the
#: other leaves (a family's recurrent state) whole
POSITION_LEAVES = ("k", "v", "pos")


# --------------------------------------------------------------------------
# Parameter tables (identical keys and shapes to the reference)
# --------------------------------------------------------------------------


def _prefixed(prefix: str, table: Dict[str, ParamSpec]) -> Dict[str, ParamSpec]:
    return {prefix + k: v for k, v in table.items()}


def attn_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, Hq, Hkv, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    t = {
        "wq": ParamSpec((d, Hq, Dh), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, Hkv, Dh), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, Hkv, Dh), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((Hq, Dh, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        t["bq"] = ParamSpec((Hq, Dh), ("heads", "head_dim"), "zeros")
        t["bk"] = ParamSpec((Hkv, Dh), ("kv_heads", "head_dim"), "zeros")
        t["bv"] = ParamSpec((Hkv, Dh), ("kv_heads", "head_dim"), "zeros")
    t.update(_prefixed("norm/", norm_specs(cfg)))
    return t


def mlp_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, F = cfg.d_model, cfg.d_ff
    t = {"wi": ParamSpec((d, F), ("embed", "ffn")),
         "wo": ParamSpec((F, d), ("ffn", "embed"))}
    if cfg.activation == "swiglu":
        t["wg"] = ParamSpec((d, F), ("embed", "ffn"))
    t.update(_prefixed("norm/", norm_specs(cfg)))
    return t


def dense_layer_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    return {**_prefixed("attn/", attn_specs(cfg)),
            **_prefixed("mlp/", mlp_specs(cfg))}


def head_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    """Embedding + final norm + output head."""
    t = {"embed": ParamSpec((cfg.vocab_size, cfg.d_model),
                            ("vocab_in", "embed_table")),
         **_prefixed("final_norm/", norm_specs(cfg))}
    if not cfg.tie_embeddings:
        t["lm_head"] = ParamSpec((cfg.vocab_size, cfg.d_model),
                                 ("vocab", "embed"))
    return t


def param_table(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    return {**head_specs(cfg),
            **stack_layers(dense_layer_specs(cfg), cfg.num_layers)}


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------


def _window_for_layer(cfg: ModelConfig,
                      layer_idx: Optional[int]) -> Optional[int]:
    """Static per-layer sliding window (hymba: some layers are global)."""
    if cfg.sliding_window is None:
        return None
    if layer_idx is not None and layer_idx in cfg.global_layers:
        return None
    return cfg.sliding_window


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d) @ w (d, *out) -> (..., *out), in x.dtype."""
    d = w.shape[0]
    y = x @ w.to(x.dtype).reshape(d, -1)
    return y.reshape(*x.shape[:-1], *w.shape[1:])


def qkv_project(cfg: ModelConfig, p: Params, x: torch.Tensor,
                positions: torch.Tensor, prefix: str = "attn/", rope=None):
    """x (B,S,d) -> q (B,S,Hq,Dh), k/v (B,S,Hkv,Dh), rope applied
    (``rope``: the forward pass's :func:`rope_tables`, when built)."""
    q = _proj(x, p[prefix + "wq"])
    k = _proj(x, p[prefix + "wk"])
    v = _proj(x, p[prefix + "wv"])
    if cfg.qkv_bias:
        q = q + p[prefix + "bq"].to(x.dtype)
        k = k + p[prefix + "bk"].to(x.dtype)
        v = v + p[prefix + "bv"].to(x.dtype)
    q = apply_rope(q, positions, cfg.rope_theta, rope)
    k = apply_rope(k, positions, cfg.rope_theta, rope)
    return q, k, v.contiguous()


def _cache_write(cache: Cache, k: torch.Tensor, v: torch.Tensor,
                 positions: torch.Tensor,
                 rows: Optional[torch.Tensor] = None) -> None:
    """Write new k/v (B,S,Hkv,Dh) in place at slots pos % W (rolling or
    full), for every row or only the row indices in ``rows``.

    For rolling caches only the last W tokens are written (earlier ones
    would be overwritten anyway; slicing keeps the slots unique).
    """
    W = cache["k"].shape[1]
    if positions.shape[1] > W:
        k, v, positions = k[:, -W:], v[:, -W:], positions[:, -W:]
    if rows is None:
        rows = torch.arange(positions.shape[0], device=positions.device)
    else:
        k, v, positions = k[rows], v[rows], positions[rows]
    slots = positions.remainder(W)                          # (n,S)
    b = rows[:, None]
    cache["k"][b, slots] = k.to(cache["k"].dtype)
    cache["v"][b, slots] = v.to(cache["v"].dtype)
    cache["pos"][b, slots] = positions.to(cache["pos"].dtype)


def _page_write(pool: Cache, k: torch.Tensor, v: torch.Tensor,
                positions: torch.Tensor, paging) -> None:
    """The paged counterpart of :func:`_cache_write` for one decode token
    per row: write k/v (B,1,Hkv,Dh) of the rows in ``paging.rows`` in
    place at their (page, offset)."""
    rows, pages, offs = paging.rows, paging.write_pages, paging.write_offsets
    pool["k"][pages, offs] = k[rows, 0].to(pool["k"].dtype)
    pool["v"][pages, offs] = v[rows, 0].to(pool["v"].dtype)
    pool["pos"][pages, offs] = positions[rows, 0].to(pool["pos"].dtype)


def attend(cfg: ModelConfig, p: Params, h: torch.Tensor,
           positions: torch.Tensor, cache: Optional[Cache], mode: str,
           rows: Optional[torch.Tensor] = None, prefix: str = "attn/",
           rope=None, paging: Optional["Paging"] = None,
           layer_idx: Optional[int] = None) -> torch.Tensor:
    """The attention heads of the normed input ``h`` (B,S,d): q/k/v
    projection, rope, the cache write (in place) and the attention
    kernel.  Returns o (B,S,Hq,Dh), before the output projection."""
    window = _window_for_layer(cfg, layer_idx)
    q, k, v = qkv_project(cfg, p, h, positions, prefix, rope)
    if mode == "decode" and paging is not None:
        _page_write(cache, k, v, positions, paging)
        o = attention.paged_decode_attention(
            cfg, q[:, 0], cache["k"], cache["v"], paging.tables,
            positions[:, 0].contiguous(), cache["pos"], window=window)
        o = o[:, None]                                        # (B,1,Hq,Dh)
    elif mode == "decode":
        # x: (B,1,d); the cache holds the history INCLUDING this token
        _cache_write(cache, k, v, positions, rows)
        o = attention.decode_attention(cfg, q[:, 0], cache["k"], cache["v"],
                                       positions[:, 0].contiguous(),
                                       cache["pos"], window=window)
        o = o[:, None]                                        # (B,1,Hq,Dh)
    else:
        o = attention.flash_attention(cfg, q, k, v, positions, positions,
                                      causal=True, window=window)
        if mode == "prefill":
            _cache_write(cache, k, v, positions)
    return o


def attention_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                    positions: torch.Tensor, cache: Optional[Cache],
                    mode: str, rows: Optional[torch.Tensor] = None,
                    prefix: str = "attn/", rope=None,
                    paging: Optional["Paging"] = None,
                    layer_idx: Optional[int] = None) -> torch.Tensor:
    """Pre-norm attention residual branch (writes ``cache`` in place)."""
    h = apply_norm(cfg, p, prefix + "norm", x)
    o = attend(cfg, p, h, positions, cache, mode, rows, prefix, rope,
               paging, layer_idx)
    B, S = o.shape[:2]
    wo = p[prefix + "wo"]
    return o.reshape(B, S, -1) @ wo.to(x.dtype).reshape(-1, wo.shape[-1])


def mlp_act(cfg: ModelConfig, p: Params, h: torch.Tensor,
            prefix: str = "mlp/") -> torch.Tensor:
    """The MLP's hidden activation of the normed input ``h``, before its
    down projection."""
    gate = h @ p[prefix + "wi"].to(h.dtype)
    up = h @ p[prefix + "wg"].to(h.dtype) if cfg.activation == "swiglu" \
        else None
    return activate(cfg, gate, up)


def mlp_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
              prefix: str = "mlp/") -> torch.Tensor:
    h = apply_norm(cfg, p, prefix + "norm", x)
    return mlp_act(cfg, p, h, prefix) @ p[prefix + "wo"].to(x.dtype)


def dense_layer(cfg: ModelConfig, p: Params, x: torch.Tensor,
                positions: torch.Tensor, cache: Optional[Cache], mode: str,
                rows: Optional[torch.Tensor] = None,
                rope=None, paging: Optional["Paging"] = None,
                layer_idx: Optional[int] = None):
    x = x + attention_block(cfg, p, x, positions, cache, mode, rows,
                            rope=rope, paging=paging, layer_idx=layer_idx)
    x = x + mlp_block(cfg, p, x)
    return (x, {}) if mode == "train" else x


#: a family's layer function: (cfg, p, x, positions, layer_cache, mode,
#: rows, rope, paging, layer_idx) -> x, or (x, aux) in mode "train"
LayerFn = Callable[..., torch.Tensor]


def forward(cfg: ModelConfig, params: Params, embeds: torch.Tensor,
            positions: torch.Tensor, cache: Optional[Cache], mode: str,
            rows: Optional[torch.Tensor] = None,
            paging: Optional["Paging"] = None,
            layer_fn: LayerFn = dense_layer) -> torch.Tensor:
    """Run the layer stack (a loop over the stacked ``layers`` axis);
    layer i reads and writes its slices of every cache leaf
    (:func:`layer_caches`); ``paging`` goes to the layers whose attention
    stack lives in the page pool.  Mode ``train`` returns (x, aux sums)
    (:func:`_train_forward`)."""
    if mode == "train":
        return _train_forward(cfg, params, embeds, positions, layer_fn)
    stacked, _ = layer_slice(params)
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    views = layer_caches(cfg, cache) if cache is not None else None
    paged_layers = set()
    if paging is not None:
        paged_layers = {i for group, layers in cache_groups(cfg).items()
                        if group in paging.groups for i in layers}
    x = embeds
    for i in range(cfg.num_layers):
        layer_params = {k: v[i] for k, v in stacked.items()}
        x = layer_fn(cfg, layer_params, x, positions,
                     views[i] if views is not None else None, mode, rows,
                     rope, paging if i in paged_layers else None, i)
    return x


def _train_forward(cfg: ModelConfig, params: Params, x: torch.Tensor,
                   positions: torch.Tensor, layer_fn: LayerFn):
    """The layer stack without a cache, recomputed in the backward as
    ``cfg.remat`` and ``cfg.remat_group`` say (the reference's
    ``repro/models/transformer.py:287-327``).  Returns (x, the list of
    each layer's aux dict, in layer order).

    Each layer reads its weights through one ``unbind`` of every stacked
    leaf, so the backward stacks a leaf's per-layer gradients once
    instead of adding a full-size zero-padded copy per layer."""
    stacked, _ = layer_slice(params)
    per_layer = {k: v.unbind(0) for k, v in stacked.items()}
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)

    def layer(i, x):
        p = {k: v[i] for k, v in per_layer.items()}
        return layer_fn(cfg, p, x, positions, None, "train", None, rope,
                        None, i)

    def remat(fn, *args):
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False)

    L = cfg.num_layers
    G = cfg.remat_group if cfg.remat else 1
    aux: List[Dict] = []
    if G > 1 and L % G == 0:
        # two levels: the stack keeps only each group's input, and the
        # group's recompute keeps only each of its layers' inputs
        def group(first, x):
            out = []
            for i in range(first, first + G):
                x, a = remat(layer, i, x)
                out.append(a)
            return x, out

        for first in range(0, L, G):
            x, a = remat(group, first, x)
            aux.extend(a)
    else:
        for i in range(L):
            x, a = remat(layer, i, x) if cfg.remat else layer(i, x)
            aux.append(a)
    return x, aux


# --------------------------------------------------------------------------
# Top-level model functions
# --------------------------------------------------------------------------


def assemble_embeds(cfg: ModelConfig, params: Params,
                    batch: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token/frontend embeddings (B,S,d) + absolute positions (B,S) int32
    over the whole stream (``batch["offset"]`` (B,) shifts each row's).

    ``batch`` carries "tokens" (B,S) and, as in the reference,
    optionally "embeds" (B,E,d), a precomputed stream appended after the
    tokens, and "patches" (B,P,d), a vision prefix put in front of
    everything (the modality encoder is a stub).  Audio is token ids over
    the codebook: a plain LM.
    """
    emb = None
    if "tokens" in batch:
        emb = embed_tokens(params["embed"], batch["tokens"],
                           cfg.compute_dtype)
    if "embeds" in batch:
        e = batch["embeds"].to(cfg.compute_dtype)
        emb = e if emb is None else torch.cat([emb, e], dim=1)
    if "patches" in batch:
        pt = batch["patches"].to(cfg.compute_dtype)
        emb = pt if emb is None else torch.cat([pt, emb], dim=1)
    B, S = emb.shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=emb.device)[None]
    offset = batch.get("offset")
    if offset is not None:
        positions = positions + offset[:, None].to(torch.int32)
    return emb, positions.expand(B, S).contiguous()


def output_head(cfg: ModelConfig, params: Params,
                x: torch.Tensor) -> torch.Tensor:
    """Final norm + float32 logits for the given hidden states."""
    x = apply_norm(cfg, params, "final_norm", x)
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return x.float() @ w.float().t()


def loss_terms(cfg: ModelConfig, params: Params,
               batch: Dict[str, torch.Tensor],
               layer_fn: LayerFn = dense_layer) -> Dict:
    """A batch's loss as the sums it is made of: ``ce_sum`` and
    ``tokens``, the masked token CE's sum and count
    (``batch["labels"]``: the next tokens, -1 masked; a vision prefix
    carries no labels), and ``layers``, each layer's aux sums.
    ``model_zoo.combine_loss`` makes the loss and its metrics from them
    (``repro/models/transformer.py:380-396``)."""
    emb, positions = assemble_embeds(cfg, params, batch)
    x, aux = forward(cfg, params, emb, positions, None, "train",
                     layer_fn=layer_fn)
    x = apply_norm(cfg, params, "final_norm", x)
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    labels = batch["labels"]
    if x.shape[1] != labels.shape[1]:          # vision prefix: no labels
        x = x[:, x.shape[1] - labels.shape[1]:]
    ce_sum, count = xent_sums(x, w, labels, cfg.ce_chunk)
    return {"ce_sum": ce_sum, "tokens": count, "layers": aux}


def cache_groups(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """The layers that share one attention-cache stack, by key prefix:
    ``""`` when every layer has the same window, else ``"window/"`` (the
    sliding-window layers) and ``"global/"`` (the full-attention ones)."""
    by_window: Dict[Optional[int], List[int]] = {}
    for i in range(cfg.num_layers):
        by_window.setdefault(_window_for_layer(cfg, i), []).append(i)
    if len(by_window) == 1:
        return {"": tuple(range(cfg.num_layers))}
    return {("global/" if w is None else "window/"): tuple(layers)
            for w, layers in by_window.items()}


def layer_caches(cfg: ModelConfig, cache: Cache) -> List[Cache]:
    """Every layer's slices of the cache leaves, as views (writes land in
    the cache): a leaf ``group/key`` gives its group's layers their slice
    under ``key``; a bare name gives every layer its slice."""
    groups = cache_groups(cfg)
    views: List[Cache] = [{} for _ in range(cfg.num_layers)]
    for name, leaf in cache.items():
        group, _, key = name.rpartition("/")
        layers = groups[group + "/"] if group else range(cfg.num_layers)
        for j, i in enumerate(layers):
            views[i][key] = leaf[j]
    return views


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device=None) -> Cache:
    """Allocate the KV cache: per :func:`cache_groups` stack, k/v
    (n_layers, B, W, Hkv, Dh) zeros and pos (n_layers, B, W) = -1, with
    W = ``min(window, max_len)`` on sliding-window layers and ``max_len``
    on the others."""
    Hkv, Dh = cfg.num_kv_heads, cfg.head_dim
    cache: Cache = {}
    for prefix, layers in cache_groups(cfg).items():
        w = _window_for_layer(cfg, layers[0])
        W = max_len if w is None else min(w, max_len)
        kv = (len(layers), batch_size, W, Hkv, Dh)
        cache[prefix + "k"] = torch.zeros(kv, dtype=cfg.compute_dtype,
                                          device=device)
        cache[prefix + "v"] = torch.zeros(kv, dtype=cfg.compute_dtype,
                                          device=device)
        cache[prefix + "pos"] = torch.full((len(layers), batch_size, W), -1,
                                           dtype=torch.int32, device=device)
    return cache


class Paging(NamedTuple):
    """One decode step's view of the page tables, built once and handed
    to the layers of the paged stacks: the (B, ppr) tables, for each
    written row its row index, physical page and offset in the page, and
    the :func:`cache_groups` prefixes of the stacks that live in the
    pool."""
    tables: torch.Tensor
    rows: torch.Tensor
    write_pages: torch.Tensor
    write_offsets: torch.Tensor
    groups: frozenset


def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            cache: Cache, lengths: Optional[torch.Tensor] = None,
            layer_fn: LayerFn = dense_layer):
    """Full-sequence forward; fills ``cache`` in place.
    Returns (last_logits (B,V) float32, cache).

    ``lengths`` (B,) selects each row's true last prompt position when the
    batch is right-padded to a shared bucket length (causal masking keeps
    positions < length unaffected by the padding; padded cache positions
    carry pos > t and stay masked until decode overwrites them).
    """
    emb, positions = assemble_embeds(cfg, params, batch)
    x = forward(cfg, params, emb, positions, cache, "prefill",
                layer_fn=layer_fn)
    return output_head(cfg, params, last_hidden(x, lengths))[:, 0], cache


def last_hidden(x: torch.Tensor,
                lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """x (B,S,d) at each row's last prompt position, (B,1,d): ``S - 1``,
    or ``lengths - 1`` for a right-padded batch."""
    B, S = x.shape[:2]
    if lengths is None:
        return x[:, -1:]
    idx = (torch.as_tensor(lengths, device=x.device).long() - 1
           ).clamp(0, S - 1)
    return x[torch.arange(B, device=x.device), idx][:, None]


def active_rows(active: Optional[torch.Tensor],
                device: torch.device) -> Optional[torch.Tensor]:
    """The row indices of a (B,) bool ``active`` mask, on ``device`` (None
    for None).  The mask is read on the host (the engine's lives there),
    so a step issues no device-to-host sync."""
    if active is None:
        return None
    return torch.nonzero(active.cpu().to(torch.bool)).squeeze(1).to(device)


def decode_step(cfg: ModelConfig, params: Params, cache: Cache,
                tokens: torch.Tensor, t: torch.Tensor,
                active: Optional[torch.Tensor] = None,
                page_tables: Optional[torch.Tensor] = None,
                paged: Tuple[str, ...] = (),
                layer_fn: LayerFn = dense_layer):
    """One decode step. tokens: (B,), t: (B,) current positions; ``active``
    (B,) bool limits the cache writes to those rows.  With ``page_tables``
    (B, ppr) int32 on the tokens' device, ``cache`` is a page pool
    (``model_zoo.init_paged_pool``) whose leaves named in ``paged`` are
    pages.  Returns (logits (B,V) float32, cache)."""
    batch = {"tokens": tokens[:, None], "offset": t}
    emb, positions = assemble_embeds(cfg, params, batch)
    rows = active_rows(active, tokens.device)
    paging = None
    if page_tables is not None:
        page = cache[paged[0]].shape[2]
        W = page_tables.shape[1] * page
        if rows is None:
            rows = torch.arange(tokens.shape[0], device=tokens.device)
        slot = t[rows].long().remainder(W)
        paging = Paging(page_tables, rows,
                        page_tables[rows, slot // page].long(),
                        slot.remainder(page),
                        frozenset(name[:name.rfind("/") + 1]
                                  for name in paged))
    x = forward(cfg, params, emb, positions, cache, "decode", rows, paging,
                layer_fn)
    return output_head(cfg, params, x)[:, 0], cache
