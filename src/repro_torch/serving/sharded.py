"""Tensor-parallel serving over a device mesh: the port's counterpart of
``repro/serving/sharded.py``.

A cost-modeled tier whose ``mesh_shape`` spans more than one device runs
its :class:`~repro_torch.serving.engine.Endpoint` through this module:
parameters and KV cache live sharded over the mesh's ``"model"`` axis,
one shard a device, and every prefill and decode step runs each shard's
local block.

The port is single-controller, as the reference is (one process drives
``shard_map`` over its mesh): one Python process holds every shard, and
a shard's work runs on its device.  The replicated part of a layer
(norms, residual stream, rope tables, the output projections after the
gather) runs once, on the mesh's first device, which is also the
endpoint's device; each shard reads the normed activations from there.
The reference replicates the step across the ``"data"`` axis as well;
that changes no output, so the port runs the ``"model"`` row of the
first ``"data"`` index.

The layout is the reference's **weight-gather** scheme:

* Column-parallel weights shard their output dim: ``wq``/``wk``/``wv``
  (and ``bq``/``bk``/``bv``) by heads, ``wi``/``wg`` by ffn columns,
  ``lm_head`` by vocab, the embed table by model dim: exactly
  :func:`repro_torch.launch.sharding.param_shardings`' ``serve_replicated``
  layout.
* Row-parallel weights (``attn/wo``, ``mlp/wo``) are stored sharded on
  their contraction dim and gathered, whole, right before their product,
  as are the activations feeding them (attention ``o``, the MLP's
  ``act``), the embeddings and the logits.  :func:`_gather` (copies to
  the first device and ``torch.cat``, a bitwise concatenation) is the
  scheme's only collective.
* Each shard's attention runs through :mod:`repro_torch.models.attention`
  on its local heads (K1 and K2 on a card, one launch per shard a
  layer); the kv-head sharding keeps the GQA group size, since
  :func:`validate_tp` requires both head counts to divide ``tp``.

The reference pins TP == unsharded bit for bit on XLA:CPU.  In torch a
product over half the output columns may sum in another order (torch
picks its GEMM tiling, and K2 its cluster split, by shape), so each
layer agrees with the unsharded one within the float tolerances and is
bitwise only where the backend keeps the order; over many bf16 layers
the logits drift as far as any reordering's do (ROADMAP §3 gives the
shapes and sizes).  The *pricing* of a sharded tier uses the other
scheme, psum TP (``launch/tier_cost.py``), which a multi-card
deployment would run.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import sharding as launch_sharding
from repro_torch.models import transformer
from repro_torch.models.common import (ModelConfig, Params, apply_norm,
                                       embed_tokens, layer_slice)
from repro_torch.sharding import Spec

AXIS = "model"                 # the TP axis (a tier's mesh is ("data", "model"))

Cache = Dict[str, torch.Tensor]


def tier_mesh(mesh_shape: Tuple[int, int],
              device: DeviceLike = "cuda") -> Optional[mesh_mod.Mesh]:
    """The tier's ``("data", "model")`` mesh over the host's devices of
    ``device``'s kind, or None with the reference's warning when the host
    has too few (the endpoint then deploys unsharded)."""
    need = int(mesh_shape[0]) * int(mesh_shape[1])
    have = mesh_mod.host_devices(resolve(device).type)
    if len(have) < need:
        warnings.warn(
            f"mesh_shape {tuple(mesh_shape)} needs {need} devices, host "
            f"has {len(have)}: deploying unsharded (bit-identical fallback)")
        return None
    return mesh_mod.make_mesh(tuple(int(a) for a in mesh_shape),
                              ("data", "model"), have)


def validate_tp(cfg: ModelConfig, tp: int) -> None:
    """Reject configs the weight-gather scheme cannot serve, with the
    reference's messages: the dense family only, an untied ``lm_head``,
    and every sharded width divisible by ``tp`` (replicating an
    indivisible one would change the layout the tests pin).  The
    reference's ``use_pallas`` refusal has no counterpart: the port picks
    its kernels by device, and a CUDA shard always launches them."""
    if tp <= 1:
        return
    if cfg.family != "dense":
        raise ValueError(
            f"tensor-parallel serving covers the dense family, "
            f"got {cfg.family!r}")
    if cfg.tie_embeddings:
        raise ValueError("tensor-parallel serving requires an untied "
                         "lm_head (vocab-sharded output head)")
    for field, value in (("num_heads", cfg.num_heads),
                         ("num_kv_heads", cfg.num_kv_heads),
                         ("d_ff", cfg.d_ff),
                         ("vocab_size", cfg.vocab_size),
                         ("d_model", cfg.d_model)):
        if value % tp:
            raise ValueError(
                f"exact TP needs {field} divisible by tp={tp}, "
                f"got {value}")


def model_devices(mesh: mesh_mod.Mesh) -> List[torch.device]:
    """The devices of the ``"model"`` axis at the first index of every
    other axis: one a shard, in shard order."""
    grid = np.moveaxis(mesh.devices, mesh.axis_names.index(AXIS), -1)
    return list(grid.reshape(-1, mesh.shape[AXIS])[0])


# --------------------------------------------------------------------------
# Specs, and placing params and caches on their shards
# --------------------------------------------------------------------------


def tp_param_specs(cfg: ModelConfig, mesh) -> Dict[str, Spec]:
    """The partition spec of every parameter path: the launch
    ``serve_replicated`` layout, which the weight-gather scheme stores."""
    return launch_sharding.param_shardings(cfg, mesh, "serve_replicated")


def tp_cache_specs(cache: Cache) -> Dict[str, Spec]:
    """The partition spec of every cache leaf: k/v (L,B,W,Hkv,Dh) shard
    their kv heads over the model axis (each shard owns its heads'
    history), ``pos`` is replicated.  Sharding the sequence instead would
    split the attention's contraction."""
    out = {}
    for name, leaf in cache.items():
        if name.rpartition("/")[2] in ("k", "v"):
            spec = [None] * leaf.ndim
            spec[leaf.ndim - 2] = AXIS
            out[name] = tuple(spec)
        else:
            out[name] = ()
    return out


def shard_axis(spec: Spec) -> Optional[int]:
    """The dimension ``spec`` shards over the model axis (None:
    replicated)."""
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        if entry != AXIS:
            raise ValueError(f"spec {spec}: the tensor-parallel endpoint "
                             f"shards over {AXIS!r} alone")
        return i
    return None


def split(t: torch.Tensor, spec: Spec, tp: int) -> List[torch.Tensor]:
    """``t``'s ``tp`` contiguous pieces along its sharded dimension, in
    shard order (``t`` itself ``tp`` times when replicated)."""
    axis = shard_axis(spec)
    if axis is None:
        return [t] * tp
    return list(t.chunk(tp, dim=axis))


def join(pieces: Sequence[torch.Tensor], spec: Spec,
         device: torch.device) -> torch.Tensor:
    """The tensor :func:`split` cut into ``pieces``, a new tensor on
    ``device`` (a replicated tensor's first piece, copied)."""
    axis = shard_axis(spec)
    if axis is None:
        return pieces[0].to(device, copy=True)
    return _gather(pieces, axis, device)


def _place(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A contiguous copy of ``t`` on ``device``."""
    return torch.empty(t.shape, dtype=t.dtype, device=device).copy_(t)


def shard_params(params: Params, mesh: mesh_mod.Mesh,
                 specs: Dict[str, Spec]) -> List[Params]:
    """One param dict a shard, each on its device: a sharded leaf's
    contiguous slice (a copy), a replicated leaf as it is (moved when the
    shard's device differs)."""
    devices = model_devices(mesh)
    pieces = {k: split(v, specs[k], len(devices)) for k, v in params.items()}
    return [{k: (v[s].to(dev) if shard_axis(specs[k]) is None
                 else _place(v[s], dev)) for k, v in pieces.items()}
            for s, dev in enumerate(devices)]


def shard_cache(cache: Cache, mesh: mesh_mod.Mesh,
                specs: Dict[str, Spec]) -> List[Cache]:
    """One cache dict a shard, each leaf a copy on the shard's device:
    its kv heads of k/v, and its own ``pos``."""
    devices = model_devices(mesh)
    pieces = {k: split(v, specs[k], len(devices)) for k, v in cache.items()}
    return [{k: _place(v[s], dev) for k, v in pieces.items()}
            for s, dev in enumerate(devices)]


def init_cache(cfg: ModelConfig, mesh: mesh_mod.Mesh, batch: int,
               max_len: int) -> List[Cache]:
    """``shard_cache`` of ``transformer.init_cache(cfg, batch, max_len)``,
    built in place on each shard's device (the init values do not depend
    on the head, so each shard's slice is its local heads' init)."""
    devices = model_devices(mesh)
    local = dataclasses.replace(cfg,
                                num_kv_heads=cfg.num_kv_heads // len(devices))
    return [transformer.init_cache(local, batch, max_len, dev)
            for dev in devices]


# --------------------------------------------------------------------------
# The per-layer block (transformer.dense_layer, op for op)
# --------------------------------------------------------------------------


def _gather(pieces: Sequence[torch.Tensor], dim: int,
            device: torch.device) -> torch.Tensor:
    """The weight-gather scheme's collective, ``all_gather(tiled=True)``:
    every shard's piece copied to ``device`` and concatenated along
    ``dim``, bit for bit."""
    return torch.cat([p.to(device) for p in pieces], dim=dim)


def _on(t: Optional[torch.Tensor], device: torch.device):
    return None if t is None else t.to(device)


class _Shards:
    """Every shard's stacked per-layer tensors, indexed by layer: ``[i]``
    is the list of the shards' layer-``i`` dicts.  Given to
    ``transformer.forward`` under the key ``shards`` of its params and of
    its cache, it reaches the layer function as one layer's slices do."""

    def __init__(self, stacks: Sequence[Dict[str, torch.Tensor]]):
        self.stacks = stacks

    def __getitem__(self, i: int) -> List[Dict[str, torch.Tensor]]:
        return [{k: v[i] for k, v in s.items()} for s in self.stacks]


def _tp_attention_block(devices: Sequence[torch.device], cfg: ModelConfig,
                        shards, caches, x: torch.Tensor,
                        positions: torch.Tensor, mode: str, rows, rope,
                        layer_idx: Optional[int],
                        prefix: str = "attn/") -> torch.Tensor:
    """``transformer.attention_block`` with each shard's local heads
    (``transformer.attend``: projection, rope, cache write, kernel), then
    ``o`` and the contraction-sharded ``wo`` gathered, so the output
    product is the unsharded one verbatim."""
    out = x.device
    h = apply_norm(cfg, shards[0], prefix + "norm", x)
    o = [transformer.attend(cfg, ps, _on(h, d), _on(positions, d), c, mode,
                            _on(rows, d), prefix=prefix,
                            rope=tuple(_on(t, d) for t in rope),
                            layer_idx=layer_idx)
         for ps, c, d in zip(shards, caches, devices)]
    o = _gather(o, 2, out)                                   # (B,S,Hq,Dh)
    wo = _gather([ps[prefix + "wo"] for ps in shards], 0, out)  # (Hq,Dh,d)
    B, S = o.shape[:2]
    return o.reshape(B, S, -1) @ wo.to(x.dtype).reshape(-1, wo.shape[-1])


def _tp_mlp_block(devices: Sequence[torch.device], cfg: ModelConfig,
                  shards, x: torch.Tensor,
                  prefix: str = "mlp/") -> torch.Tensor:
    """``transformer.mlp_block`` with each shard's ffn columns, then
    ``act`` and the contraction-sharded ``wo`` gathered."""
    out = x.device
    h = apply_norm(cfg, shards[0], prefix + "norm", x)
    act = _gather([transformer.mlp_act(cfg, ps, _on(h, d), prefix)
                   for ps, d in zip(shards, devices)], 2, out)   # (B,S,F)
    wd = _gather([ps[prefix + "wo"] for ps in shards], 0, out)  # (F,d)
    return act @ wd.to(x.dtype)


def _tp_layer(devices: Sequence[torch.device], cfg: ModelConfig, p,
              x: torch.Tensor, positions: torch.Tensor, cache, mode: str,
              rows: Optional[torch.Tensor] = None, rope=None, paging=None,
              layer_idx: Optional[int] = None) -> torch.Tensor:
    """``transformer.dense_layer`` over the shards: ``p`` and ``cache``
    hold every shard's layer slices under ``shards``."""
    shards = p["shards"]
    x = x + _tp_attention_block(devices, cfg, shards, cache["shards"], x,
                                positions, mode, rows, rope, layer_idx)
    return x + _tp_mlp_block(devices, cfg, shards, x)


def _tp_embeds(cfg: ModelConfig, devices: Sequence[torch.device],
               params: Sequence[Params], tokens: torch.Tensor,
               offset: Optional[torch.Tensor] = None):
    """``transformer.assemble_embeds`` with the model-dim-sharded table:
    each shard's rows of its columns, gathered.  Returns (embeddings,
    positions) on the first device."""
    emb = _gather([embed_tokens(ps["embed"], _on(tokens, d),
                                cfg.compute_dtype)
                   for ps, d in zip(params, devices)], 2, devices[0])
    batch = {"embeds": emb}
    if offset is not None:
        batch["offset"] = offset
    return transformer.assemble_embeds(cfg, {}, batch)


def _tp_output_head(cfg: ModelConfig, devices: Sequence[torch.device],
                    params: Sequence[Params], x: torch.Tensor
                    ) -> torch.Tensor:
    """``transformer.output_head`` on each vocab shard of ``lm_head``,
    the logits gathered (``validate_tp`` refuses a tied head)."""
    return _gather([transformer.output_head(cfg, ps, _on(x, d))
                    for ps, d in zip(params, devices)], -1, devices[0])


# --------------------------------------------------------------------------
# The endpoint's model functions
# --------------------------------------------------------------------------


def make_tp_functions(cfg: ModelConfig, mesh: mesh_mod.Mesh, cache: Cache):
    """Build ``(tp_prefill, tp_decode, param_specs, cache_specs)`` for
    ``cfg`` on ``mesh`` (``cache``: a logical cache, for its specs).

    ``tp_prefill(params, tokens, lengths, caches)`` mirrors
    ``transformer.prefill`` with ``lengths`` always given;
    ``tp_decode(params, caches, tokens, t, active=None)`` mirrors
    ``transformer.decode_step``.  ``params`` and ``caches`` are the lists
    :func:`shard_params` and :func:`shard_cache` (or :func:`init_cache`)
    give, written in place; tokens, positions and the returned logits
    live on the mesh's first device."""
    devices = model_devices(mesh)
    validate_tp(cfg, len(devices))
    layer_fn = functools.partial(_tp_layer, devices)

    def run(params, caches, emb, positions, mode, rows=None):
        stacks = _Shards([layer_slice(ps)[0] for ps in params])
        return transformer.forward(cfg, {"layers/shards": stacks}, emb,
                                   positions, {"shards": _Shards(caches)},
                                   mode, rows, layer_fn=layer_fn)

    def tp_prefill(params, tokens, lengths, caches):
        emb, positions = _tp_embeds(cfg, devices, params, tokens)
        x = run(params, caches, emb, positions, "prefill")
        logits = _tp_output_head(cfg, devices, params,
                                 transformer.last_hidden(x, lengths))
        return logits[:, 0], caches

    def tp_decode(params, caches, tokens, t, active=None):
        emb, positions = _tp_embeds(cfg, devices, params, tokens[:, None], t)
        x = run(params, caches, emb, positions, "decode",
                transformer.active_rows(active, devices[0]))
        return _tp_output_head(cfg, devices, params, x)[:, 0], caches

    return tp_prefill, tp_decode, tp_param_specs(cfg, mesh), \
        tp_cache_specs(cache)
