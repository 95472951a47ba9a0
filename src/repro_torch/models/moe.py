"""Mixture-of-Experts FFN (qwen2-moe, mixtral): the counterpart of
``repro/models/moe.py``.

The reference's semantics, kept exactly:

* **Routing** in float32: router logits, a softmax, the top ``K``
  experts (on a tie the lower expert index first, as ``jax.lax.top_k``;
  a stable sort gives that order, ``torch.topk`` promises none), gate
  values renormalised over the ``K`` before any drop.
* **Capacity per group**, a group being one batch row:
  ``C = ceil(S * K * capacity_factor / E)`` over the row's own ``S``.  A
  (token, k) slot's place in its expert's queue is the count of earlier
  slots routed there, in the order ``s * K + k``; a slot at place ``C``
  or beyond drops that expert's contribution only.
* **Dispatch and combine** through an (E, C) buffer per row: kept slots
  land at ``expert * C + place``, dropped ones in one overflow row that
  is thrown away; one batched product runs every expert over its ``C``
  rows; the kept rows are gathered back and summed over ``K`` in float32
  with the gate weights, then cast.
* **Shared experts** (qwen2-moe): a dense FFN on every token, gated by a
  float32 sigmoid.

The reference has no Pallas kernel here: its dispatch is einsums and
``segment_sum``, so the expert products are ``torch.bmm``.  At decode
``C = 1`` and a step reads every expert's weights whatever the batch;
a grouped product over the routed experts alone is later work.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import transformer
from repro_torch.models.common import (ModelConfig, ParamSpec, Params,
                                       activate, apply_norm, norm_specs,
                                       stack_layers)


def moe_ffn_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, E, F_ = cfg.d_model, cfg.num_experts, cfg.moe_d_ff or cfg.d_ff
    t = {
        "router": ParamSpec((d, E), ("embed", None)),
        "experts/wi": ParamSpec((E, d, F_), ("experts", "embed", "ffn")),
        "experts/wo": ParamSpec((E, F_, d), ("experts", "ffn", "embed")),
    }
    if cfg.activation == "swiglu":
        t["experts/wg"] = ParamSpec((E, d, F_), ("experts", "embed", "ffn"))
    if cfg.num_shared_experts > 0:
        Fs = cfg.shared_d_ff or cfg.num_shared_experts * F_
        t["shared/wi"] = ParamSpec((d, Fs), ("embed", "ffn"))
        t["shared/wo"] = ParamSpec((Fs, d), ("ffn", "embed"))
        if cfg.activation == "swiglu":
            t["shared/wg"] = ParamSpec((d, Fs), ("embed", "ffn"))
        t["shared/gate"] = ParamSpec((d, 1), ("embed", None), "zeros")
    t.update({f"norm/{k}": v for k, v in norm_specs(cfg).items()})
    return t


def moe_layer_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    return {**{f"attn/{k}": v for k, v in transformer.attn_specs(cfg).items()},
            **{f"moe/{k}": v for k, v in moe_ffn_specs(cfg).items()}}


def param_table(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    return {**transformer.head_specs(cfg),
            **stack_layers(moe_layer_specs(cfg), cfg.num_layers)}


def _capacity(cfg: ModelConfig, group_tokens: int) -> int:
    c = math.ceil(group_tokens * cfg.top_k * cfg.capacity_factor
                  / max(cfg.num_experts, 1))
    return max(int(c), 1)


def _route(cfg: ModelConfig, h: torch.Tensor, router: torch.Tensor):
    """h (B,S,d) -> (logits, probs (B,S,E), gate values, gate indices
    (B,S,K)), all float32 but the int64 indices."""
    logits = h.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    K = cfg.top_k
    gate_vals, gate_idx = vals[..., :K], idx[..., :K]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp_min(
        1e-9)
    return logits, probs, gate_vals, gate_idx


def _slots(gate_idx: torch.Tensor, E: int, C: int) -> torch.Tensor:
    """Each (token, k) slot's row in its group's (E*C + 1)-row buffer
    (B, S*K): ``expert * C + place``, or ``E * C`` (the overflow row)
    for a slot at place >= C."""
    B = gate_idx.shape[0]
    flat = gate_idx.reshape(B, -1)
    # the count runs along the slots, kept the innermost axis: a scan
    # along an outer axis took 0.39 ms a layer at a 512-token prefill
    onehot = F.one_hot(flat, E).transpose(1, 2).contiguous()  # (B,E,S*K)
    before = onehot.cumsum(dim=2) - onehot
    place = before.gather(1, flat[:, None, :])[:, 0]
    return torch.where(place < C, flat * C + place,
                       torch.full_like(flat, E * C))


def _dispatch(h: torch.Tensor, dest: torch.Tensor, K: int,
              rows: int) -> torch.Tensor:
    """Scatter each slot's token into its buffer row: (B, rows, d), the
    rows no slot reached zero (the overflow row collects the dropped
    slots and is never read back)."""
    B, S, d = h.shape
    hk = h[:, :, None, :].expand(B, S, K, d).reshape(B, S * K, d)
    buf = h.new_zeros(B, rows, d)
    return buf.scatter_(1, dest[..., None].expand(B, S * K, d), hk)


def _experts(cfg: ModelConfig, p: Params, prefix: str, buf: torch.Tensor,
             E: int, C: int) -> torch.Tensor:
    """Every expert over its C rows of every group, one batched product
    per weight: buf (B, E*C+1, d) -> (B, E*C+1, d), the overflow row
    zero."""
    B, _, d = buf.shape
    dt = buf.dtype
    xin = buf[:, :E * C].reshape(B, E, C, d).transpose(0, 1).reshape(
        E, B * C, d)
    gate = torch.bmm(xin, p[prefix + "experts/wi"].to(dt))
    up = (torch.bmm(xin, p[prefix + "experts/wg"].to(dt))
          if cfg.activation == "swiglu" else None)
    out = torch.bmm(activate(cfg, gate, up), p[prefix + "experts/wo"].to(dt))
    out = out.reshape(E, B, C, d).transpose(0, 1).reshape(B, E * C, d)
    return torch.cat([out, out.new_zeros(B, 1, d)], dim=1)


def _combine(out: torch.Tensor, dest: torch.Tensor, gate_vals: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """Gather each slot's expert row back and sum over K in float32 with
    the gate weights: (B, S, d) in ``dtype``."""
    B, S, K = gate_vals.shape
    d = out.shape[-1]
    back = out.gather(1, dest[..., None].expand(B, S * K, d))
    y = (back.reshape(B, S, K, d).float() * gate_vals[..., None]).sum(dim=2)
    return y.to(dtype)


def _shared(cfg: ModelConfig, p: Params, prefix: str,
            h: torch.Tensor) -> torch.Tensor:
    """The shared experts' contribution, sigmoid-gated in float32."""
    dt = h.dtype
    gate = h @ p[prefix + "shared/wi"].to(dt)
    up = (h @ p[prefix + "shared/wg"].to(dt)
          if cfg.activation == "swiglu" else None)
    shared = activate(cfg, gate, up) @ p[prefix + "shared/wo"].to(dt)
    sg = torch.sigmoid(h.float() @ p[prefix + "shared/gate"].float())
    return (shared.float() * sg).to(dt)


def _routed_ffn(cfg: ModelConfig, p: Params, x: torch.Tensor, prefix: str):
    """x (B,S,d) -> (y (B,S,d), logits, probs, gate indices)."""
    S = x.shape[1]
    E, K = cfg.num_experts, cfg.top_k
    C = _capacity(cfg, S)
    h = apply_norm(cfg, p, prefix + "norm", x)
    logits, probs, gate_vals, gate_idx = _route(cfg, h, p[prefix + "router"])
    dest = _slots(gate_idx, E, C)
    out = _experts(cfg, p, prefix, _dispatch(h, dest, K, E * C + 1), E, C)
    y = _combine(out, dest, gate_vals, x.dtype)
    if cfg.num_shared_experts > 0:
        y = y + _shared(cfg, p, prefix, h)
    return y, logits, probs, gate_idx


def _aux_sums(cfg: ModelConfig, logits: torch.Tensor, probs: torch.Tensor,
              gate_idx: torch.Tensor) -> Dict:
    """The aux losses' sums over a group of tokens: router probabilities
    ``me`` and top-1 assignments ``ce`` per expert, squared logsumexps
    ``z``, and the token count ``n``; :func:`aux_from_sums` divides
    them.  A sharded step sums them over its data replicas first: the
    load-balance loss is not a mean of per-replica losses."""
    E = cfg.num_experts
    return {"me": probs.sum(dim=(0, 1)),
            "ce": F.one_hot(gate_idx[..., 0], E).float().sum(dim=(0, 1)),
            "z": torch.logsumexp(logits, dim=-1).square().sum(),
            "n": gate_idx.shape[0] * gate_idx.shape[1]}


def aux_from_sums(cfg: ModelConfig, sums: Dict) -> Dict[str, torch.Tensor]:
    """GShard load balance ``moe_aux = sum(me * ce) * E`` over the means
    and ``router_z``, as the reference (``repro/models/moe.py:97-101``)."""
    me, ce = sums["me"] / sums["n"], sums["ce"] / sums["n"]
    return {"moe_aux": (me * ce).sum() * cfg.num_experts,
            "router_z": sums["z"] / sums["n"]}


def moe_ffn(cfg: ModelConfig, p: Params, x: torch.Tensor,
            prefix: str = "moe/"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Routed FFN. x: (B, S, d) -> (B, S, d) and the aux losses (GShard
    load balance ``moe_aux`` and ``router_z``), as the reference."""
    y, logits, probs, gate_idx = _routed_ffn(cfg, p, x, prefix)
    return y, aux_from_sums(cfg, _aux_sums(cfg, logits, probs, gate_idx))


def moe_layer(cfg: ModelConfig, p: Params, x: torch.Tensor,
              positions: torch.Tensor, cache, mode: str,
              rows: Optional[torch.Tensor] = None, rope=None,
              paging: Optional[transformer.Paging] = None,
              layer_idx: Optional[int] = None):
    """Attention then the routed FFN; in mode ``train`` also the sums its
    aux losses are made of (serving needs none)."""
    x = x + transformer.attention_block(cfg, p, x, positions, cache, mode,
                                        rows, rope=rope, paging=paging,
                                        layer_idx=layer_idx)
    y, logits, probs, gate_idx = _routed_ffn(cfg, p, x, "moe/")
    if mode == "train":
        return x + y, _aux_sums(cfg, logits, probs, gate_idx)
    return x + y
