"""RWKV6 "Finch" — attention-free LM with data-dependent per-channel decay.

The counterpart of ``repro/models/rwkv6.py``.  Per head (key index i,
value index j)::

    y_t[j]   = sum_i r_t[i] * (S_{t-1}[i,j] + u[i] * k_t[i] * v_t[j])
    S_t[i,j] = w_t[i] * S_{t-1}[i,j] + k_t[i] * v_t[j],   w_t = exp(lw_t)

with the log-decay ``lw = -exp(clip(w0 + lora, -20, 10))`` < 0.  Prefill
solves the recurrence with :func:`repro_torch.kernels.ops.rwkv6_scan`
(kernel K4 on the card, the plain per-token recurrence on the CPU);
decode is the O(1) step :func:`wkv_recurrent_step`, with no kernel.  The
reference's XLA chunked form (``wkv_chunked``) has no counterpart: the
port has one path per device.  Dtypes follow the reference: the state
``tm_s`` is float32, the token-shift states ``tm_x`` and ``cm_x`` are in
``compute_dtype``; r, k, v, lw, the group norm and the silu gate are
float32.

Unlike the reference, which returns the new state, :func:`rwkv_layer`
writes it **in place** into the cache views it is given, as
``ssm.ssm_block`` does; in decode only the rows in ``rows`` are written,
so an inactive row's state stays bit for bit as it was.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import transformer
from repro_torch.models.common import (ModelConfig, ParamSpec, Params,
                                       apply_norm, norm_specs, stack_layers)

LORA_MIX = 32      # rank of the token-shift mixing LoRA
LORA_DECAY = 64    # rank of the decay LoRA

State = Dict[str, torch.Tensor]


# --------------------------------------------------------------------------
# Parameter table (identical keys, shapes and inits to the reference)
# --------------------------------------------------------------------------


def layer_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, H, D, F_ = cfg.d_model, cfg.num_rwkv_heads, cfg.rwkv_head_dim, cfg.d_ff
    norm = {f"norm/{k}": v for k, v in norm_specs(cfg).items()}
    return {
        # --- time mix -------------------------------------------------
        "tm/mu_x": ParamSpec((d,), ("embed",), "uniform_pm", 0.5),
        "tm/mu5": ParamSpec((5, d), (None, "embed"), "uniform_pm", 0.5),
        "tm/lora_w1": ParamSpec((d, 5 * LORA_MIX), ("embed", None),
                                scale=0.1),
        "tm/lora_w2": ParamSpec((5, LORA_MIX, d), (None, None, "embed"),
                                scale=0.1),
        "tm/w0": ParamSpec((H, D), ("heads", "head_dim"), "const", -5.0),
        "tm/decay_a": ParamSpec((d, LORA_DECAY), ("embed", None), scale=0.1),
        "tm/decay_b": ParamSpec((LORA_DECAY, H, D),
                                (None, "heads", "head_dim"), scale=0.1),
        "tm/u": ParamSpec((H, D), ("heads", "head_dim"), "uniform_pm", 0.5),
        "tm/wr": ParamSpec((d, H, D), ("embed", "heads", "head_dim")),
        "tm/wk": ParamSpec((d, H, D), ("embed", "heads", "head_dim")),
        "tm/wv": ParamSpec((d, H, D), ("embed", "heads", "head_dim")),
        "tm/wg": ParamSpec((d, H, D), ("embed", "heads", "head_dim")),
        "tm/wo": ParamSpec((H, D, d), ("heads", "head_dim", "embed")),
        "tm/ln_scale": ParamSpec((H, D), ("heads", "head_dim"), "ones"),
        "tm/ln_bias": ParamSpec((H, D), ("heads", "head_dim"), "zeros"),
        **{f"tm/{k}": v for k, v in norm.items()},
        # --- channel mix ------------------------------------------------
        "cm/mu_k": ParamSpec((d,), ("embed",), "uniform_pm", 0.5),
        "cm/mu_r": ParamSpec((d,), ("embed",), "uniform_pm", 0.5),
        "cm/wk": ParamSpec((d, F_), ("embed", "ffn")),
        "cm/wv": ParamSpec((F_, d), ("ffn", "embed")),
        "cm/wr": ParamSpec((d, d), ("embed", None)),
        **{f"cm/{k}": v for k, v in norm.items()},
    }


def param_table(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    return {**transformer.head_specs(cfg),
            **stack_layers(layer_specs(cfg), cfg.num_layers)}


# --------------------------------------------------------------------------
# WKV core
# --------------------------------------------------------------------------


def wkv_recurrent_step(r, k, v, lw, u, s):
    """One token.  r, k, v, lw: (B,H,D); u: (H,D); s: (B,H,D,D).
    Returns (y (B,H,D), s')."""
    kv = k[..., :, None] * v[..., None, :]                     # (B,H,D,D)
    y = torch.einsum("bhd,bhde->bhe", r, s + u[..., :, None] * kv)
    s_new = torch.exp(lw)[..., :, None] * s + kv
    return y, s_new


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------


def _token_shift(h: torch.Tensor, x_prev: torch.Tensor,
                 mode: str) -> torch.Tensor:
    """The previous-token stream (B,S,d): the carried token before the
    first position (prefill), or the carried token alone (decode)."""
    x_prev = x_prev[:, None].to(h.dtype)
    if mode == "decode":
        return x_prev.expand_as(h)
    return torch.cat([x_prev, h[:, :-1]], dim=1)


def _write(state: State, new: State, rows: Optional[torch.Tensor],
           mode: str) -> None:
    """Overwrite the state views in place (only at ``rows``, when given;
    never in train, which keeps no state)."""
    if mode == "train":
        return
    for name, value in new.items():
        value = value.to(state[name].dtype)
        if rows is None:
            state[name].copy_(value)
        else:
            state[name][rows] = value[rows]


def time_mix(cfg: ModelConfig, p: Params, x: torch.Tensor, state: State,
             mode: str, rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The RWKV6 attention analogue.  ``state`` = {"x": (B,d), "s":
    (B,H,D,D) float32} is read, then overwritten with the new state."""
    B, S, _ = x.shape
    H, D = cfg.num_rwkv_heads, cfg.rwkv_head_dim
    h = apply_norm(cfg, p, "tm/norm", x)
    dx = _token_shift(h, state["x"], mode) - h
    xxx = h + dx * p["tm/mu_x"].to(h.dtype)
    mix = torch.tanh(xxx @ p["tm/lora_w1"].to(h.dtype))
    off = torch.einsum("bsmr,mrd->mbsd", mix.reshape(B, S, 5, LORA_MIX),
                       p["tm/lora_w2"].to(h.dtype))
    mu5 = p["tm/mu5"].to(h.dtype)                              # (5,d)
    xr, xk, xv, xw, xg = [h + dx * (mu5[i] + off[i]) for i in range(5)]

    r, k, v, g = (transformer._proj(t, p[w]) for t, w in
                  ((xr, "tm/wr"), (xk, "tm/wk"), (xv, "tm/wv"), (xg, "tm/wg")))
    # data-dependent log-decay, always < 0: lw = -exp(w0 + lora)
    dlo = torch.tanh(xw @ p["tm/decay_a"].to(h.dtype))         # (B,S,64)
    dexp = p["tm/w0"].float() + transformer._proj(
        dlo, p["tm/decay_b"]).float()
    lw = -torch.exp(dexp.clamp(-20.0, 10.0))
    u = p["tm/u"].float()

    rf, kf, vf = r.float(), k.float(), v.float()
    if mode == "decode":
        y1, s_new = wkv_recurrent_step(rf[:, 0], kf[:, 0], vf[:, 0],
                                       lw[:, 0], u, state["s"].float())
        y = y1[:, None]
    else:
        y, s_new = ops.rwkv6_scan(rf, kf, vf, lw, u,
                                  state["s"].float().contiguous())
    _write(state, {"x": h[:, -1], "s": s_new}, rows, mode)

    # per-head group norm, then the silu gate, in float32
    mu = y.mean(dim=-1, keepdim=True)
    var = y.var(dim=-1, keepdim=True, unbiased=False)
    yn = (y - mu) * torch.rsqrt(var + 64e-5)
    yn = yn * p["tm/ln_scale"].float() + p["tm/ln_bias"].float()
    yn = (yn * F.silu(g.float())).to(x.dtype)
    wo = p["tm/wo"]
    return yn.reshape(B, S, H * D) @ wo.to(x.dtype).reshape(H * D, -1)


def channel_mix(cfg: ModelConfig, p: Params, x: torch.Tensor, state: State,
                mode: str, rows: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """The RWKV6 FFN analogue.  ``state`` = {"x": (B,d)} is read, then
    overwritten."""
    h = apply_norm(cfg, p, "cm/norm", x)
    dx = _token_shift(h, state["x"], mode) - h
    xk = h + dx * p["cm/mu_k"].to(h.dtype)
    xr = h + dx * p["cm/mu_r"].to(h.dtype)
    kh = torch.square(F.relu(xk @ p["cm/wk"].to(h.dtype)))
    kv = kh @ p["cm/wv"].to(h.dtype)
    rgate = torch.sigmoid(xr @ p["cm/wr"].to(h.dtype))
    _write(state, {"x": h[:, -1]}, rows, mode)
    return rgate * kv


def rwkv_layer(cfg: ModelConfig, p: Params, x: torch.Tensor,
               positions: torch.Tensor, cache: Optional[State], mode: str,
               rows: Optional[torch.Tensor] = None, rope=None, paging=None,
               layer_idx: Optional[int] = None):
    """cache = this layer's {"tm_x" (B,d), "tm_s" (B,H,D,D), "cm_x" (B,d)}
    views, written in place, or None (train: the zero state, and the
    layer returns (x, {})).  ``positions``, ``rope``, ``paging`` and
    ``layer_idx`` are the layer signature's and go unused."""
    st = cache if cache is not None else init_layer_state(
        cfg, x.shape[0], x.device)
    x = x + time_mix(cfg, p, x, {"x": st["tm_x"], "s": st["tm_s"]}, mode,
                     rows)
    x = x + channel_mix(cfg, p, x, {"x": st["cm_x"]}, mode, rows)
    return (x, {}) if mode == "train" else x


def init_layer_state(cfg: ModelConfig, batch: int, device=None) -> State:
    """Zero state of one layer: tm_x, cm_x (B,d) in ``compute_dtype``,
    tm_s (B,H,D,D) float32."""
    H, D = cfg.num_rwkv_heads, cfg.rwkv_head_dim
    return {"tm_x": torch.zeros((batch, cfg.d_model),
                                dtype=cfg.compute_dtype, device=device),
            "tm_s": torch.zeros((batch, H, D, D), dtype=torch.float32,
                                device=device),
            "cm_x": torch.zeros((batch, cfg.d_model),
                                dtype=cfg.compute_dtype, device=device)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> State:
    """The state of every layer, stacked on a leading layer axis: tm_x,
    cm_x (L,B,d), tm_s (L,B,H,D,D).  Its size does not grow with the
    context, so ``max_len`` is not read."""
    del max_len
    return {name: torch.zeros((cfg.num_layers, *leaf.shape),
                              dtype=leaf.dtype, device=device)
            for name, leaf in init_layer_state(cfg, batch, "meta").items()}
