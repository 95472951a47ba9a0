"""The plain reference: the configurations' decoder in float32 PyTorch,
teacher-forced over a prompt and its served tokens.  It imports nothing
of the port and takes nothing the port made: it reads the benchmark's
own weights (:func:`pbench.model.draw_weights`) under the key layout
the port is handed them in, and works everything else out again.

The equations, per layer (pre-norm, residual)::

    h = norm(x)            LayerNorm (scale, bias) or RMSNorm (scale)
    q, k, v = h Wq (+bq), h Wk (+bk), h Wv (+bv)
    rotary over the whole head (halves rotated), theta = rope_theta
    x += softmax(q k^T / sqrt(Dh), causal) v Wo
    h = norm(x)
    dense:  x += (silu(h Wi) * (h Wg)) Wo
    moe:    p = softmax(h Wrouter); the top ``num_experts_per_tok``
            experts by p (ties: the lower index), weights renormalised
            over them; x += sum_k w_k (silu(h Wi_e) * (h Wg_e)) Wo_e
                        + sigmoid(h Wgate) (silu(h Wi_s) * (h Wg_s)) Wo_s
    logits = norm(x) Wlm^T

The MoE layer keeps the expert capacity the configuration states
(``capacity_factor``): a prompt is one group of ``L`` tokens, expert
``e`` takes at most ``C = ceil(L * K * capacity_factor / E)`` of its
(token, k) slots in the order ``token * K + k``, and a slot past ``C``
adds nothing; a decoded token is a group of its own, so it never drops.

``quant="fp8"`` gives the control: every matrix (embedding and head
included) rounded per output channel, symmetric, to fp8 e4m3, and used
dequantised; activations stay float32.

Runs layer by layer over all the sequences given, each layer's weights
cast to float32 once, so it fits beside the served model's weights.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _rounded(w: torch.Tensor, contract: int) -> torch.Tensor:
    """``w`` (float32) rounded per output channel over its first
    ``contract`` axes (the ones a product sums over), symmetric, to fp8
    e4m3 (scale absmax / 448), and dequantised."""
    shape = w.shape
    m = w.reshape(int(math.prod(shape[:contract])), -1)
    scale = m.abs().amax(dim=0, keepdim=True).clamp_min(1e-12) / 448.0
    q = (m / scale).to(torch.float8_e4m3fn).float()
    return (q * scale).reshape(shape)


def _w(params, key: str, i: Optional[int], quant: Optional[str],
       contract: int = 1, experts: bool = False,
       by_row: bool = False) -> torch.Tensor:
    """Layer ``i``'s slice of a weight as float32 (the control's rounded
    weight under ``quant``).  ``by_row``: the output channels are the
    rows (the embedding table, the head read as ``x W^T``)."""
    w = params[key] if i is None else params[key][i]
    w = w.float()
    if quant not in (None, "fp8"):
        raise ValueError(f"unknown control precision {quant!r}")
    if quant is not None and w.dim() >= 2:
        if by_row:
            w = _rounded(w.t(), 1).t()
        elif experts:
            w = torch.stack([_rounded(we, contract) for we in w])
        else:
            w = _rounded(w, contract)
    return w


def _norm(conf: dict, x: torch.Tensor, scale, bias) -> torch.Tensor:
    eps = float(conf["norm_eps"])
    if conf["norm_type"] == "layernorm":
        return F.layer_norm(x, x.shape[-1:], scale, bias, eps)
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _norm_params(conf, params, prefix: str, i: Optional[int]):
    scale = _w(params, prefix + "/scale", i, None)
    bias = (_w(params, prefix + "/bias", i, None)
            if conf["norm_type"] == "layernorm" else None)
    return scale, bias


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, D) at positions 0..S-1."""
    S, _, D = x.shape
    half = D // 2
    inv = 1.0 / torch.pow(torch.tensor(float(theta), dtype=torch.float64),
                          torch.arange(half, dtype=torch.float64) / half)
    ang = torch.arange(S, dtype=torch.float64)[:, None] * inv[None]
    cos = torch.cos(ang).float().to(x.device)[:, None]
    sin = torch.sin(ang).float().to(x.device)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def layer_weights(conf: dict, params, i: int, quant: Optional[str]) -> dict:
    """Layer ``i``'s weights, float32 (rounded under ``quant``), cast once
    for every sequence."""
    w = {"attn_norm": _norm_params(conf, params, "layers/attn/norm", i)}
    for n in ("wq", "wk", "wv"):
        w[n] = _w(params, "layers/attn/" + n, i, quant)
    w["wo"] = _w(params, "layers/attn/wo", i, quant, contract=2)
    if conf["use_qkv_bias"]:
        for n in ("bq", "bk", "bv"):
            w[n] = _w(params, "layers/attn/" + n, i, None)
    if conf["family"] == "moe":
        w["ffn_norm"] = _norm_params(conf, params, "layers/moe/norm", i)
        w["router"] = _w(params, "layers/moe/router", i, quant)
        for n in ("wi", "wg", "wo"):
            w["e_" + n] = _w(params, "layers/moe/experts/" + n, i, quant,
                             experts=True)
            w["s_" + n] = _w(params, "layers/moe/shared/" + n, i, quant)
        w["s_gate"] = _w(params, "layers/moe/shared/gate", i, quant)
    else:
        w["ffn_norm"] = _norm_params(conf, params, "layers/mlp/norm", i)
        for n in ("wi", "wg", "wo"):
            w["m_" + n] = _w(params, "layers/mlp/" + n, i, quant)
    return w


def _attention(conf, w, h):
    S, d = h.shape
    Hq, Hkv, D = (int(conf["num_attention_heads"]),
                  int(conf["num_key_value_heads"]), int(conf["head_dim"]))
    q = h @ w["wq"].reshape(d, -1)
    k = h @ w["wk"].reshape(d, -1)
    v = h @ w["wv"].reshape(d, -1)
    if conf["use_qkv_bias"]:
        q = q + w["bq"].reshape(-1)
        k = k + w["bk"].reshape(-1)
        v = v + w["bv"].reshape(-1)
    theta = float(conf["rope_theta"])
    q = _rope(q.reshape(S, Hq, D), theta)
    k = _rope(k.reshape(S, Hkv, D), theta)
    v = v.reshape(S, Hkv, D)
    g = Hq // Hkv
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    s = torch.einsum("shd,thd->hst", q, k) / math.sqrt(D)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = torch.einsum("hst,thd->shd", torch.softmax(s, dim=-1), v)
    return o.reshape(S, -1) @ w["wo"].reshape(Hq * D, d)


def _swiglu(h, wi, wg, wo):
    return (F.silu(h @ wi) * (h @ wg)) @ wo


def _moe(conf, w, h, prompt_len: int):
    S, _ = h.shape
    E, K = int(conf["num_experts"]), int(conf["num_experts_per_tok"])
    probs = torch.softmax(h @ w["router"], dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, e_of = vals[:, :K], idx[:, :K]
    gate = gate / gate.sum(-1, keepdim=True)
    keep = torch.ones(S, K, dtype=torch.bool, device=h.device)
    C = max(1, math.ceil(prompt_len * K * float(conf["capacity_factor"]) / E))
    seen = [0] * E
    kept = []
    for e in e_of[:prompt_len].reshape(-1).tolist():   # slots s*K + k
        kept.append(seen[e] < C)
        seen[e] += 1
    keep[:prompt_len] = torch.tensor(kept, device=h.device).reshape(-1, K)
    y = torch.zeros_like(h)
    for e in range(E):
        s_idx, k_idx = torch.nonzero((e_of == e) & keep, as_tuple=True)
        if len(s_idx) == 0:
            continue
        out = _swiglu(h[s_idx], w["e_wi"][e], w["e_wg"][e], w["e_wo"][e])
        y.index_add_(0, s_idx, out * gate[s_idx, k_idx][:, None])
    shared = _swiglu(h, w["s_wi"], w["s_wg"], w["s_wo"])
    return y + shared * torch.sigmoid(h @ w["s_gate"])


def logits_at(conf: dict, params: Dict[str, torch.Tensor],
              seqs: Sequence[Tuple[np.ndarray, int, Sequence[int]]],
              device, quant: Optional[str] = None) -> List[torch.Tensor]:
    """For each ``(tokens, prompt_len, positions)``: the float32 logits
    (len(positions), V) at those positions of the teacher-forced pass."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _logits_at(conf, params, seqs, device, quant)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _logits_at(conf, params, seqs, device, quant):
    embed = _w(params, "embed", None, quant, by_row=True)
    xs = [embed[torch.as_tensor(np.asarray(t, np.int64), device=device)]
          for t, _, _ in seqs]
    del embed
    moe = conf["family"] == "moe"
    for i in range(int(conf["num_hidden_layers"])):
        w = layer_weights(conf, params, i, quant)
        for j, (x, (_, prompt_len, _)) in enumerate(zip(xs, seqs)):
            x = x + _attention(conf, w, _norm(conf, x, *w["attn_norm"]))
            h = _norm(conf, x, *w["ffn_norm"])
            x = x + (_moe(conf, w, h, prompt_len) if moe
                     else _swiglu(h, w["m_wi"], w["m_wg"], w["m_wo"]))
            xs[j] = x
        del w
    final = _norm_params(conf, params, "final_norm", None)
    head = _w(params, "lm_head", None, quant, by_row=True)
    out = []
    for x, (_, _, pos) in zip(xs, seqs):
        idx = torch.as_tensor(list(pos), device=device)
        out.append(_norm(conf, x[idx], *final) @ head.t())
    return out
