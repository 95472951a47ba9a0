"""Plain PyTorch versions of the kernels.

The counterpart of ``repro/kernels/ref.py``: the O(S^2) materialized
attention score oracle with the positional mask, float32 accumulation and
fully masked rows zeroed (``:18-51``), the literal WKV6 recurrence
(``:54-66``) and the sequential selective-SSM recurrence (``:69-80``).  The CPU tests run these; on the card
``chip_smoke.py`` holds the CUDA kernels against them.  On a card no
forward of the main path calls them: every forward launches the kernel.
Training's backward of K1, K4 and K5 differentiates these plain
versions (:mod:`repro_torch.kernels.ops`), as the reference's
``custom_vjp`` differentiates its oracles.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, window: Optional[int],
          causal: bool) -> torch.Tensor:
    """(..., S, T) bool — True where attention is allowed.  Slots with
    kv_pos < 0 are empty; causal keeps d = q_pos - kv_pos >= 0; a window
    keeps d < window."""
    d = q_pos[..., :, None] - kv_pos[..., None, :]
    ok = kv_pos[..., None, :] >= 0
    if causal:
        ok = ok & (d >= 0)
    if window is not None:
        ok = ok & (d < window)
    return ok


def flash_attention(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B,S,Hq,D); k/v: (B,T,Hkv,D); q_pos (B,S), kv_pos (B,T) int.
    Returns (B,S,Hq,D) in q.dtype; query head h reads kv head h // G."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qf = q.reshape(B, S, Hkv, G, D).float() * D ** -0.5
    s = torch.einsum("bskgd,btkd->bkgst", qf, k.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    ok = _mask(q_pos, kv_pos, window, causal)                 # (B,S,T)
    s = torch.where(ok[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    any_ok = ok.any(dim=-1)[:, None, None, :, None]
    p = torch.where(any_ok, p, torch.zeros_like(p))
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return out.reshape(B, S, Hq, D).to(q.dtype)


def decode_attention(q, k, v, q_pos, kv_pos, *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """One query token per sequence. q: (B,Hq,D); k/v: (B,T,Hkv,D);
    q_pos (B,); kv_pos (B,T).  Returns (B,Hq,D) in q.dtype."""
    out = flash_attention(q[:, None], k, v, q_pos[:, None], kv_pos,
                          causal=True, window=window, softcap=softcap)
    return out[:, 0]


def paged_decode_attention(q, k_pages, v_pages, page_tables, q_pos,
                           kv_pos_pages, *, window: Optional[int] = None,
                           softcap: Optional[float] = None) -> torch.Tensor:
    """Decode against a paged KV pool.  q: (B,Hq,D); k_pages/v_pages:
    (P+1,page,Hkv,D); page_tables (B,ppr) int32 page ids (short rows
    padded with a null page whose positions are all -1); q_pos (B,);
    kv_pos_pages (P+1,page).  Gathers each row's pages into the
    contiguous (B, ppr*page, Hkv, D) view and runs :func:`decode_attention`
    on it.  Returns (B,Hq,D) in q.dtype."""
    B, ppr = page_tables.shape
    page, Hkv, D = k_pages.shape[1:]
    idx = page_tables.long()
    k = k_pages[idx].reshape(B, ppr * page, Hkv, D)
    v = v_pages[idx].reshape(B, ppr * page, Hkv, D)
    kv_pos = kv_pos_pages[idx].reshape(B, ppr * page)
    return decode_attention(q, k, v, q_pos, kv_pos, window=window,
                            softcap=softcap)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               lw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor):
    """The WKV6 recurrence, one token at a time in float32, per head::

        y_t = r_t . (S + u k_t v_t^T),   S <- diag(e^{lw_t}) S + k_t v_t^T

    r, k, v, lw: (B,S,H,D) (lw the log-decay, <= 0); u: (H,D); s0:
    (B,H,D,D).  Returns (y (B,S,H,D) float32, s_final (B,H,D,D)
    float32)."""
    r, k, v, lw = (t.float() for t in (r, k, v, lw))
    u = u.float()
    s = s0.float()
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]          # (B,H,D,D)
        ys.append(torch.einsum("bhd,bhde->bhe", r[:, t],
                               s + u[:, :, None] * kv))
        s = torch.exp(lw[:, t])[..., None] * s + kv
    return torch.stack(ys, dim=1), s


def ssd_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """Diagonal linear recurrence h_t = a_t*h_{t-1} + b_t (selective SSM),
    one step at a time in float32.  a, b: (B,S,I,N); h0: (B,I,N).
    Returns (hs (B,S,I,N) float32, h_final (B,I,N) float32).

    The product and the sum are two separate operations (never fused
    into one multiply-add), as the CUDA kernel rounds them."""
    a, b = a.float(), b.float()
    h = h0.float()
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h
