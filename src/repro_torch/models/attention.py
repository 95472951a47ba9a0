"""Attention call sites of the model: prefill (flash) and single-token
decode, both through :mod:`repro_torch.kernels.ops`.

The counterpart of ``repro/models/attention.py:58-78, 158-190``; paged
decode reads the page pool directly (kernel K3) where the reference
gathers pages into the dense view first.  Masking
is positional (``repro/models/attention.py:32-44``): every query and key
carries an absolute position; causality, sliding windows and empty cache
slots (position < 0) are one predicate, so prefill, decode and rolling
caches share one mask rule.  On a CUDA tensor the call always reaches
the hand-written kernel; on a CPU tensor, its plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig


def flash_attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, q_pos: torch.Tensor,
                    kv_pos: torch.Tensor, *, causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B,S,Hq,D); k, v: (B,T,Hkv,D); q_pos (B,S), kv_pos (B,T).
    Returns (B,S,Hq,D) in q.dtype."""
    return ops.flash_attention(q, k, v, q_pos, kv_pos, causal=causal,
                               window=window,
                               softcap=cfg.attn_logit_softcap)


def decode_attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, q_pos: torch.Tensor,
                     kv_pos: torch.Tensor, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """q (B,Hq,D) vs cache k/v (B,T,Hkv,D); q_pos (B,), kv_pos (B,T)
    (-1 = empty slot; a rolling cache leaves them unordered).
    Returns (B,Hq,D)."""
    return ops.decode_attention(q, k, v, q_pos, kv_pos, window=window,
                                softcap=cfg.attn_logit_softcap)


def paged_decode_attention(cfg: ModelConfig, q: torch.Tensor,
                           k_pages: torch.Tensor, v_pages: torch.Tensor,
                           page_tables: torch.Tensor, q_pos: torch.Tensor,
                           kv_pos_pages: torch.Tensor, *,
                           window: Optional[int] = None) -> torch.Tensor:
    """q (B,Hq,D) vs a page pool k/v (P+1,page,Hkv,D) through page_tables
    (B,ppr); q_pos (B,), kv_pos_pages (P+1,page) (-1 = empty, the null
    page is all -1).  Returns (B,Hq,D)."""
    return ops.paged_decode_attention(q, k_pages, v_pages, page_tables,
                                      q_pos, kv_pos_pages, window=window,
                                      softcap=cfg.attn_logit_softcap)
