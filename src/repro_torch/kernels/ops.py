"""Dispatch over the kernels, by the device of the tensors.

The counterpart of ``repro/kernels/ops.py``.  A CUDA tensor always goes
through the hand-written kernel (K1 ``flash_attention.cu``; K2 and K3,
dense and paged decode, ``decode_attention.cu``; K4, the WKV6 scan,
``rwkv6_scan.cu``; K5, the selective-SSM scan, ``ssd_scan.cu``); a CPU tensor goes through the plain PyTorch
version in :mod:`repro_torch.kernels.ref`.  There is no switch and no
fallback: a kernel that cannot build or launch raises.

``launches`` counts, per kernel and per plain version, the calls that
actually ran it (plain integers; :func:`reset_launches` zeroes them), so
a run can show which path the model took.

K1, K4 and K5 sit inside a :class:`torch.autograd.Function` whose
backward recomputes through the plain version and differentiates it, as
``custom_vjp`` does in the reference (``repro/kernels/ops.py:39-62,
92-131``): training takes it, serving never does.  The backward calls
:mod:`~repro_torch.kernels.ref` directly, so it counts no launch; every
forward on a card, the recompute of a rematerialized layer included,
launches the kernel and counts one.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv6_scan as _rwkv
from repro_torch.kernels import ssd_scan as _ssd

#: the time chunk of the reference's scan kernels (``ssd_scan.py:64-68``,
#: ``rwkv6_scan.py:94-96``); the port keeps their length rule, not their
#: chunking
SCAN_CHUNK = 128

launches: Dict[str, int] = {
    "flash_attention": 0, "flash_attention_plain": 0,
    "decode_attention": 0, "decode_attention_plain": 0,
    "paged_decode_attention": 0, "paged_decode_attention_plain": 0,
    "rwkv6_scan": 0, "rwkv6_scan_plain": 0,
    "ssd_scan": 0, "ssd_scan_plain": 0,
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _on_cuda(t: torch.Tensor, what: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel for device {t.device}")


def _flash_forward(q, k, v, q_pos, kv_pos, causal, window, softcap):
    if _on_cuda(q, "flash_attention"):
        out = _fa.flash_attention(q, k, v, q_pos, kv_pos, causal=causal,
                                  window=window, softcap=softcap)
        launches["flash_attention"] += 1
        return out
    launches["flash_attention_plain"] += 1
    return ref.flash_attention(q, k, v, q_pos, kv_pos, causal=causal,
                               window=window, softcap=softcap)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, causal, window, softcap):
        ctx.save_for_backward(q, k, v, q_pos, kv_pos)
        ctx.opts = (causal, window, softcap)
        return _flash_forward(q, k, v, q_pos, kv_pos, causal, window,
                              softcap)

    @staticmethod
    def backward(ctx, g):
        q, k, v, q_pos, kv_pos = ctx.saved_tensors
        causal, window, softcap = ctx.opts
        with torch.enable_grad():
            qd, kd, vd = (t.detach().requires_grad_() for t in (q, k, v))
            out = ref.flash_attention(qd, kd, vd, q_pos, kv_pos,
                                      causal=causal, window=window,
                                      softcap=softcap)
            dq, dk, dv = torch.autograd.grad(out, (qd, kd, vd), g)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, q_pos, kv_pos, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B,S,Hq,D); k/v: (B,T,Hkv,D); q_pos (B,S), kv_pos (B,T) int32.
    Returns (B,S,Hq,D) in q.dtype."""
    return _FlashAttention.apply(q, k, v, q_pos, kv_pos, causal, window,
                                 softcap)


def decode_attention(q, k, v, q_pos, kv_pos, window: Optional[int] = None,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B,Hq,D); k/v: (B,T,Hkv,D); q_pos (B,), kv_pos (B,T) int32.
    Returns (B,Hq,D) in q.dtype (inference only: no backward)."""
    if _on_cuda(q, "decode_attention"):
        out = _dec.decode_attention(q, k, v, q_pos, kv_pos, window=window,
                                    softcap=softcap)
        launches["decode_attention"] += 1
        return out
    launches["decode_attention_plain"] += 1
    return ref.decode_attention(q, k, v, q_pos, kv_pos, window=window,
                                softcap=softcap)


def paged_decode_attention(q, k_pages, v_pages, page_tables, q_pos,
                           kv_pos_pages, window: Optional[int] = None,
                           softcap: Optional[float] = None) -> torch.Tensor:
    """Decode straight off a paged KV pool, no gather.  q: (B,Hq,D);
    k_pages/v_pages: (P+1,page,Hkv,D); page_tables (B,ppr) int32;
    q_pos (B,); kv_pos_pages (P+1,page) int32.  Returns (B,Hq,D) in
    q.dtype (inference only: no backward)."""
    if _on_cuda(q, "paged_decode_attention"):
        out = _dec.paged_decode_attention(q, k_pages, v_pages, page_tables,
                                          q_pos, kv_pos_pages,
                                          window=window, softcap=softcap)
        launches["paged_decode_attention"] += 1
        return out
    launches["paged_decode_attention_plain"] += 1
    return ref.paged_decode_attention(q, k_pages, v_pages, page_tables,
                                      q_pos, kv_pos_pages, window=window,
                                      softcap=softcap)


def _check_scan_len(S: int) -> None:
    """The reference's scan kernels raise unless S <= 128 or S % 128 == 0
    (``chunk = min(chunk, S)``, then ``S % chunk``); so do the port's, on
    every device, so both admit exactly the reference kernel path's
    prompt lengths."""
    chunk = min(SCAN_CHUNK, S)
    if chunk and S % chunk:
        raise ValueError(f"seq len {S} is not divisible by chunk {chunk}")


def _rwkv_forward(r, k, v, lw, u, s0):
    if _on_cuda(r, "rwkv6_scan"):
        out = _rwkv.rwkv6_scan(r, k, v, lw, u, s0)
        launches["rwkv6_scan"] += 1
        return out
    launches["rwkv6_scan_plain"] += 1
    return ref.rwkv6_scan(r, k, v, lw, u, s0)


class _Rwkv6Scan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, lw, u, s0):
        ctx.save_for_backward(r, k, v, lw, u, s0)
        return _rwkv_forward(r, k, v, lw, u, s0)

    @staticmethod
    def backward(ctx, g_y, g_s):
        with torch.enable_grad():
            xs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            y, s = ref.rwkv6_scan(*xs)
            return torch.autograd.grad((y, s), xs, (g_y, g_s))


def rwkv6_scan(r, k, v, lw, u, s0):
    """WKV6 scan: y_t = r_t.(S + u k_t v_t^T), S <- diag(e^{lw_t}) S +
    k_t v_t^T.  r, k, v, lw: (B,S,H,D) float32 (lw <= 0); u: (H,D); s0:
    (B,H,D,D) float32.  Returns (y (B,S,H,D), s_final (B,H,D,D)),
    float32.  Raises the reference's ``ValueError`` unless S <= 128 or
    S % 128 == 0 (``repro/kernels/rwkv6_scan.py:94-96``)."""
    _check_scan_len(r.shape[1])
    return _Rwkv6Scan.apply(r, k, v, lw, u, s0)


def _ssd_forward(a, b, h0):
    if _on_cuda(a, "ssd_scan"):
        out = _ssd.ssd_scan(a, b, h0)
        launches["ssd_scan"] += 1
        return out
    launches["ssd_scan_plain"] += 1
    return ref.ssd_scan(a, b, h0)


class _SsdScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, h0):
        ctx.save_for_backward(a, b, h0)
        return _ssd_forward(a, b, h0)

    @staticmethod
    def backward(ctx, g_hs, g_h):
        a, b, h0 = ctx.saved_tensors
        with torch.enable_grad():
            xs = [t.detach().requires_grad_() for t in (a, b, h0)]
            hs, h = ref.ssd_scan(*xs)
            return torch.autograd.grad((hs, h), xs, (g_hs, g_h))


def ssd_scan(a, b, h0):
    """Selective-SSM scan h_t = a_t*h_{t-1} + b_t.  a, b: (B,S,I,N) float32;
    h0: (B,I,N) float32.  Returns (hs (B,S,I,N), h_final (B,I,N)), float32.

    Raises the reference's ``ValueError`` unless S <= 128 or S % 128 == 0
    (its kernel's chunk, ``repro/kernels/ssd_scan.py:64-68``)."""
    _check_scan_len(a.shape[1])
    return _SsdScan.apply(a, b, h0)
