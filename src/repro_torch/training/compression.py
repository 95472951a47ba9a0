"""Int8 gradient compression with error feedback: the counterpart of
``repro/training/compression.py``.

Each gradient leaf plus its carried residual is quantized to int8 with a
per-leaf float32 scale; the residual of the quantization is carried to
the next step (error feedback, Karimireddy et al., 2019).  ``jnp.round``
and ``torch.round`` both round half to even, and the division is IEEE,
so with the absmax scale ``q`` and the scales equal the reference's bit
for bit.

Three forms:

* :func:`compress` / :func:`decompress` on whole leaves: the one-device
  step quantizes and dequantizes its gradient in place of the
  cross-replica mean.
* :func:`compress_placed`: the same on the sharded step's mean gradient
  and an error buffer placed like the parameters (the reference's pjit
  path), the scale taken over every block of a leaf.
* :func:`ring_allreduce_int8` and :func:`allreduce_compressed` over one
  mesh axis, single-controller: a list of per-index tensors in, a list
  out, each hop a copy to the next index's device.  The reference's
  semantics are kept exactly: the ring returns the **int32 sum** (not a
  mean, whatever the reference's docstring says), and its chunks travel
  as **int32** after the first widening (``repro/training/
  compression.py:107,116``), so a hop moves 4 bytes an element, not the
  1 its docstring counts.  ``allreduce_compressed`` takes the max of the
  members' scales, quantizes every member on that grid, sums in int32
  and returns (mean, new error) per member.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import placement

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    enabled: bool = False
    dtype: torch.dtype = torch.int8
    # quantile used for the scale (max is noise-sensitive; 0 = use absmax)
    clip_quantile: float = 0.0


def init_error(params: Params) -> Params:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def quantile(a: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(a.reshape(-1), q)`` (linear interpolation) of a
    float32 tensor, as the reference computes it: the rank ``q * (n - 1)``
    in float32, the two neighbouring order statistics, and their float32
    weights; NaN if any element is.  ``torch.quantile`` refuses inputs
    of more than 2**24 elements, so the order statistics come from
    ``torch.kthvalue``."""
    flat = a.reshape(-1)
    f32 = torch.float32
    n = torch.tensor(flat.numel(), dtype=f32)
    rank = torch.tensor(q, dtype=f32) * (n - 1)
    low, high = torch.floor(rank), torch.ceil(rank)
    hi_w = rank - low
    lo_w = 1 - hi_w
    lo_i = int(low.clamp(0, n - 1)) + 1            # kthvalue's k is 1-based
    hi_i = int(high.clamp(0, n - 1)) + 1
    lo_v = torch.kthvalue(flat, lo_i).values
    hi_v = lo_v if hi_i == lo_i else torch.kthvalue(flat, hi_i).values
    out = lo_v * lo_w.to(a.device) + hi_v * hi_w.to(a.device)
    return torch.where(flat.isnan().any(), torch.nan, out)


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` divided in IEEE float32 on every device: the card
    divides by a host scalar as a product with its reciprocal, which can
    miss the quotient's last bit, so ``d`` goes as a tensor beside
    ``x``."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def _scale_for(leaf: torch.Tensor, cfg: CompressionConfig) -> torch.Tensor:
    a = leaf.float().abs()
    s = quantile(a, cfg.clip_quantile) if cfg.clip_quantile > 0 else a.max()
    return _div(s.clamp_min(1e-12), 127.0)


def _quantize(g32: torch.Tensor, s: torch.Tensor, cfg: CompressionConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q, residual) of a float32 leaf on the grid of scale ``s``."""
    q = torch.clamp(torch.round(g32 / s), -127, 127).to(cfg.dtype)
    return q, g32 - q.float() * s


def compress(grads: Params, error: Params, cfg: CompressionConfig
             ) -> Tuple[Params, Params, Params]:
    """Quantize (grad + carried error) to int8.  Returns (q, scales,
    new_error)."""
    qs, ss, es = {}, {}, {}
    for k in grads:
        g32 = grads[k].float() + error[k]
        s = _scale_for(g32, cfg)
        qs[k], es[k] = _quantize(g32, s, cfg)   # residual -> error feedback
        ss[k] = s
    return qs, ss, es


def decompress(qs: Params, scales: Params) -> Params:
    return {k: qs[k].float() * scales[k] for k in qs}


@torch.no_grad()
def compress_placed(grads: Dict[str, placement.Placed],
                    error: Dict[str, placement.Placed],
                    cfg: CompressionConfig) -> None:
    """:func:`compress` then :func:`decompress` of a float32 gradient and
    an error buffer placed alike, in place: each grad piece becomes its
    dequantized value and each error piece the new residual.  A leaf's
    scale is its absmax over every block (exact: a max), or its
    ``clip_quantile`` over the joined leaf."""
    for k, g in grads.items():
        e = error[k]
        for _, (gp, ep) in placement.aligned(g, e):
            gp.add_(ep)                                # g32
        if cfg.clip_quantile > 0:
            s = _scale_for(placement.join(g), cfg)
        else:
            maxes = [gp.abs().max() for _, gp in g.blocks()]
            s = torch.stack([m.to(maxes[0].device) for m in maxes]).max()
            s = _div(s.clamp_min(1e-12), 127.0)
        for _, (gp, ep) in placement.aligned(g, e):
            sp = s.to(gp.device)
            q, res = _quantize(gp, sp, cfg)
            ep.copy_(res)
            gp.copy_(q.float() * sp)


# ---------------------------------------------------------------------------
# The int8 ring all-reduce over one mesh axis (single-controller)
# ---------------------------------------------------------------------------


def _hop(t: torch.Tensor, device: torch.device,
         stats: Optional[Dict[str, int]]) -> torch.Tensor:
    """One ring hop: a copy of ``t`` on the next member's device."""
    if stats is not None:
        stats["wire_bytes"] = stats.get("wire_bytes", 0) + \
            t.numel() * t.element_size()
    return t.to(device, copy=True)


def ring_allreduce_int8(xs: List[torch.Tensor],
                        stats: Optional[Dict[str, int]] = None
                        ) -> List[torch.Tensor]:
    """The int32 sum of ``xs`` (one tensor per index of the axis, each on
    its device), returned to every index: a reduce-scatter then an
    all-gather ring of ``len(xs) - 1`` hops each, member ``j`` sending to
    ``j + 1``, in the reference's chunk order
    (``repro/training/compression.py:95-136``).  Each leading dim must
    divide by the member count.  ``stats["wire_bytes"]`` adds the bytes
    the hops copy: 2 (n - 1) chunks of int32 a member."""
    n = len(xs)
    if xs[0].shape[0] % n:
        raise ValueError(f"leading dim {xs[0].shape[0]} is not divisible "
                         f"by the {n} ring members")
    devs = [x.device for x in xs]
    chunks = xs[0].shape[0] // n
    acc = [x.reshape(n, chunks, *x.shape[1:]).to(torch.int32) for x in xs]
    for i in range(n - 1):                       # reduce-scatter
        sends = [acc[j][(j - i) % n] for j in range(n)]
        recvs = [_hop(sends[(j - 1) % n], devs[j], stats) for j in range(n)]
        for j in range(n):
            acc[j][(j - i - 1) % n] += recvs[j]
    # member j now owns the fully reduced chunk j + 1
    cur = [acc[j][(j + 1) % n] for j in range(n)]
    out = []
    for j in range(n):
        o = torch.zeros_like(acc[j])
        o[(j + 1) % n] = cur[j]
        out.append(o)
    for i in range(n - 1):                       # all-gather
        cur = [_hop(cur[(j - 1) % n], devs[j], stats) for j in range(n)]
        for j in range(n):
            out[j][(j - i) % n] = cur[j]
    return [o.reshape(x.shape) for o, x in zip(out, xs)]


def allreduce_compressed(grads: List[Params], error: List[Params],
                         cfg: CompressionConfig,
                         stats: Optional[Dict[str, int]] = None
                         ) -> Tuple[List[Params], List[Params]]:
    """The mean of the members' gradients over int8 (``grads[j]`` and
    ``error[j]`` on member ``j``'s device): each leaf's scale is the max
    of the members' (so every member quantizes on one grid), the int8
    values sum in int32 through :func:`ring_allreduce_int8` (flattened,
    zero-padded to a multiple of the member count), and each member gets
    ``sum * s / n`` and its residual.  Returns (means, new errors), one
    dict per member."""
    n = len(grads)
    means: List[Params] = [{} for _ in range(n)]
    errs: List[Params] = [{} for _ in range(n)]
    for k in grads[0]:
        g32 = [g[k].float() + e[k] for g, e in zip(grads, error)]
        scales = [_scale_for(g, cfg) for g in g32]
        s = torch.stack([x.to(scales[0].device) for x in scales]).max()
        qs = [torch.clamp(torch.round(g / s.to(g.device)), -127,
                          127).to(torch.int8) for g in g32]
        flat = [q.reshape(-1) for q in qs]
        pad = (-flat[0].numel()) % n
        summed = ring_allreduce_int8(
            [torch.nn.functional.pad(f, (0, pad)) for f in flat], stats)
        for j in range(n):
            sj = s.to(g32[j].device)
            tot = summed[j][:flat[j].numel()].reshape(qs[j].shape)
            means[j][k] = _div(tot.float() * sj, n)
            errs[j][k] = g32[j] - qs[j].float() * sj
    return means, errs
