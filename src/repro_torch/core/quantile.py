"""Streaming latency quantiles: the decayed log-bucket histogram sketch.

The port's counterpart of ``repro/core/quantile.py``.  Each controller
row keeps a decayed histogram over geometric buckets (the shape of a
Prometheus histogram with exponential buckets); quantiles are read with
``histogram_quantile``'s rule, linear inside the winning bucket, in log
space.  ``ControlLoop(eq1="sketch")`` feeds it the samples of each tick
(:func:`ingest`) and reads Eq (1)'s p95/p50 with :func:`quantile_fast`.

Everything here runs on host tensors (float32) and is bitwise the
reference as XLA compiles it on the CPU (its jitted programs): the
bucket index and every quantile go through XLA's own ``log`` and
``exp`` polynomials, the multiply-adds XLA fuses are fused, reductions
and the small prefix products sum in XLA's orders
(:mod:`repro_torch.core.xla_cpu`), and :func:`ingest`'s scatter adds its
samples one by one in sample order (decayed counts are not integers, so
``(c + 1) + 1`` can differ from ``c + 2``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import numpy as np
import torch

from repro_torch.core.xla_cpu import (_cumsum, _fma, _ftz, _seq_sum,
                                      _tree_sum, _triu_dot, _xla_exp,
                                      _xla_log)


@dataclasses.dataclass
class Histogram:
    """Decayed log-bucket histogram, one row a function.

    counts: (F, B) float32 decayed bucket counts; log_lo / log_hi: ()
    float32 logs of the smallest and largest bucket edges."""

    counts: torch.Tensor
    log_lo: torch.Tensor
    log_hi: torch.Tensor

    @staticmethod
    def init(num_functions: int, num_buckets: int = 64, lo: float = 1e-4,
             hi: float = 1e3) -> "Histogram":
        return Histogram(
            counts=torch.zeros((num_functions, num_buckets),
                               dtype=torch.float32),
            log_lo=_xla_log(torch.tensor(lo, dtype=torch.float32)),
            log_hi=_xla_log(torch.tensor(hi, dtype=torch.float32)))

    @property
    def num_buckets(self) -> int:
        return self.counts.shape[-1]


def _bucket_index(hist: Histogram, x) -> torch.Tensor:
    """int64 bucket of each value, clamped into range (NaN lands in 0;
    the float -> int conversion saturates, as XLA's does)."""
    B = hist.num_buckets
    x = torch.as_tensor(x, dtype=torch.float32)
    logx = _xla_log(torch.maximum(x, torch.tensor(1e-30,
                                                  dtype=torch.float32)))
    v = (logx - hist.log_lo) / (hist.log_hi - hist.log_lo) * float(B)
    idx = torch.clamp(v, -1.0, float(B)).to(torch.int64)
    idx = torch.where(torch.isnan(v), torch.zeros_like(idx), idx)
    return torch.clamp(idx, 0, B - 1)


def _weights(valid, like: torch.Tensor) -> torch.Tensor:
    return (torch.ones_like(like) if valid is None
            else torch.as_tensor(valid, dtype=torch.bool).to(torch.float32))


def update(hist: Histogram, latencies, valid=None,
           decay: float = 0.9) -> Histogram:
    """Fold an (F, W) window of observations into the decayed histogram
    (``decay`` is the retention a call).  The fresh counts are exact
    integers; XLA fuses the fold into ``fma(counts, decay, fresh)``."""
    lat = torch.as_tensor(latencies, dtype=torch.float32)
    idx = _bucket_index(hist, lat)                      # (F, W)
    w = _weights(valid, lat)
    fresh = torch.zeros_like(hist.counts).scatter_add_(1, idx, w)
    counts = _fma(hist.counts, torch.tensor(decay, dtype=torch.float32),
                  fresh)
    return Histogram(counts, hist.log_lo, hist.log_hi)


def ingest(hist: Histogram, rows, values, valid=None,
           decay: Union[float, torch.Tensor] = 0.9) -> Histogram:
    """Scatter a flat batch of fresh observations into the decayed
    histogram: ``rows[i]`` is the function row of sample ``values[i]``.
    A tick costs O(S + F*B) whatever the window.  The decayed counts are
    rounded (and flushed) first, then each sample's weight (``valid``,
    0 or 1) is added in sample order."""
    vals = torch.as_tensor(values, dtype=torch.float32)
    idx = _bucket_index(hist, vals)
    w = _weights(valid, vals)
    counts = _ftz(hist.counts * torch.as_tensor(decay, dtype=torch.float32))
    c = counts.numpy()
    np.add.at(c, (torch.as_tensor(rows).numpy().astype(np.int64),
                  idx.numpy()), w.numpy())
    return Histogram(counts, hist.log_lo, hist.log_hi)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x.gather(1, idx[:, None])[:, 0]


def quantile(hist: Histogram, q: float) -> torch.Tensor:
    """Prometheus-style ``histogram_quantile``: (F,) value of quantile
    ``q``, linear inside the winning bucket, geometric edges; an empty
    row gives 0.  The reference implementation (full prefix sums)."""
    counts = hist.counts
    total = _tree_sum(counts)
    cum = _cumsum(counts)
    qf = torch.tensor(q, dtype=torch.float32)
    target = qf * total
    hit = cum >= torch.clamp(target, min=1e-12)[:, None]
    idx = torch.where(hit.any(-1), hit.to(torch.int8).argmax(-1),
                      torch.zeros(counts.shape[0], dtype=torch.int64))
    cum_before = torch.where(idx > 0, _take(cum, torch.clamp(idx - 1,
                                                            min=0)),
                             torch.zeros_like(total))
    in_bucket = torch.clamp(_take(counts, idx), min=1e-12)
    # the numerator is an FMA unless LLVM vectorizes the row loop (8 rows
    # and up); both log-space steps are FMAs
    num = (_fma(total, qf, -cum_before) if counts.shape[0] < 8
           else target - cum_before)
    frac = torch.clamp(num / in_bucket, 0.0, 1.0)
    width = _width(hist)
    log_left = _fma(idx.to(torch.float32), width, hist.log_lo)
    val = _xla_exp(_fma(frac, width, log_left))
    return torch.where(total > 0, val, torch.zeros_like(val))


def quantiles(hist: Histogram, qs: Tuple[float, ...]) -> torch.Tensor:
    """(len(qs), F) stacked quantiles."""
    return torch.stack([quantile(hist, q) for q in qs])


def _width(hist: Histogram) -> torch.Tensor:
    """A bucket's log width; XLA turns the division by B into a product
    with the float32 reciprocal."""
    inv = torch.tensor(1.0 / hist.num_buckets, dtype=torch.float32)
    return (hist.log_hi - hist.log_lo) * inv


def _interp(hist: Histogram, q: float, total, cum_before, in_bucket,
            idx, fuse_num: bool = True) -> torch.Tensor:
    """``exp(log_lo + (idx + frac) * width)`` with XLA's fusions: the
    log-space point is an FMA, and so is the numerator ``q*total -
    cum_before`` unless ``fuse_num`` is False (where LLVM vectorizes the
    kernel's row loop, it leaves that pair unfused)."""
    qf = torch.tensor(q, dtype=torch.float32)
    num = (_fma(total, qf, -cum_before) if fuse_num
           else total * qf - cum_before)
    frac = torch.clamp(num / in_bucket, 0.0, 1.0)
    width = _width(hist)
    val = _xla_exp(_fma(width, frac + idx.to(torch.float32), hist.log_lo))
    return torch.where(total > 0, val, torch.zeros_like(val))


def quantile_fast(hist: Histogram, qs: Tuple[float, ...]) -> torch.Tensor:
    """(len(qs), F) stacked quantiles, the control tick's path.

    Same bucket and interpolation rule as :func:`quantile`, but the full
    prefix array is never built when ``B % 8 == 0``: block sums over G = 8
    blocks, the block holding each quantile, then a scan of that block
    alone.  Otherwise one B-wide prefix product."""
    counts = hist.counts
    F, B = counts.shape
    G = 8
    out = []
    if B % G == 0:
        Bg = B // G
        x = counts.reshape(F, G, Bg)
        blk = _seq_sum(x)                                   # (F, G)
        blk_pre = _triu_dot(blk, strict=True)
        total = _tree_sum(counts)
        inc = blk_pre + blk
        rows = torch.arange(F)
        for q in qs:
            qf = torch.tensor(q, dtype=torch.float32)
            target = torch.clamp(qf * total, min=1e-12)
            b_idx = torch.clamp((inc < target[:, None]).sum(-1), 0, G - 1)
            seg = x[rows, b_idx]                            # (F, Bg)
            seg_cum = _triu_dot(seg, strict=False)
            base = _take(blk_pre, b_idx)
            j = torch.clamp((seg_cum < (target - base)[:, None]).sum(-1),
                            0, Bg - 1)
            idx = b_idx * Bg + j
            cum_before = base + torch.where(
                j > 0, _take(seg_cum, torch.clamp(j - 1, min=0)),
                torch.zeros_like(base))
            in_bucket = torch.clamp(_take(seg, j), min=1e-12)
            out.append(_interp(hist, q, total, cum_before, in_bucket, idx))
        return torch.stack(out)
    cum = _triu_dot(counts, strict=False)
    total = cum[:, -1]
    for q in qs:
        qf = torch.tensor(q, dtype=torch.float32)
        target = torch.clamp(qf * total, min=1e-12)
        idx = torch.clamp((cum < target[:, None]).sum(-1), 0, B - 1)
        cum_before = torch.where(
            idx > 0, _take(cum, torch.clamp(idx - 1, min=0)),
            torch.zeros_like(total))
        in_bucket = torch.clamp(_take(counts, idx), min=1e-12)
        out.append(_interp(hist, q, total, cum_before, in_bucket, idx,
                           fuse_num=F < 4))
    return torch.stack(out)


@dataclasses.dataclass(frozen=True)
class SketchSpec:
    """Config for building per-row histograms."""
    num_buckets: int = 64
    lo: float = 1e-4
    hi: float = 1e3
    decay: float = 0.9
