"""Edge-to-Cloud offloading controller — Eqs (1)-(4) of the paper.

The port's counterpart of ``repro/core/offload.py``, in PyTorch on
host tensors (float32, as the reference):

    Eq (1)  r_l(t)  = p95(X_l(t)) / p50(X_l(t))
    Eq (2)  r_l'(t) = sum_k c_decay^k * r_l(t-k) / sum_k c_decay^k,  k in [0, c_t]
    Eq (3)  r_t(t)  = 0                                if r_l' < c_soft
                      100                              if r_l' > c_hard
                      100*(r_l'-c_soft)/(c_hard-c_soft) otherwise
    Eq (4)  R_t(t)  = R_t(t-1)*c_in + r_t(t)*(1-c_in),  R_t(0) = 0

State is carried per function row, with one ring-buffer head per row
(the reference's ``OffloadState.init_rows`` layout), and
:func:`offload_update` adds the beyond-paper net-aware cap (R_t capped
by the share of demand the link can carry).  Its rounding follows the
reference's jitted rows kernel bit for bit: XLA on the CPU contracts
three multiply-adds into FMAs, folds Eq (3)'s constants and flushes
subnormals, so the port
does the same at each site (float64 holds an exact float32 product, so
``(a*b + c)`` rounded once to float32 is the FMA; the helpers live in
:mod:`repro_torch.core.xla_cpu`).  Both Eq-(1) front ends share one Eqs
(2)-(4) tail (:func:`finish_rows`): the exact window percentiles
(:func:`offload_update`) and the streaming histogram sketch over
stacked rows (:func:`offload_update_rows_stream`, bitwise the
reference's ``offload_update_rows_stream_jit``).

The controller stays on the host: its contract is XLA:CPU's rounding,
and the simulator's R_t must equal the live runtime's, whichever device
serves the models.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import quantile
from repro_torch.core.xla_cpu import _fma, _ftz


def padded_rows(n: int) -> int:
    """Rows every stacked controller call pads to: the next power of two
    (the reference's compile-shape rule).  The window rows are row-local,
    but the sketch's summation and fusion depend on the row count
    (:func:`~repro_torch.core.quantile.quantile_fast`), so the sketch's
    R_t matches the reference's only at the reference's padding."""
    return 1 << (max(int(n), 1) - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class OffloadConfig:
    """Controller constants (names follow the paper; the reference's
    defaults)."""

    c_decay: float = 0.8      # exponential decay of past ratios, Eq (2)
    c_t: int = 10             # history window length (steps), Eq (2)
    c_soft: float = 1.25      # soft limit of the p95/p50 ratio, Eq (3)
    c_hard: float = 2.5       # hard limit of the p95/p50 ratio, Eq (3)
    c_in: float = 0.6         # inertia factor, Eq (4)
    # beyond-paper extension: cap the offloaded share by what the link
    # carries at the demand of each update
    net_aware: bool = False
    link_bytes_per_s: float = 100e6   # the paper's observed 100 MB/s ceiling
    req_bytes: float = 1e6            # average request+response payload
    # the demand (requests/s) a net-aware update assumes when its caller
    # passes none
    demand_rps: float = 100.0

    def decay_weights(self) -> torch.Tensor:
        """w_k = c_decay^k / sum_j c_decay^j for k = 0..c_t (newest first)."""
        k = torch.arange(self.c_t + 1, dtype=torch.float32)
        w = torch.pow(torch.tensor(self.c_decay, dtype=torch.float32), k)
        return w / w.sum()


@dataclasses.dataclass
class OffloadState:
    """Per-row controller state.

    ratios: (F, c_t+1) ring buffer of past r_l values, ``head[f]`` the most
    recent; filled: (F,) valid entries (warm-up masking); R: (F,) the
    smoothed traffic percentage of Eq (4).
    """

    ratios: torch.Tensor
    head: torch.Tensor
    filled: torch.Tensor
    R: torch.Tensor

    @staticmethod
    def init(num_rows: int, cfg: OffloadConfig) -> "OffloadState":
        return OffloadState(
            ratios=torch.ones((num_rows, cfg.c_t + 1), dtype=torch.float32),
            head=torch.zeros(num_rows, dtype=torch.int32),
            filled=torch.zeros(num_rows, dtype=torch.int32),
            R=torch.zeros(num_rows, dtype=torch.float32))   # R_t(0) = 0


# lint: ignore[parity-drift] -- the port imports nothing of repro;
# tests/test_torch_control.py::test_eq1_eq3_match_reference holds this
# copy against repro.core.offload.tail_ratio
def tail_ratio(p95: torch.Tensor, p50: torch.Tensor) -> torch.Tensor:
    """Eq (1) core: ``p95/p50`` floored at 1.0 (a tail cannot be faster
    than the median; the floor also guards p50 == 0 and all-NaN rows)."""
    ratio = p95 / torch.clamp(p50, min=1e-9)
    ratio = torch.where(torch.isfinite(ratio), ratio, torch.ones_like(ratio))
    return torch.clamp(ratio, min=1.0)


def _nanpercentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """Row-wise linear-interpolation percentile ignoring NaNs, step for
    step as ``jnp.nanpercentile`` (an all-NaN row gives NaN)."""
    xs, _ = torch.sort(x, dim=-1)                  # NaNs sort last
    counts = (~torch.isnan(xs)).sum(dim=-1).to(torch.float32)
    qf = torch.tensor(q, dtype=torch.float32) / 100.0
    pos = qf * (counts - 1.0)
    low = torch.floor(pos)
    high = torch.ceil(pos)
    high_w = pos - low
    low_w = 1.0 - high_w
    low = torch.maximum(torch.zeros_like(low), torch.minimum(low, counts - 1))
    high = torch.maximum(torch.zeros_like(high),
                         torch.minimum(high, counts - 1))
    lo_v = xs.gather(-1, low.long()[:, None])[:, 0]
    hi_v = xs.gather(-1, high.long()[:, None])[:, 0]
    # XLA on the CPU contracts ``lo*lw + hi*hw`` into fma(hi, hw, lo*lw)
    return _fma(hi_v, high_w, lo_v * low_w)


def _percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """Row-wise linear-interpolation percentile of whole rows, step for
    step as ``jnp.percentile`` (a row holding a NaN gives NaN).  Its
    weights are constants, and XLA on the CPU contracts ``lo*lw + hi*hw``
    into fma(lo, lw, hi*hw)."""
    n = x.shape[-1]
    x = torch.where(torch.isnan(x).any(dim=-1, keepdim=True),
                    torch.full_like(x, float("nan")), x)
    xs, _ = torch.sort(x, dim=-1)
    pos = torch.tensor(q, dtype=torch.float32) / 100.0 * torch.tensor(
        n - 1, dtype=torch.float32)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1.0 - high_w
    lo_v, hi_v = xs[:, int(low)], xs[:, int(high)]
    return _fma(lo_v, low_w.expand_as(lo_v), hi_v * high_w)


# lint: ignore[parity-drift] -- the port imports nothing of repro;
# tests/test_torch_control.py::test_eq1_eq3_match_reference holds this
# copy against repro.core.offload.latency_ratio
def latency_ratio(latencies: torch.Tensor,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq (1): (F,) p95/p50 tail ratio of the (F, W) latency windows,
    over the ``valid`` observations only (``jnp.nanpercentile``), or over
    whole windows without a mask (``jnp.percentile``), floored at 1.0."""
    lat = torch.as_tensor(latencies, dtype=torch.float32)
    if valid is None:
        return tail_ratio(_percentile(lat, 95.0), _percentile(lat, 50.0))
    valid = torch.as_tensor(valid, dtype=torch.bool)
    lat = torch.where(valid, lat, torch.full_like(lat, float("nan")))
    return tail_ratio(_nanpercentile(lat, 95.0), _nanpercentile(lat, 50.0))


# lint: ignore[parity-drift] -- the port imports nothing of repro;
# tests/test_torch_control.py::test_eq1_eq3_match_reference holds this
# copy against repro.core.offload.target_percentage
def target_percentage(r_prime: torch.Tensor,
                      cfg: OffloadConfig) -> torch.Tensor:
    """Eq (3): piecewise-linear map from decayed ratio to traffic percent.
    ``100 * (r' - c_soft) / span`` as XLA folds it in the reference's
    jitted kernel: ``(r' - c_soft) * (100 * (1 / span))``, constants in
    float32."""
    span = torch.tensor(max(cfg.c_hard - cfg.c_soft, 1e-9),
                        dtype=torch.float32)
    scale = torch.tensor(100.0, dtype=torch.float32) * (1.0 / span)
    return torch.clamp((r_prime - cfg.c_soft) * scale, 0.0, 100.0)


def push_ratio(state: OffloadState, r_l: torch.Tensor) -> OffloadState:
    """Advance every row's ring buffer with a fresh Eq-(1) observation."""
    n = state.ratios.shape[-1]
    head = torch.remainder(state.head + 1, n)
    col = torch.arange(n, dtype=head.dtype)[None, :]
    ratios = torch.where(col == head[:, None], r_l[:, None], state.ratios)
    filled = torch.clamp(state.filled + 1, max=n)
    return OffloadState(ratios, head, filled, state.R)


def decayed_ratio(state: OffloadState, cfg: OffloadConfig) -> torch.Tensor:
    """Eq (2): exponentially decayed weighted mean over each row's ring,
    newest first, renormalized over the entries filled so far.  As in the
    reference's jitted kernel, the weighted sum is a newest-first chain of
    FMAs, ``acc = fma(ratio_k, w_k, acc)``, and the weight sum plain adds."""
    n = cfg.c_t + 1
    k = torch.arange(n, dtype=torch.int32)
    idx = torch.remainder(state.head[:, None] - k[None, :], n)
    ordered = torch.gather(state.ratios, 1, idx.long())
    w = cfg.decay_weights()
    mask = (k[None, :] < torch.clamp(state.filled[:, None], min=1)).to(
        torch.float32)
    wm = w[None, :] * mask
    num = torch.zeros(state.R.shape, dtype=torch.float32)
    den = torch.zeros(state.R.shape, dtype=torch.float32)
    for j in range(n):
        num = _fma(ordered[:, j], wm[:, j], num)
        den = den + wm[:, j]
    return num / torch.clamp(den, min=1e-9)


def link_x100(link_bytes_per_s: float) -> float:
    """``100 * link_bytes_per_s`` rounded once to float32 on the host,
    as the reference hands it to its rows kernel."""
    return float(np.float32(100.0 * link_bytes_per_s))


def finish_rows(state: OffloadState, r_l: torch.Tensor, active,
                link_x100, req_bytes, net_mask, demand_rps,
                cfg: OffloadConfig, *, fma_on_prev: bool = False
                ) -> Tuple[OffloadState, torch.Tensor]:
    """Eqs (2)-(4) over rows, then the net cap.

    ``r_l`` is each row's fresh Eq-(1) ratio; ``active`` (P,) freezes the
    rows whose boundary saw nothing this interval (ring, head, fill and
    R_t kept as they were), None steps every row.  The cap is data:
    ``link_x100`` (``100 * link_bytes_per_s`` rounded once to float32),
    ``req_bytes``, ``net_mask`` (the rows whose policy is net-aware) and
    ``demand_rps``, each a value a row or one for all.  Bitwise the
    reference's ``_finish_rows`` (subnormal results flushed, as XLA
    does); ``fma_on_prev`` takes Eq (4)'s other contraction, which XLA
    picks in the body of the reference's net-aware ``scan_controller``."""
    new = push_ratio(state, r_l)
    r_prime = decayed_ratio(new, cfg)                   # Eq (2)
    r_t = target_percentage(r_prime, cfg)               # Eq (3)
    # Eq (4), contracted by XLA into fma(r_t, 1 - c_in, R * c_in), or,
    # with ``fma_on_prev``, into fma(R, c_in, r_t * (1 - c_in))
    c_in = torch.tensor(cfg.c_in, dtype=torch.float32)
    one_m = torch.tensor(1.0 - cfg.c_in, dtype=torch.float32)
    if fma_on_prev:
        R = _fma(state.R, c_in.expand_as(r_t), _ftz(r_t * one_m))
    else:
        R = _fma(r_t, one_m.expand_as(r_t), _ftz(state.R * c_in))
    net = torch.as_tensor(net_mask, dtype=torch.bool)
    if net.any():
        rps, req, link = (torch.as_tensor(v, dtype=torch.float32)
                          for v in (demand_rps, req_bytes, link_x100))
        cap = link / torch.clamp(rps * req, min=1e-9)
        R = torch.where(net, torch.minimum(R, torch.clamp(cap, 0.0, 100.0)),
                        R)
    if active is None:
        return OffloadState(new.ratios, new.head, new.filled, R), R
    act = torch.as_tensor(active, dtype=torch.bool)
    ratios = torch.where(act[:, None], new.ratios, state.ratios)
    head = torch.where(act, new.head, state.head)
    filled = torch.where(act, new.filled, state.filled)
    R = torch.where(act, R, state.R)
    return OffloadState(ratios, head, filled, R), R


def offload_update(state: OffloadState, latencies, valid,
                   cfg: OffloadConfig,
                   demand_rps: Optional[torch.Tensor] = None
                   ) -> Tuple[OffloadState, torch.Tensor]:
    """One controller step over every row: Eqs (1), (2), (3), (4) in
    order, then, when ``cfg.net_aware``, the cap by what the link carries
    at ``demand_rps`` (F,).  Returns (new_state, R) with R the (F,)
    percentage of traffic to send down-chain, bitwise equal to the
    reference's rows kernel (subnormal results flushed, as XLA does)."""
    r_l = latency_ratio(latencies, valid)               # Eq (1)
    return _finish(state, r_l, cfg, demand_rps)


def _finish(state: OffloadState, r_l: torch.Tensor, cfg: OffloadConfig,
            demand_rps, fma_on_prev: bool = False
            ) -> Tuple[OffloadState, torch.Tensor]:
    """Eqs (2)-(4) and the cap over every row, the cap at ``demand_rps``
    or, for None, ``cfg.demand_rps``."""
    if demand_rps is None:
        demand_rps = cfg.demand_rps
    return finish_rows(state, r_l, None, link_x100(cfg.link_bytes_per_s),
                       cfg.req_bytes, cfg.net_aware, demand_rps, cfg,
                       fma_on_prev=fma_on_prev)


def scan_controller(cfg: OffloadConfig, windows,
                    valid=None) -> torch.Tensor:
    """The controller over a (T, F, W) latency trace (``valid`` an
    optional (T, F, W) mask), from the initial state: the (T, F)
    trajectory of R_t, one :func:`offload_update` a step.  Bitwise the
    reference's ``lax.scan`` (``repro/core/offload.py:375``), whose loop
    body XLA contracts Eq (4) the other way round when the net cap
    follows it."""
    windows = torch.as_tensor(windows, dtype=torch.float32)
    T, F, _ = windows.shape
    state = OffloadState.init(F, cfg)
    out = torch.empty((T, F), dtype=torch.float32)
    for i in range(T):
        r_l = latency_ratio(windows[i], None if valid is None else valid[i])
        state, out[i] = _finish(state, r_l, cfg, None,
                                fma_on_prev=cfg.net_aware)
    return out


def latency_ratio_from_sketch(hist: quantile.Histogram) -> torch.Tensor:
    """Eq (1) from the histogram sketch: (F,) p95/p50, floored at 1."""
    p95, p50 = quantile.quantile_fast(hist, (0.95, 0.50))
    return tail_ratio(p95, p50)


def offload_update_from_sketch(state: OffloadState,
                               hist: quantile.Histogram, cfg: OffloadConfig,
                               demand_rps=None
                               ) -> Tuple[OffloadState, torch.Tensor]:
    """One controller step with Eq (1) read from the histogram sketch
    (p95 / p50 of each row's decayed histogram), then Eqs (2)-(4) and the
    cap as :func:`offload_update`.  Returns (new_state, R)."""
    return _finish(state, latency_ratio_from_sketch(hist), cfg, demand_rps)


def offload_update_rows_stream(
        state: OffloadState, hist: quantile.Histogram, sample_rows,
        sample_vals, sample_valid, sketch_decay, active, link_x100,
        req_bytes, net_mask, demand_rps, cfg: OffloadConfig
        ) -> Tuple[OffloadState, quantile.Histogram, torch.Tensor]:
    """The streaming controller step: the tick's samples scattered into
    each row's decayed histogram (:func:`quantile.ingest`), Eq (1) read
    from the sketch, then Eqs (2)-(4) and the cap (:func:`finish_rows`).
    No window is built or sorted.  Returns (state, hist, R)."""
    hist = quantile.ingest(hist, sample_rows, sample_vals,
                           valid=sample_valid, decay=sketch_decay)
    r_l = latency_ratio_from_sketch(hist)               # Eq (1), sketched
    state, R = finish_rows(state, r_l, active, link_x100, req_bytes,
                           net_mask, demand_rps, cfg)
    return state, hist, R
