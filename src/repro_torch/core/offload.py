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
(the reference's ``OffloadState.init_rows`` layout).  The net-aware cap
and the streaming-sketch Eq-(1) front end are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class OffloadConfig:
    """Controller constants (names follow the paper; the reference's
    defaults)."""

    c_decay: float = 0.8      # exponential decay of past ratios, Eq (2)
    c_t: int = 10             # history window length (steps), Eq (2)
    c_soft: float = 1.25      # soft limit of the p95/p50 ratio, Eq (3)
    c_hard: float = 2.5       # hard limit of the p95/p50 ratio, Eq (3)
    c_in: float = 0.6         # inertia factor, Eq (4)

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
    return lo_v * low_w + hi_v * high_w


# lint: ignore[parity-drift] -- the port imports nothing of repro;
# tests/test_torch_control.py::test_eq1_eq3_match_reference holds this
# copy against repro.core.offload.latency_ratio
def latency_ratio(latencies: torch.Tensor,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq (1): (F,) p95/p50 tail ratio of the (F, W) latency windows,
    over the ``valid`` observations only, floored at 1.0."""
    lat = torch.as_tensor(latencies, dtype=torch.float32)
    if valid is not None:
        valid = torch.as_tensor(valid, dtype=torch.bool)
        lat = torch.where(valid, lat, torch.full_like(lat, float("nan")))
    return tail_ratio(_nanpercentile(lat, 95.0), _nanpercentile(lat, 50.0))


# lint: ignore[parity-drift] -- the port imports nothing of repro;
# tests/test_torch_control.py::test_eq1_eq3_match_reference holds this
# copy against repro.core.offload.target_percentage
def target_percentage(r_prime: torch.Tensor,
                      cfg: OffloadConfig) -> torch.Tensor:
    """Eq (3): piecewise-linear map from decayed ratio to traffic percent."""
    span = max(cfg.c_hard - cfg.c_soft, 1e-9)
    # lint: ignore[parity-drift] -- the same copy as the def above, held
    # by tests/test_torch_control.py::test_eq1_eq3_match_reference
    lin = 100.0 * (r_prime - cfg.c_soft) / span
    return torch.clamp(lin, 0.0, 100.0)


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
    newest first, renormalized over the entries filled so far."""
    n = cfg.c_t + 1
    k = torch.arange(n, dtype=torch.int32)
    idx = torch.remainder(state.head[:, None] - k[None, :], n)
    ordered = torch.gather(state.ratios, 1, idx.long())
    w = cfg.decay_weights()
    mask = (k[None, :] < torch.clamp(state.filled[:, None], min=1)).to(
        torch.float32)
    wm = w[None, :] * mask
    return (ordered * wm).sum(dim=-1) / torch.clamp(wm.sum(dim=-1), min=1e-9)


def offload_update(state: OffloadState, latencies, valid,
                   cfg: OffloadConfig) -> Tuple[OffloadState, torch.Tensor]:
    """One controller step over every row: Eqs (1), (2), (3), (4) in
    order.  Returns (new_state, R) with R the (F,) percentage of traffic
    to send down-chain."""
    r_l = latency_ratio(latencies, valid)               # Eq (1)
    state = push_ratio(state, r_l)
    r_prime = decayed_ratio(state, cfg)                 # Eq (2)
    r_t = target_percentage(r_prime, cfg)               # Eq (3)
    R = state.R * cfg.c_in + r_t * (1.0 - cfg.c_in)     # Eq (4)
    return OffloadState(state.ratios, state.head, state.filled, R), R
