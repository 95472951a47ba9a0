"""Knative-KPA-style concurrency autoscaler (per function, per tier).

The port's own copy of ``repro/core/autoscaler.py``.

Knative's Pod Autoscaler drives replica count from observed concurrency
(requests in flight) over two windows: a long *stable* window and a short
*panic* window; scale-to-zero engages after an idle grace period. The same
state machine governs the live runtime's serving instance pools.

Kept in plain Python: this is control-plane logic that runs at scrape
cadence (1 Hz in the paper), not on the device.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Deque, Tuple

from repro_torch.core.replication import AutoscalingPolicy


@dataclasses.dataclass
class AutoscalerState:
    replicas: int
    idle_since: float | None = None
    panic_until: float = -1.0


class Autoscaler:
    """One instance per (function, tier)."""

    def __init__(self, policy: AutoscalingPolicy,
                 stable_window_s: float = 60.0, panic_window_s: float = 6.0):
        self.policy = policy
        self.stable_window_s = stable_window_s
        self.panic_window_s = panic_window_s
        self._obs: Deque[Tuple[float, float]] = deque()   # (time, concurrency)
        self.state = AutoscalerState(replicas=max(policy.min_scale, 0))

    # ------------------------------------------------------------------
    def observe(self, t: float, concurrency: float) -> None:
        self._obs.append((t, concurrency))
        horizon = t - self.stable_window_s
        while self._obs and self._obs[0][0] < horizon:
            self._obs.popleft()

    def _avg(self, t: float, window: float) -> float:
        pts = [c for (ts, c) in self._obs if ts >= t - window]
        return sum(pts) / len(pts) if pts else 0.0

    # ------------------------------------------------------------------
    def desired(self, t: float) -> int:
        """Recompute desired replicas at time t (call at scrape cadence)."""
        pol = self.policy
        stable = self._avg(t, self.stable_window_s)
        panic = self._avg(t, self.panic_window_s)
        target = max(pol.target_concurrency, 1e-6)

        want_stable = math.ceil(stable / target)
        want_panic = math.ceil(panic / target)

        # Panic mode: short-window load exceeded threshold x what the current
        # replicas absorb -> scale up immediately and hold (no scale-down)
        # for a stable window.
        cur = self.state.replicas
        if cur > 0 and panic / max(cur * target, 1e-6) >= pol.panic_threshold:
            self.state.panic_until = t + self.stable_window_s
        in_panic = t < self.state.panic_until

        want = max(want_stable, want_panic) if in_panic else want_stable
        if in_panic:
            want = max(want, cur)          # never scale down in panic

        # Scale-to-zero grace.
        if want == 0:
            if self.state.idle_since is None:
                self.state.idle_since = t
            if (t - self.state.idle_since) < pol.scale_to_zero_grace_s or pol.min_scale > 0:
                want = max(1, pol.min_scale)
        else:
            self.state.idle_since = None

        want = min(max(want, pol.min_scale), pol.max_scale)
        self.state.replicas = want
        return want

    @property
    def replicas(self) -> int:
        return self.state.replicas
