"""Traffic policies + the shared control loop.

The port's counterpart of ``repro/core/policy.py``:

  * :class:`Policy` — the protocol every traffic policy implements
    (``init_state / observe / update / route / hedge``), plus
    :meth:`Policy.parse` for the reference's shorthands: ``0``..``100``
    (a static split), ``"auto"`` (the paper's Eqs (1)-(4)) and its
    ``+net`` / ``+hedge`` / ``+migrate`` modifiers in any combination.
  * :class:`StaticSplit`, :class:`AutoOffload`, :class:`NetAwareOffload`
    (the link-capacity cap), :class:`HedgedOffload` (p99 straggler
    backups through :func:`repro_torch.core.router.hedged_mask`),
    :class:`MigratingOffload` (a migration threshold: the live scheduler
    ships slot-resident rows down-chain once R_t reaches it).
  * :class:`ControlLoop` — one scrape-and-update cycle: latency windows,
    in-flight queue-age mixing, demand RPS, policy update; one controller
    boundary per adjacent tier pair.  ``eq1`` picks the Eq-(1) front
    end: ``"window"`` (exact sorted-window percentiles, stepped per
    boundary) or ``"sketch"`` (decayed histograms fed the fresh samples
    of each tick through :meth:`ControlLoop.step_stream`, every
    (boundary, function) pair a row of one stacked state).  Both are
    bitwise the reference's, whichever of its loops it takes.

Routing draws its uniforms from an explicit ``np.random.Generator`` that
the caller owns, and hands them to :mod:`repro_torch.core.router`.
Hedging draws nothing (its rule is deterministic).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import offload, quantile, router

PolicySpec = Union[float, int, str, "Policy"]


class Policy:
    """Protocol + shared plumbing for traffic policies.

    ``update`` answers what percentage R_t of each function's traffic
    goes down-chain; ``route``/``route_tiers`` which queued requests
    cross.  ``init_state``/``observe`` let stateful policies carry their
    own state through the loop without the harness knowing its shape.
    """

    spec: str = "policy"
    #: mid-stream migration threshold (percent of R_t); None = never
    migrate_threshold: Optional[float] = None
    #: a row is a migration victim only with at least this many tokens
    #: still to generate (nearly-done rows finish in place)
    migrate_min_remaining: int = 2

    def init_state(self, num_functions: int) -> Any:
        return None

    def initial_R(self, num_functions: int) -> np.ndarray:
        """R_t before the first update (Eq (4): R_t(0) = 0)."""
        return np.zeros(num_functions, np.float32)

    def observe(self, state: Any, latencies: np.ndarray,
                valid: np.ndarray) -> Any:
        """Scrape-time hook, called every interval before ``update``."""
        return state

    def update(self, state: Any, latencies: np.ndarray, valid: np.ndarray,
               demand_rps: np.ndarray) -> Tuple[Any, np.ndarray]:
        """One controller step -> (new_state, (F,) percentages)."""
        raise NotImplementedError

    # lint: ignore[parity-drift] -- the port imports nothing of repro;
    # tests/test_torch_control.py::test_tier_distribution_matches_reference
    # holds this copy against repro.core.policy.Policy.tier_distribution
    def tier_distribution(self, R_all: np.ndarray,
                          num_tiers: int) -> np.ndarray:
        """Compose per-boundary percentages into an (F, num_tiers) tier
        distribution (rows sum to 100; two tiers give ``[100 - R, R]``).
        Boundary b's R_t is the share of the traffic reaching tier b that
        continues to tier b+1."""
        R_all = np.asarray(R_all, np.float32)
        F = R_all.shape[1]
        d = np.zeros((F, num_tiers), np.float32)
        remain = np.full(F, 100.0, np.float32)
        for b in range(num_tiers - 1):
            d[:, b] = remain * (100.0 - R_all[b]) / 100.0
            remain = remain * R_all[b] / 100.0
        d[:, num_tiers - 1] = remain
        return d

    def route_tiers(self, rng: np.random.Generator, dist: np.ndarray,
                    fn_ids: np.ndarray, num_functions: int) -> np.ndarray:
        """Assign a batch over N tiers by the (F, N) distribution ->
        (B,) int tier indices.  Draws (F, N) + (B,) uniforms from
        ``rng``."""
        B = len(fn_ids)
        num_tiers = dist.shape[1]
        if B == 0:
            return np.zeros(0, np.int32)
        if num_tiers == 1:
            return np.zeros(B, np.int32)
        extra_u = rng.random((num_functions, num_tiers), dtype=np.float32)
        noise = rng.random(B, dtype=np.float32)
        tiers = router.route_tiers(torch.as_tensor(dist),
                                   torch.as_tensor(fn_ids),
                                   torch.from_numpy(extra_u),
                                   torch.from_numpy(noise))
        return tiers.numpy()

    def hedge(self, ages_s: np.ndarray, fn_ids: np.ndarray,
              latencies: np.ndarray, valid: np.ndarray) -> np.ndarray:
        """Which waiting requests deserve a backup on another tier ->
        (B,) bool.  None, unless the policy hedges."""
        return np.zeros(len(fn_ids), bool)

    @staticmethod
    def parse(spec: PolicySpec,
              offload_cfg: Optional[offload.OffloadConfig] = None,
              link_bytes_per_s: Optional[float] = None,
              req_bytes: Optional[float] = None) -> "Policy":
        """The reference's grammar: ``0``..``100`` (number or numeric
        string) -> StaticSplit; ``"auto"`` -> AutoOffload, optionally with
        the modifiers ``+net`` (NetAwareOffload, capped against
        ``link_bytes_per_s`` and ``req_bytes``), ``+hedge``
        (HedgedOffload, over the net-aware config when both are given) and
        ``+migrate`` (a migration threshold on whichever class hosts the
        rest) in any order, the canonical ``spec`` re-normalized to net,
        hedge, migrate order.  Policy instances pass through; anything
        else raises ``ValueError``."""
        if isinstance(spec, Policy):
            return spec
        cfg = offload_cfg or offload.OffloadConfig()
        if isinstance(spec, (int, float)):
            return StaticSplit(float(spec))
        if isinstance(spec, str):
            s = spec.strip().lower()
            try:
                return StaticSplit(float(s))
            except ValueError:
                pass
            parts = s.split("+")
            mods = set(parts[1:])
            if parts[0] == "auto" and mods <= {"net", "hedge", "migrate"}:
                if "net" in mods:
                    net = NetAwareOffload(
                        cfg, link_bytes_per_s=link_bytes_per_s,
                        req_bytes=req_bytes)
                    pol: AutoOffload = (HedgedOffload(net.cfg)
                                        if "hedge" in mods else net)
                elif "hedge" in mods:
                    pol = HedgedOffload(cfg)
                elif "migrate" in mods:
                    pol = MigratingOffload(cfg)
                else:
                    pol = AutoOffload(cfg)
                if "migrate" in mods and pol.migrate_threshold is None:
                    pol.migrate_threshold = MigratingOffload.default_threshold
                pol.spec = "auto" + "".join(
                    "+" + m for m in ("net", "hedge", "migrate")
                    if m in mods)
                return pol
        raise ValueError(f"unknown policy spec {spec!r}")


class StaticSplit(Policy):
    """Fixed percentage of traffic down-chain (the 0/25/50/75/100
    columns of the paper's Table 2)."""

    def __init__(self, pct: float):
        if not 0.0 <= pct <= 100.0:
            raise ValueError(f"static split must be in [0, 100], got {pct}")
        self.pct = float(pct)
        self.spec = str(self.pct)

    def initial_R(self, num_functions: int) -> np.ndarray:
        return np.full(num_functions, self.pct, np.float32)

    def update(self, state, latencies, valid, demand_rps):
        return state, np.full(latencies.shape[0], self.pct, np.float32)


class AutoOffload(Policy):
    """The paper's adaptive controller: Eqs (1)-(4) on the latency
    windows of the boundary's tier, with the net-aware cap when
    ``cfg.net_aware`` (per-call demand from the loop)."""

    spec = "auto"

    def __init__(self, cfg: Optional[offload.OffloadConfig] = None):
        self.cfg = cfg or offload.OffloadConfig()

    def _structural_cfg(self) -> offload.OffloadConfig:
        """The Eq-(2)/(3)/(4) constants alone: the net-aware fields are
        per-row data of the stacked update, so boundaries that differ
        only in their link share one stack."""
        return offload.OffloadConfig(
            c_decay=self.cfg.c_decay, c_t=self.cfg.c_t,
            c_soft=self.cfg.c_soft, c_hard=self.cfg.c_hard,
            c_in=self.cfg.c_in)

    def net_rows(self, num_rows: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(link_x100, req_bytes, net_mask) rows of the stacked update
        (``link_x100`` rounded once to float32 on the host, as the
        reference's)."""
        if self.cfg.net_aware:
            return (np.full(num_rows, offload.link_x100(
                        self.cfg.link_bytes_per_s), np.float32),
                    np.full(num_rows, np.float32(self.cfg.req_bytes),
                            np.float32),
                    np.ones(num_rows, bool))
        return (np.zeros(num_rows, np.float32),
                np.ones(num_rows, np.float32), np.zeros(num_rows, bool))

    def init_state(self, num_functions: int) -> offload.OffloadState:
        return offload.OffloadState.init(num_functions, self.cfg)

    def update(self, state, latencies, valid, demand_rps):
        state, R = offload.offload_update(
            state, torch.as_tensor(np.asarray(latencies, np.float32)),
            torch.as_tensor(np.asarray(valid, bool)), self.cfg,
            demand_rps=torch.as_tensor(np.asarray(demand_rps, np.float32)))
        return state, R.numpy().astype(np.float32)

    def set_link_capacity(self, link_bytes_per_s: float) -> bool:
        """Re-cap a net-aware controller against a changed link (a fault
        shrinks or restores it).  The boundary's state is untouched; only
        the capacity the next cap divides changes.  No-op (False) for a
        controller that is not net-aware."""
        if not self.cfg.net_aware:
            return False
        self.cfg = dataclasses.replace(
            self.cfg, link_bytes_per_s=float(link_bytes_per_s))
        return True


class NetAwareOffload(AutoOffload):
    """Beyond-paper extension: cap the offloaded share by what the link
    carries at the current demand (``R <= 100 * link / (rps * bytes)``)."""

    spec = "auto+net"

    def __init__(self, cfg: Optional[offload.OffloadConfig] = None,
                 link_bytes_per_s: Optional[float] = None,
                 req_bytes: Optional[float] = None):
        cfg = cfg or offload.OffloadConfig()
        repl: Dict[str, Any] = {"net_aware": True}
        if link_bytes_per_s is not None:
            repl["link_bytes_per_s"] = link_bytes_per_s
        if req_bytes is not None:
            repl["req_bytes"] = req_bytes
        super().__init__(dataclasses.replace(cfg, **repl))


class HedgedOffload(AutoOffload):
    """Auto controller + request-level straggler mitigation: a queued
    request whose age already exceeds its function's p99 gets a backup
    issued on another tier (:func:`router.hedged_mask`)."""

    spec = "auto+hedge"

    def __init__(self, cfg: Optional[offload.OffloadConfig] = None,
                 hedge_quantile: float = 0.99):
        super().__init__(cfg)
        self.hedge_quantile = float(hedge_quantile)

    def hedge(self, ages_s, fn_ids, latencies, valid):
        if len(fn_ids) == 0:
            return np.zeros(0, bool)
        p = self._tail_estimate(latencies, valid)
        return router.hedged_mask(
            torch.as_tensor(np.asarray(ages_s, np.float32)),
            torch.from_numpy(p),
            torch.as_tensor(np.asarray(fn_ids, np.int64))).numpy()

    def _tail_estimate(self, latencies, valid) -> np.ndarray:
        """(F,) per-function tail latency (numpy's percentile, as the
        reference); +inf where nothing was observed yet (never hedge
        blind)."""
        lat = np.where(valid, np.asarray(latencies, np.float32), np.nan)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN rows
            p = np.nanpercentile(lat, self.hedge_quantile * 100.0, axis=-1)
        return np.where(np.isfinite(p), p, np.inf).astype(np.float32)


class MigratingOffload(AutoOffload):
    """Auto controller + mid-stream migration (``"auto+migrate"``): once
    a boundary's R_t reaches ``migrate_threshold`` the live scheduler
    ships ``ceil(eligible * R_t / 100)`` slot-resident rows (longest
    remaining decode first, at least ``migrate_min_remaining`` tokens to
    go) down-chain with their cache state, and the simulator moves the
    same share of its in-service requests."""

    spec = "auto+migrate"
    default_threshold = 50.0

    def __init__(self, cfg: Optional[offload.OffloadConfig] = None,
                 migrate_threshold: float = default_threshold,
                 migrate_min_remaining: int = 2):
        super().__init__(cfg)
        self.migrate_threshold = float(migrate_threshold)
        self.migrate_min_remaining = int(migrate_min_remaining)


class ControlLoop:
    """The shared scrape-and-update cycle (one per deployment).

    Each step reads the per-function latency windows, mixes in the ages
    of requests still queued at the gateway (the onset signal that lets
    Eq (1) fire before slow completions drain out), derives demand RPS
    and asks each boundary's policy for fresh R_t percentages.  Boundary
    b is driven by tier b's signals and yields R_t[b], the percentage of
    tier b's load pushed down the chain.

    ``eq1="window"`` reads Eq (1) from the sorted windows (:meth:`step`,
    :meth:`step_tiers`), one boundary at a time: the rows are row-local,
    so this equals the reference's stacked rows kernel too.
    ``eq1="sketch"`` reads it from decayed log-bucket histograms
    (``sketch``, a :class:`~repro_torch.core.quantile.SketchSpec`) fed
    each tick's fresh samples by :meth:`step_stream`.  The sketch's sums
    depend on the row count, so it keeps the reference's layout: every
    boundary on an unmodified auto-family policy with shared
    Eq-(2)/(3)/(4) constants, row b*F + f of one state padded to
    :func:`~repro_torch.core.offload.padded_rows`, one call a tick.
    Every row reproduces the reference's rounding, so a trajectory is
    bitwise the reference's on the same inputs.
    """

    def __init__(self, policy: PolicySpec, num_functions: int,
                 window: int = 64, control_interval_s: float = 1.0,
                 num_tiers: int = 2,
                 boundary_policies: Optional[Sequence[PolicySpec]] = None,
                 eq1: str = "window",
                 sketch: Optional[quantile.SketchSpec] = None):
        if num_tiers < 1:
            raise ValueError(f"num_tiers must be >= 1, got {num_tiers}")
        if eq1 not in ("window", "sketch"):
            raise ValueError(f'eq1 must be "window" or "sketch", got {eq1!r}')
        self.eq1 = eq1
        self.num_functions = num_functions
        self.window = window
        self.control_interval_s = control_interval_s
        self.num_tiers = int(num_tiers)
        self.num_boundaries = max(self.num_tiers - 1, 1)
        if boundary_policies is None:
            self.policy = Policy.parse(policy)
            self.policies = [self.policy] * self.num_boundaries
        else:
            if len(boundary_policies) != self.num_boundaries:
                raise ValueError(
                    f"{self.num_boundaries} boundaries need "
                    f"{self.num_boundaries} policies, "
                    f"got {len(boundary_policies)}")
            self.policies = [Policy.parse(p) for p in boundary_policies]
            self.policy = self.policies[0]
        self._states: Optional[list] = None
        if eq1 == "window":
            self._states = [self.policies[b].init_state(num_functions)
                            for b in range(self.num_boundaries)]
        else:
            if not self._vectorizable():
                raise ValueError(
                    'eq1="sketch" needs every boundary on an unmodified '
                    "auto-family policy with shared controller constants")
            # row b*F + f is (boundary b, function f)
            self._P = offload.padded_rows(self.num_boundaries
                                          * num_functions)
            self._structural = self.policies[0]._structural_cfg()
            self._vstate = offload.OffloadState.init(self._P,
                                                     self._structural)
            self._net_cache = None
            self.sketch_spec = sketch or quantile.SketchSpec()
            self._hist = quantile.Histogram.init(
                self._P, self.sketch_spec.num_buckets,
                self.sketch_spec.lo, self.sketch_spec.hi)
            self._decay = torch.tensor(self.sketch_spec.decay,
                                       dtype=torch.float32)
            # a boundary becomes (and stays) active once it has ever
            # produced a sample, as a window retains observations
            self._seen = np.zeros(self.num_boundaries, bool)
        self.R_all = np.stack([self.policies[b].initial_R(num_functions)
                               for b in range(self.num_boundaries)])
        self.steps = 0

    def _vectorizable(self) -> bool:
        """True when every boundary can join the sketch's stacked update:
        unmodified auto-family policies (no custom update / observe /
        state hooks) sharing the Eq-(2)/(3)/(4) constants; net-aware
        fields may differ (they are per-row data)."""
        pols = self.policies
        if not all(isinstance(p, AutoOffload) for p in pols):
            return False
        if not all(type(p).update is AutoOffload.update
                   and type(p).observe is Policy.observe
                   and type(p).init_state is AutoOffload.init_state
                   for p in pols):
            return False
        return len({(p.cfg.c_decay, p.cfg.c_t, p.cfg.c_soft,
                     p.cfg.c_hard, p.cfg.c_in) for p in pols}) == 1

    @property
    def states(self) -> list:
        """Per-boundary controller states (views of the stacked state's
        rows under the sketch)."""
        if self._states is not None:
            return self._states
        F, s = self.num_functions, self._vstate
        return [offload.OffloadState(
                    s.ratios[b * F:(b + 1) * F], s.head[b * F:(b + 1) * F],
                    s.filled[b * F:(b + 1) * F], s.R[b * F:(b + 1) * F])
                for b in range(self.num_boundaries)]

    @staticmethod
    def _sample_ages(ages: Sequence[float], window: int) -> List[float]:
        """Evenly subsample up to ``window // 2`` in-flight ages."""
        k = min(len(ages), window // 2)
        return [ages[int(i * len(ages) / k)] for i in range(k)] if k else []

    @staticmethod
    # lint: ignore[parity-drift] -- the port imports nothing of repro;
    # tests/test_torch_control.py::test_mix_queue_ages_matches_reference
    # holds this copy against repro.core.policy.ControlLoop.mix_queue_ages
    def mix_queue_ages(lat: np.ndarray, valid: np.ndarray, fn: int,
                       ages: Sequence[float], window: int) -> None:
        """Displace the oldest completions of function ``fn`` with an even
        spread of in-flight queue ages (in place)."""
        sel = ControlLoop._sample_ages(ages, window)
        if sel:
            lat[fn, :len(sel)] = sel
            valid[fn, :len(sel)] = True

    def _rps(self, arrivals: Optional[Sequence[float]]) -> np.ndarray:
        """Arrival counts -> (F,) demand RPS, floored at 1e-3 (divided in
        float64, rounded once to float32, as the reference)."""
        if arrivals is None:
            return np.full(self.num_functions, np.float32(1e-3), np.float32)
        a = np.asarray(arrivals, np.float64)
        return np.maximum(a / self.control_interval_s, 1e-3).astype(
            np.float32)

    def _per_boundary_rps(self, arrivals: Optional[Sequence]
                          ) -> List[np.ndarray]:
        if (arrivals is not None and len(arrivals)
                and isinstance(arrivals[0], (list, tuple, np.ndarray))):
            if len(arrivals) != self.num_boundaries:
                raise ValueError(
                    f"{self.num_boundaries} boundaries need "
                    f"{self.num_boundaries} arrival counts, "
                    f"got {len(arrivals)}")
            return [self._rps(a) for a in arrivals]
        return [self._rps(arrivals)] * self.num_boundaries

    def _step_boundary(self, b: int, latencies: np.ndarray,
                       valid: np.ndarray,
                       queue_ages: Optional[Sequence[Sequence[float]]],
                       rps: np.ndarray) -> np.ndarray:
        pol = self.policies[b]
        lat = np.array(latencies, np.float32, copy=True)
        val = np.array(valid, bool, copy=True)
        if queue_ages is not None:
            for fn, ages in enumerate(queue_ages):
                if ages:
                    self.mix_queue_ages(lat, val, fn, ages, self.window)
        self._states[b] = pol.observe(self._states[b], lat, val)
        if val.any():
            self._states[b], R = pol.update(self._states[b], lat, val, rps)
            self.R_all[b] = np.asarray(R, np.float32)
        return self.R_all[b]

    def _net_row_arrays(self) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
        """Stacked per-row net-cap inputs, re-read from each boundary's
        ``cfg`` every tick (a ``set_link_capacity`` re-caps the next
        update); rebuilt only when a cfg changed."""
        key = tuple(pol.cfg for pol in self.policies)
        if self._net_cache is not None and self._net_cache[0] == key:
            return self._net_cache[1]
        F, P = self.num_functions, self._P
        link = np.zeros(P, np.float32)
        req = np.ones(P, np.float32)
        net = np.zeros(P, bool)
        for b, pol in enumerate(self.policies):
            lo = b * F
            link[lo:lo + F], req[lo:lo + F], net[lo:lo + F] = pol.net_rows(F)
        arrays = (torch.from_numpy(link), torch.from_numpy(req),
                  torch.from_numpy(net))
        self._net_cache = (key, arrays)
        return arrays

    def _row_rps(self, per_b_rps: Sequence[np.ndarray]) -> torch.Tensor:
        F = self.num_functions
        rps = np.full(self._P, 1e-3, np.float32)
        for b, r in enumerate(per_b_rps):
            rps[b * F:(b + 1) * F] = r
        return torch.from_numpy(rps)

    def step(self, latencies: np.ndarray, valid: np.ndarray,
             queue_ages: Optional[Sequence[Sequence[float]]] = None,
             arrivals: Optional[Sequence[float]] = None) -> np.ndarray:
        """One control interval on the ingress boundary -> (F,) R_t.
        Deeper boundaries are left untouched (see :meth:`step_tiers`)."""
        if self.eq1 == "sketch":
            raise ValueError('eq1="sketch" loops are driven by '
                             "step_stream(), not step()")
        out = self._step_boundary(0, latencies, valid, queue_ages,
                                  self._rps(arrivals))
        self.steps += 1
        return out

    def step_tiers(self, latencies: Sequence[np.ndarray],
                   valid: Sequence[np.ndarray],
                   queue_ages: Optional[Sequence] = None,
                   arrivals: Optional[Sequence] = None) -> np.ndarray:
        """One control interval over every boundary of the chain.

        latencies, valid: per-boundary (F, W) windows; queue_ages:
        per-boundary, per-function in-flight ages (or None); arrivals:
        one flat per-function count shared by every boundary, or one per
        boundary.  Returns the (num_tiers-1, F) stack of R_t.
        """
        if self.eq1 == "sketch":
            raise ValueError('eq1="sketch" loops are driven by '
                             "step_stream(), not step_tiers()")
        if len(latencies) != self.num_boundaries:
            raise ValueError(
                f"{self.num_boundaries} boundaries need {self.num_boundaries}"
                f" latency windows, got {len(latencies)}")
        if queue_ages is not None and len(queue_ages) != self.num_boundaries:
            raise ValueError(
                f"{self.num_boundaries} boundaries need {self.num_boundaries}"
                f" queue-age entries, got {len(queue_ages)}")
        per_b = self._per_boundary_rps(arrivals)
        for b in range(self.num_boundaries):
            qa = queue_ages[b] if queue_ages is not None else None
            self._step_boundary(b, latencies[b], valid[b], qa, per_b[b])
        self.steps += 1
        return self.R_all

    def step_stream(self, samples: Sequence,
                    queue_ages: Optional[Sequence] = None,
                    arrivals: Optional[Sequence] = None) -> np.ndarray:
        """One streaming control interval (``eq1="sketch"`` loops).

        samples: per-boundary ``(fn_ids, values)`` pairs of the latencies
        recorded since the last tick (``MetricsRegistry.drain_fresh``),
        or None for an idle boundary; queue_ages: as in
        :meth:`step_tiers`, subsampled by :meth:`_sample_ages` and
        ingested as extra samples; arrivals: as in :meth:`step_tiers`.
        The batch is padded to a power of two (at least 8) with invalid
        samples, then every row's histogram and controller advance in one
        call.  Returns the (num_tiers-1, F) stack of R_t."""
        if self.eq1 != "sketch":
            raise ValueError('step_stream() requires eq1="sketch"')
        if len(samples) != self.num_boundaries:
            raise ValueError(
                f"{self.num_boundaries} boundaries need {self.num_boundaries}"
                f" sample sets, got {len(samples)}")
        F, B, P = self.num_functions, self.num_boundaries, self._P
        per_b = self._per_boundary_rps(arrivals)
        rows_parts: List[np.ndarray] = []
        vals_parts: List[np.ndarray] = []
        for b in range(B):
            if samples[b] is not None:
                ids, vals = samples[b]
                if len(ids):
                    rows_parts.append(np.asarray(ids, np.int64) + b * F)
                    vals_parts.append(np.asarray(vals, np.float32))
            qa = queue_ages[b] if queue_ages is not None else None
            if qa is not None:
                for fn, ages in enumerate(qa):
                    sel = self._sample_ages(ages, self.window)
                    if sel:
                        rows_parts.append(
                            np.full(len(sel), b * F + fn, np.int64))
                        vals_parts.append(np.asarray(sel, np.float32))
        rows = (np.concatenate(rows_parts) if rows_parts
                else np.zeros(0, np.int64))
        vals = (np.concatenate(vals_parts) if vals_parts
                else np.zeros(0, np.float32))
        for b in range(B):
            if not self._seen[b] and rows.size:
                self._seen[b] = bool(np.any((rows >= b * F)
                                            & (rows < (b + 1) * F)))
        S = max(8, 1 << (max(int(rows.size), 1) - 1).bit_length())
        rows_p = np.zeros(S, np.int64)
        vals_p = np.zeros(S, np.float32)
        svalid = np.zeros(S, bool)
        rows_p[:rows.size] = rows
        vals_p[:vals.size] = vals
        svalid[:rows.size] = True
        active = np.zeros(P, bool)
        active[:B * F] = np.repeat(self._seen, F)
        self._vstate, self._hist, R = offload.offload_update_rows_stream(
            self._vstate, self._hist, torch.from_numpy(rows_p),
            torch.from_numpy(vals_p), torch.from_numpy(svalid), self._decay,
            torch.from_numpy(active), *self._net_row_arrays(),
            self._row_rps(per_b), self._structural)
        self.R_all = R.numpy()[:B * F].reshape(B, F).astype(np.float32)
        self.steps += 1
        return self.R_all

    def dist(self) -> np.ndarray:
        """The current (F, num_tiers) routing distribution."""
        return self.policy.tier_distribution(self.R_all, self.num_tiers)

    def route_tiers(self, rng: np.random.Generator,
                    fn_ids: np.ndarray) -> np.ndarray:
        """Assign a queued batch over all N tiers -> (B,) tier indices."""
        return self.policy.route_tiers(rng, self.dist(), fn_ids,
                                       self.num_functions)

    def hedge(self, ages_s: np.ndarray, fn_ids: np.ndarray,
              latencies: np.ndarray, valid: np.ndarray) -> np.ndarray:
        """The ingress boundary's policy decides which queued requests
        get a backup (no draws)."""
        return self.policy.hedge(ages_s, fn_ids, latencies, valid)
