"""Discrete-event simulator of the continuum testbed (§4 of the paper).

The port's copy of ``repro/core/simulator.py``: the paper's apparatus
(Raspberry-Pi-class edge instances, an elastic cloud, a shared 100 MB/s
edge->cloud link, a ramped open-loop generator) over any
:class:`~repro_torch.core.topology.Topology` — per-tier service pools and
bounded queues, per-link FIFO pipes, one latency registry per controller
boundary, waterfall spill, mid-stream migration events, and fault
schedules with tier crash and replay.  It draws from
``np.random.default_rng(cfg.seed)`` in the reference's order, and its
controller is the port's own :class:`~repro_torch.core.policy.ControlLoop`
(bitwise the reference's rounding), so a run's :class:`SimResult` equals
the reference's field for field, under either Eq-(1) front end
(``eq1="window"``, or ``"sketch"``: each scrape drains the samples
recorded since the last into the controller's histograms).
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.cache import pages_needed
from repro_torch.core import offload
from repro_torch.core.metrics import MetricsRegistry
from repro_torch.core.policy import (AutoOffload, ControlLoop, Policy,
                                     PolicySpec)
from repro_torch.core.topology import LinkSpec, TierSpec, Topology
from repro_torch.core.workloads import PROFILES, WorkloadProfile
from repro_torch.workloads.faults import FaultSchedule, LinkState
from repro_torch.workloads.trace import ArrivalProcess, RampedPoisson, Trace


@dataclasses.dataclass(frozen=True)
class SimConfig:
    duration_s: float = 600.0
    low_rps: float = 2.0
    high_rps: float = 16.0
    ramp_start_s: float = 60.0
    ramp_end_s: float = 240.0
    edge_instances: int = 4            # the paper's 4x Raspberry Pi 3B+
    edge_slots_per_instance: int = 1
    cloud_slots: int = 64
    link_bandwidth_Bps: float = 100e6  # paper: "maximum of 100MB/s"
    link_rtt_s: float = 0.04
    timeout_s: float = 10.0
    control_interval_s: float = 1.0    # Prometheus scrape cadence
    metric_interval_s: float = 5.0
    window: int = 64                   # latency window fed to Eq (1)
    mem_baseline_mb: float = 180.0
    # Knative queue-proxy semantics: per-instance request queue is bounded;
    # overflow is rejected immediately (503). Fast rejections are *part of*
    # the latency distribution Prometheus scrapes — they are what keeps
    # Eq (1) bimodal (and hence alive) under deep overload.
    queue_depth_per_slot: int = 8
    reject_latency_s: float = 0.005
    seed: int = 0

    def default_topology(self) -> Topology:
        """The paper's two-tier apparatus as a Topology (waterfall off:
        edge overflow 503s, exactly the seed semantics)."""
        return Topology(
            tiers=(TierSpec("edge",
                            slots=self.edge_instances
                            * self.edge_slots_per_instance,
                            queue_depth_per_slot=self.queue_depth_per_slot),
                   TierSpec("cloud", slots=self.cloud_slots,
                            queue_depth_per_slot=None)),
            links=(LinkSpec(rtt_s=self.link_rtt_s,
                            bandwidth_Bps=self.link_bandwidth_Bps),),
            waterfall=False)


@dataclasses.dataclass
class SimResult:
    policy: str
    workload: str
    successes: int
    failures: int
    times: np.ndarray              # (T,) metric timestamps
    latency_avg: np.ndarray        # (T,) mean completed latency per interval
    cpu_util: np.ndarray           # (T,) ingress-tier busy fraction
    mem_mb: np.ndarray             # (T,) ingress-tier resident memory
    net_MBps: np.ndarray           # (T,) ingress link egress
    offload_pct: np.ndarray        # (T,) ingress boundary controller output
    # (L, T) egress per link, chain order; row 0 duplicates net_MBps (the
    # headline field kept for golden-trajectory compatibility).  Deep rows
    # are what show link saturation past the first boundary in N-tier runs.
    net_links_MBps: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 0)))
    # per-tier successful completions, in chain order
    tier_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    # requests that overflowed a tier and were spilled down the chain
    spilled: int = 0
    # mid-stream migrations (policies with a migrate_threshold): fired =
    # in-service requests shipped down-chain; aborted = destination full
    # at landing, resumed at the source instead — never lost
    migrations_fired: int = 0
    migrations_completed: int = 0
    migrations_aborted: int = 0
    # fault injection: requests submitted overall (for the conservation
    # identity successes + failures == submitted), requests replayed off a
    # crashed tier, fault events applied
    submitted: int = 0
    replayed: int = 0
    faults_applied: int = 0

    def summary(self) -> Dict[str, float]:
        out = {
            "successes": self.successes,
            "failures": self.failures,
            "latency_avg": float(np.nanmean(self.latency_avg)),
            "cpu_peak": float(self.cpu_util.max(initial=0.0)),
            "net_peak_MBps": float(self.net_MBps.max(initial=0.0)),
        }
        for l in range(1, self.net_links_MBps.shape[0]):
            out[f"net_peak_MBps_link{l}"] = float(
                self.net_links_MBps[l].max(initial=0.0))
        for name, n in self.tier_counts.items():
            out[f"served_{name}"] = n
        if self.spilled:
            out["spilled"] = self.spilled
        if self.migrations_fired:
            out["migrations_fired"] = self.migrations_fired
            out["migrations_completed"] = self.migrations_completed
            out["migrations_aborted"] = self.migrations_aborted
        if self.faults_applied:
            out["faults_applied"] = self.faults_applied
            out["replayed"] = self.replayed
        return out


# Event kinds, ordered for deterministic tie-breaking (ties never reach the
# kind field — the monotone sequence number breaks them first).
_ARRIVAL, _DONE, _CONTROL, _METRIC, _MIGRATE, _FAULT = range(6)


def _service_sample(rng: np.random.Generator, mean: float, cv: float) -> float:
    """Lognormal service time with given mean and coefficient of variation."""
    sigma2 = np.log(1.0 + cv * cv)
    mu = np.log(mean) - 0.5 * sigma2
    return float(rng.lognormal(mu, np.sqrt(sigma2)))


def _tier_service_mean(prof: WorkloadProfile, topo: Topology, i: int) -> float:
    """Resolve tier i's mean service time from the workload profile.

    An explicit ``service_rate_mult`` scales relative to the profile's
    edge speed; ``None`` means positional defaults — ingress runs at edge
    speed, the deepest tier at cloud speed, intermediates interpolate
    geometrically.  A cost-modeled spec (``model`` set) must arrive
    *resolved*: its derived multiplier replaces the sentinel, so the
    positional-default branch below stays reserved for hand-set chains
    (``Topology.pair``'s elastic cloud keeps its seed meaning) and can
    never silently mask a missing cost resolution.
    """
    spec = topo.tiers[i]
    if spec.model is not None and spec.service_rate_mult is None:
        raise ValueError(
            f"tier {spec.name!r} declares a cost model ({spec.model}) but "
            f"is unresolved; build the chain via Topology.costed(...) or "
            f"call .resolve_costs() before simulating")
    if spec.service_rate_mult is not None:
        return prof.edge_service_s / spec.service_rate_mult
    if i == 0:
        return prof.edge_service_s
    last = len(topo.tiers) - 1
    if i == last:
        return prof.cloud_service_s
    frac = i / last
    return float(prof.edge_service_s
                 * (prof.cloud_service_s / prof.edge_service_s) ** frac)


class _SimTier:
    """Mutable per-tier state inside one run.

    A tier whose spec declares ``page_size`` carries the same page
    ledger the live paged endpoint keeps: every resident request holds
    the pages its (prompt_len, max_new) extent reserves — the one shared
    formula, :func:`repro_torch.cache.pages_needed` — and admission requires
    both a slot and the pages.  Dense tiers keep ``page_need == 0``
    everywhere, so their math (and the event/RNG sequence) is untouched.
    """

    def __init__(self, spec: TierSpec, service_mean: float):
        self.spec = spec
        self.service_mean = service_mean
        self.busy = 0
        # (arrival_time, size) where size = (prompt_len, max_new) for
        # trace-driven arrivals, None otherwise
        self.queue: Deque[Tuple[float, Optional[Tuple[int, int]]]] = deque()
        self.served = 0
        self.pages_total = getattr(spec, "total_pages", 0) or 0
        self.pages_used = 0

    @property
    def queue_cap(self) -> Optional[int]:
        if self.spec.queue_depth_per_slot is None:
            return None
        return self.spec.slots * self.spec.queue_depth_per_slot

    def page_need(self, size: Optional[Tuple[int, int]]) -> int:
        """Pages a request of ``size`` reserves here (0 on dense tiers;
        a size-less request conservatively reserves a full row — with
        the default pool of ``slots`` full rows that makes the page gate
        coincide exactly with the slot gate)."""
        if getattr(self.spec, "page_size", None) is None:
            return 0
        if size is None:
            return self.spec.pages_per_row
        return pages_needed(size[0], max(size[1], 1),
                            self.spec.page_size, self.spec.max_len)

    def can_serve(self, size: Optional[Tuple[int, int]]) -> bool:
        """Slot AND page availability (dense tiers: 0 + 0 <= 0)."""
        return (self.busy < self.spec.slots
                and self.pages_used + self.page_need(size)
                <= self.pages_total)


class ContinuumSimulator:
    """One workload, one policy, one run."""

    def __init__(self, workload: str, policy: PolicySpec,
                 cfg: SimConfig = SimConfig(),
                 offload_cfg: Optional[offload.OffloadConfig] = None,
                 topology: Optional[Topology] = None,
                 trace: Optional[Union[ArrivalProcess, Trace]] = None,
                 faults: Optional[FaultSchedule] = None,
                 eq1: str = "window", sketch=None):
        if workload not in PROFILES:
            raise ValueError(f"unknown workload {workload!r}")
        self.profile: WorkloadProfile = PROFILES[workload]
        self.cfg = cfg
        self.policy = policy
        self.topology = topology or cfg.default_topology()
        # Arrivals come from repro_torch.workloads in either form: an
        # inline-draw ArrivalProcess (the default is the historical ramp,
        # bit-identical draws) or a materialized Trace (per-request
        # times/payloads replayed verbatim; the simulator is a
        # single-function apparatus, so the trace's fn column only sets
        # per-request payload bytes here).
        self.trace: Optional[Trace] = None
        if trace is None:
            self.arrivals: Optional[ArrivalProcess] = RampedPoisson(
                cfg.low_rps, cfg.high_rps, cfg.ramp_start_s, cfg.ramp_end_s)
        elif isinstance(trace, Trace):
            self.arrivals = None
            self.trace = trace
        elif isinstance(trace, ArrivalProcess):
            self.arrivals = trace
        else:
            raise TypeError(f"trace must be an ArrivalProcess or Trace, "
                            f"got {type(trace).__name__}")
        self.faults = faults
        if faults is not None:
            faults.validate(self.topology.num_tiers)
        self.rng = np.random.default_rng(cfg.seed)
        # One latency registry per non-terminal tier: registry b feeds
        # controller boundary b.  (The deepest tier's latencies are not fed
        # to Eq (1): the paper's strategy "uses the request latency metrics
        # of all the functions running at the Edge".)
        cap = max(cfg.window * 4, 256)
        n_bounds = max(self.topology.num_tiers - 1, 1)
        self.tier_metrics = [MetricsRegistry([workload], capacity=cap)
                             for _ in range(n_bounds)]
        self.metrics = self.tier_metrics[0]
        # The same Policy/ControlLoop objects the live runtime drives —
        # the simulator is the calibration harness, not a reimplementation.
        # Each boundary parses the policy against ITS link's capacity, so
        # auto+net caps offload by the link actually being crossed.
        base_cfg = offload_cfg or offload.OffloadConfig()
        links = (self.topology.links
                 or (LinkSpec(rtt_s=cfg.link_rtt_s,
                              bandwidth_Bps=cfg.link_bandwidth_Bps),))
        boundary_policies = [
            Policy.parse(policy, offload_cfg=base_cfg,
                         link_bytes_per_s=links[min(b, len(links) - 1)]
                         .bandwidth_Bps,
                         req_bytes=self.profile.payload_bytes)
            for b in range(max(self.topology.num_tiers - 1, 1))]
        self.policy_obj = boundary_policies[0]
        self.offload_cfg = (self.policy_obj.cfg
                            if isinstance(self.policy_obj, AutoOffload)
                            else base_cfg)
        self.control = ControlLoop(self.policy_obj, 1, window=cfg.window,
                                   control_interval_s=cfg.control_interval_s,
                                   num_tiers=self.topology.num_tiers,
                                   boundary_policies=boundary_policies,
                                   eq1=eq1, sketch=sketch)

    # ------------------------------------------------------------------
    def _rate(self, t: float) -> float:
        """Inline-draw arrival rate (from repro_torch.workloads:
        the default RampedPoisson computes the historical ramp with the
        identical float expressions, so draws are bit-identical)."""
        return self.arrivals.rate(t)

    def _choose_tier(self, u: float, R_cur: np.ndarray) -> int:
        """Pick a tier from one uniform draw and the per-boundary R_t.

        Single-draw waterfall: cross boundary b iff ``u*100 < R_t[b]``,
        then rescale u to the conditional uniform for the next boundary.
        For two tiers this is exactly the historical coin flip
        ``u * 100 < pct`` (bit-identical draw and comparison).
        """
        j, v = 0, u
        for b in range(len(R_cur)):
            pct = float(R_cur[b])
            if v * 100.0 < pct:
                j += 1
                v = v * 100.0 / pct
            else:
                break
        return j

    def run(self) -> SimResult:
        cfg, prof, topo = self.cfg, self.profile, self.topology
        N = topo.num_tiers
        last = N - 1
        events: List[Tuple[float, int, int, tuple]] = []
        seq = itertools.count()

        def push(t: float, kind: int, payload: tuple = ()):
            heapq.heappush(events, (t, next(seq), kind, payload))

        # --- state ----------------------------------------------------
        tiers = [_SimTier(spec, _tier_service_mean(prof, topo, i))
                 for i, spec in enumerate(topo.tiers)]
        # Fault overlay: links are crossed through their mutable LinkState
        # (identity multipliers while healthy — the float math is
        # unchanged), and crashed tiers forward traffic but cannot serve.
        link_state = [LinkState(l) for l in topo.links]
        tier_up = [True] * N
        submitted = replayed = faults_applied = 0
        link_free_at = [0.0] * len(topo.links)
        link_bytes = [0.0] * len(topo.links)
        # Per-boundary R_t for the tier chooser: exactly N-1 rows (empty
        # for a single-tier chain — everything stays at the ingress;
        # ControlLoop keeps one boundary row even then, which routing
        # must not see).
        R_cur = np.array(self.control.R_all[:N - 1, 0], np.float64)
        successes = failures = spilled = 0
        # In-service bookkeeping for mid-stream migration: every started
        # service gets a token; migrating a request deletes its token so
        # the already-queued _DONE event is recognized as stale when it
        # pops.  (Policies without a migrate_threshold never delete, so
        # their event trace — and RNG draw sequence — is unchanged.)
        svc_seq = itertools.count()
        # tok -> (j, arr, t_done, pages_held, size)
        svc_live: Dict[int, Tuple[int, float, float, int,
                                  Optional[Tuple[int, int]]]] = {}
        mig_fired = mig_completed = mig_aborted = mig_transit = 0
        # Demand per boundary this interval: boundary b sees the requests
        # that reached tier b (routing or spill) — what its net-aware cap
        # divides the link capacity by.
        n_bounds = self.control.num_boundaries
        arrivals_in_interval = [0] * n_bounds
        completed_lat: List[float] = []
        busy_integral = 0.0
        last_busy_t = 0.0
        ingress_slots = max(tiers[0].spec.slots, 1)

        ts, lat_s, cpu_s, mem_s, net_s, off_s = ([] for _ in range(6))
        net_links: List[List[float]] = [[] for _ in topo.links]

        def note_busy(t: float):
            nonlocal busy_integral, last_busy_t
            busy_integral += tiers[0].busy / ingress_slots * (t - last_busy_t)
            last_busy_t = t

        # --- seed events ------------------------------------------------
        if self.trace is not None:
            # materialized trace: event i chains event i+1 at trace.t[i+1]
            if len(self.trace):
                push(float(self.trace.t[0]), _ARRIVAL, (0,))
            duration = self.trace.duration_s
        else:
            push(self.rng.exponential(1.0 / self._rate(0.0)), _ARRIVAL)
            duration = cfg.duration_s
        push(cfg.control_interval_s, _CONTROL)
        push(cfg.metric_interval_s, _METRIC)
        if self.faults is not None:
            self.faults.reset()
            for ev in self.faults:
                push(ev.t, _FAULT, (ev,))

        def start_service(j: int, ready: float, arr: float,
                          size=None):
            tier = tiers[j]
            if j == 0:
                note_busy(ready)
            tier.busy += 1
            pages = tier.page_need(size)
            tier.pages_used += pages
            svc = _service_sample(self.rng, tier.service_mean, prof.cv)
            tok = next(svc_seq)
            svc_live[tok] = (j, arr, ready + svc, pages, size)
            push(ready + svc, _DONE, (j, arr, tok))

        def resume_service(j: int, t: float, arr: float, remaining: float,
                           size=None):
            """Restart a migrated request with its *remaining* work (no
            fresh service sample — migration moves the request, it does
            not restart it)."""
            tier = tiers[j]
            if j == 0:
                note_busy(t)
            tier.busy += 1
            pages = tier.page_need(size)
            tier.pages_used += pages
            tok = next(svc_seq)
            svc_live[tok] = (j, arr, t + remaining, pages, size)
            push(t + remaining, _DONE, (j, arr, tok))

        def cross_link(l: int, ready: float,
                       nbytes: Optional[float] = None) -> float:
            """Serialize one payload over link l (FIFO pipe model:
            saturation shows up as link_free_at running ahead of time).
            The fault overlay's degraded bandwidth/RTT apply here; a
            materialized trace's per-request payload overrides the
            profile's for the arrival hop walk."""
            nb = prof.payload_bytes if nbytes is None else nbytes
            xfer = nb / link_state[l].bandwidth_Bps
            start = max(ready, link_free_at[l])
            link_free_at[l] = start + xfer
            link_bytes[l] += nb
            return link_free_at[l] + link_state[l].rtt_s

        def route_target(j: int) -> Optional[int]:
            """Resolve an assigned tier against the fault state: crashed
            tiers forward but cannot serve, a partitioned link cuts off
            everything past it.  Prefer the shallowest serviceable tier
            at or past the assignment, else the deepest one before it;
            None when nothing can serve (the request 503s)."""
            if self.faults is None:
                return j
            reach = 0
            for l in range(N - 1):
                if not link_state[l].up:
                    break
                reach = l + 1
            up = [i for i in range(reach + 1) if tier_up[i]]
            if not up:
                return None
            for i in up:
                if i >= j:
                    return i
            return up[-1]

        def backfill(j: int, t: float):
            """A slot freed (completion or migration): admit the next
            queued request, dropping timed-out waiters."""
            nonlocal failures
            tier = tiers[j]
            while tier.queue:
                qarr, qsize = tier.queue.popleft()
                if t - qarr > cfg.timeout_s:
                    failures += 1
                    if j < last:
                        self.tier_metrics[j].record_latency(
                            prof.name, t - qarr)
                    continue
                if not tier.can_serve(qsize):
                    # freed capacity doesn't cover the head request's
                    # page reservation: it keeps its place in line
                    tier.queue.appendleft((qarr, qsize))
                    break
                start_service(j, t, qarr, qsize)
                break

        def fire_migrations(t: float):
            """Mid-stream migration, the simulator's in-service transfer:
            every boundary whose policy crossed its migrate_threshold
            ships ceil(in_service * R_t/100) requests (longest remaining
            service first) over its link; the request resumes down-chain
            with its remaining work scaled by the service-speed ratio.
            The payload serializes over the link's FIFO pipe, so
            migration egress shows up in ``net_links_MBps`` like any
            other crossing."""
            nonlocal mig_fired, mig_transit
            for b in range(N - 1):
                pol = self.control.policies[b]
                thr = pol.migrate_threshold
                if thr is None or float(R_cur[b]) < thr:
                    continue
                if not (link_state[b].up and tier_up[b + 1]):
                    continue       # no migrating into a partition/crash
                in_svc = [(tok, rec) for tok, rec in svc_live.items()
                          if rec[0] == b]
                n_mig = min(len(in_svc),
                            int(np.ceil(len(in_svc) * float(R_cur[b])
                                        / 100.0)))
                if n_mig <= 0:
                    continue
                # longest remaining service first (most slot-hungry);
                # token order breaks ties deterministically
                in_svc.sort(key=lambda e: (-(e[1][2] - t), e[0]))
                for tok, (j, arr, t_done, pages, size) in in_svc[:n_mig]:
                    del svc_live[tok]          # the queued _DONE is stale
                    if j == 0:
                        note_busy(t)
                    tiers[j].busy -= 1
                    tiers[j].pages_used -= pages
                    mig_fired += 1
                    mig_transit += 1
                    if b + 1 < n_bounds:
                        arrivals_in_interval[b + 1] += 1
                    push(cross_link(b, t), _MIGRATE,
                         (b + 1, arr, t_done - t, j, size))
                    backfill(j, t)             # the freed slot backfills

        def admit(j: int, ready: float, arr: float, size=None):
            """Hand a request to tier j; overflow spills down the chain
            (waterfall) or rejects, per the topology.  Paged tiers gate
            on pages AND a slot (memory actually reserved), mirroring
            ``Tier.admission_budget``."""
            nonlocal failures, spilled
            tier = tiers[j]
            cap = tier.queue_cap
            if tier_up[j] and tier.can_serve(size):
                start_service(j, ready, arr, size)
            elif tier_up[j] and (cap is None or len(tier.queue) < cap):
                tier.queue.append((arr, size))
            elif topo.waterfall and j < last and link_state[j].up:
                spilled += 1
                if j + 1 < n_bounds:
                    arrivals_in_interval[j + 1] += 1
                admit(j + 1, cross_link(j, ready), arr, size)
            else:
                # queue-proxy overflow: immediate 503
                failures += 1
                if j < last:
                    self.tier_metrics[j].record_latency(
                        prof.name, cfg.reject_latency_s)

        while events:
            t, _, kind, payload = heapq.heappop(events)
            if t > duration:
                break

            if kind == _ARRIVAL:
                submitted += 1
                j = self._choose_tier(self.rng.uniform(), R_cur)
                arr_bytes = (float(self.trace.payload_bytes[payload[0]])
                             if payload else None)
                size = None
                if payload:
                    i = payload[0]
                    size = (max(int(self.trace.prompt_len[i]), 1),
                            max(int(self.trace.max_new[i]), 1))
                jt = route_target(j)
                if jt is None:
                    # every serviceable tier is unreachable: fast 503,
                    # visible to Eq (1) like any queue-proxy reject
                    failures += 1
                    self.tier_metrics[0].record_latency(
                        prof.name, cfg.reject_latency_s)
                else:
                    j = jt
                    for b in range(min(j + 1, n_bounds)):
                        arrivals_in_interval[b] += 1
                    ready = t
                    for l in range(j):
                        ready = cross_link(l, ready, arr_bytes)
                    admit(j, ready, t, size)
                if payload:            # materialized trace: chain next row
                    i = payload[0]
                    if i + 1 < len(self.trace):
                        push(float(self.trace.t[i + 1]), _ARRIVAL, (i + 1,))
                else:
                    push(t + self.rng.exponential(1.0 / self._rate(t)),
                         _ARRIVAL)

            elif kind == _DONE:
                j, arr, tok = payload
                if tok not in svc_live:
                    continue       # stale: the request migrated mid-service
                rec = svc_live.pop(tok)
                tier = tiers[j]
                if j == 0:
                    note_busy(t)
                tier.busy -= 1
                tier.pages_used -= rec[3]
                lat = t - arr
                # Prometheus sees every completed request's latency,
                # successful or not; only the success *counter* is gated.
                if j < last:
                    self.tier_metrics[j].record_latency(prof.name, lat)
                if lat <= cfg.timeout_s:
                    successes += 1
                    tier.served += 1
                    completed_lat.append(lat)
                else:
                    failures += 1
                backfill(j, t)

            elif kind == _CONTROL:
                # One shared scrape-and-update cycle (ControlLoop) per
                # boundary: tier b's latency windows + its in-flight
                # queue-age mixing + demand RPS — the same code path the
                # live continuum ticks.
                qages = []
                for b in range(self.control.num_boundaries):
                    bq = tiers[b].queue if b < len(tiers) else ()
                    qages.append([[t - qarr for qarr, _qsize in bq]])
                arrivals = [[c] for c in arrivals_in_interval]
                if self.control.eq1 == "sketch":
                    samples = [self.tier_metrics[b].drain_fresh()
                               for b in range(self.control.num_boundaries)]
                    R_all = self.control.step_stream(
                        samples, queue_ages=qages, arrivals=arrivals)
                else:
                    lats, valids = zip(*[
                        self.tier_metrics[b].latency_windows(cfg.window)
                        for b in range(self.control.num_boundaries)])
                    R_all = self.control.step_tiers(
                        list(lats), list(valids), queue_ages=qages,
                        arrivals=arrivals)
                R_cur = np.array(R_all[:N - 1, 0], np.float64)
                push(t + cfg.control_interval_s, _CONTROL)
                arrivals_in_interval = [0] * n_bounds
                # Mid-stream migration (policies with a migrate_threshold
                # only): fresh R_t may now warrant moving in-service work
                fire_migrations(t)

            elif kind == _MIGRATE:
                # A migrated request's state landed at its destination.
                dst, arr, remaining, src, size = payload
                mig_transit -= 1
                if not (link_state[dst - 1].up and tier_up[dst]):
                    # partitioned mid-transfer (or target crashed): the
                    # state never arrives — ABORT back to the source
                    if tier_up[src] and tiers[src].can_serve(size):
                        mig_aborted += 1
                        resume_service(src, t, arr, remaining, size)
                    elif tier_up[src]:
                        # source momentarily full: retry the abort
                        mig_transit += 1
                        push(t + cfg.control_interval_s, _MIGRATE, payload)
                    else:
                        # both ends gone: accounted, never silent
                        mig_aborted += 1
                        failures += 1
                elif tiers[dst].can_serve(size):
                    # remaining *work* is invariant; the time to finish it
                    # scales with the destination's service speed
                    mig_completed += 1
                    resume_service(dst, t, arr,
                                   remaining * tiers[dst].service_mean
                                   / tiers[src].service_mean, size)
                elif tier_up[src] and tiers[src].can_serve(size):
                    # destination full: ABORT — resume at the source
                    mig_aborted += 1
                    resume_service(src, t, arr, remaining, size)
                else:
                    # both ends full: the landed state waits and retries
                    # next control interval — remaining work preserved,
                    # bounded queues untouched, never silently dropped
                    # (a request stuck past the timeout still fails on
                    # completion, like any late finisher)
                    mig_transit += 1
                    push(t + cfg.control_interval_s, _MIGRATE, payload)

            elif kind == _FAULT:
                (ev,) = payload
                faults_applied += 1
                if ev.kind in ("degrade_link", "partition_link",
                               "restore_link"):
                    ls = link_state[ev.target]
                    ls.apply(ev)
                    # a net-aware boundary re-caps against the new link
                    pol = self.control.policies[
                        min(ev.target, len(self.control.policies) - 1)]
                    if isinstance(pol, AutoOffload):
                        pol.set_link_capacity(ls.effective_capacity())
                elif ev.kind == "crash_tier":
                    i = ev.target
                    tier_up[i] = False
                    if i == 0:
                        note_busy(t)
                    # every resident service and queued request is lost
                    # with the tier's state — collect, then replay each
                    # at a reachable serviceable tier (fresh service
                    # sample: the work restarts) or count it failed.
                    resident = [(tok, rec) for tok, rec in svc_live.items()
                                if rec[0] == i]
                    lost = []
                    for tok, (_, arr, _t_done, _pg, rsize) in resident:
                        del svc_live[tok]   # its queued _DONE is now stale
                        lost.append((arr, rsize))
                    tiers[i].busy = 0
                    tiers[i].pages_used = 0
                    lost += list(tiers[i].queue)
                    tiers[i].queue.clear()
                    for arr, lsize in lost:
                        alt = route_target(i)
                        if alt is None:
                            failures += 1
                            continue
                        replayed += 1
                        ready = t
                        for l in range(min(i, alt), max(i, alt)):
                            ready = cross_link(l, ready)
                        admit(alt, ready, arr, lsize)
                else:          # restore_tier: the pool comes back idle
                    tier_up[ev.target] = True

            elif kind == _METRIC:
                note_busy(t)
                ts.append(t)
                lat_s.append(float(np.mean(completed_lat))
                             if completed_lat else np.nan)
                completed_lat.clear()
                cpu_s.append(busy_integral / cfg.metric_interval_s)
                busy_integral = 0.0
                active = tiers[0].busy + len(tiers[0].queue)
                mem_s.append(cfg.mem_baseline_mb + active * prof.mem_mb)
                for l in range(len(link_bytes)):
                    net_links[l].append(
                        link_bytes[l] / cfg.metric_interval_s / 1e6)
                    link_bytes[l] = 0.0
                net_s.append(net_links[0][-1] if net_links else 0.0)
                off_s.append(float(R_cur[0]) if len(R_cur) else 0.0)
                push(t + cfg.metric_interval_s, _METRIC)

        # Drain: everything still queued, in service, or in a migration
        # transfer at the end never completed.  A transit cut off by the
        # horizon is an aborted migration (terminally, fired ==
        # completed + aborted — nothing stays "open" past the run).
        failures += sum(len(tr.queue) + tr.busy for tr in tiers)
        failures += mig_transit
        mig_aborted += mig_transit

        return SimResult(
            policy=str(self.policy), workload=prof.name,
            successes=successes, failures=failures,
            times=np.asarray(ts), latency_avg=np.asarray(lat_s),
            cpu_util=np.asarray(cpu_s), mem_mb=np.asarray(mem_s),
            net_MBps=np.asarray(net_s), offload_pct=np.asarray(off_s),
            net_links_MBps=np.asarray(net_links),
            tier_counts={tr.spec.name: tr.served for tr in tiers},
            spilled=spilled,
            migrations_fired=mig_fired,
            migrations_completed=mig_completed,
            migrations_aborted=mig_aborted,
            submitted=submitted, replayed=replayed,
            faults_applied=faults_applied)


def run_policy_sweep(workload: str,
                     policies=(0.0, 25.0, 50.0, 75.0, 100.0, "auto"),
                     cfg: SimConfig = SimConfig(),
                     topology: Optional[Topology] = None
                     ) -> Dict[str, SimResult]:
    """The paper's Table 2 row for one workload."""
    out: Dict[str, SimResult] = {}
    for p in policies:
        out[str(p)] = ContinuumSimulator(workload, p, cfg,
                                         topology=topology).run()
    return out
