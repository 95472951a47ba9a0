"""The live N-tier continuum runtime.

The port's counterpart of ``repro/serving/tiers.py``::

    EdgeCloudContinuum (over a Topology chain, ingress at tier 0)
      ├── tier 0..N-1:  Gateway (bounded backlog queue) + Endpoint pool
      │                 (slots/model) + MetricsRegistry + per-function
      │                 Autoscaler (Knative-KPA concurrency)
      ├── ReplicationController  (deepest-tier spec -> shallower tiers)
      ├── ControlLoop + Policy   (Eqs (1)-(4) / static / net-aware /
      │                           hedged, one boundary per adjacent tier
      │                           pair)
      └── Router                 (expectation-matched assignment of the
                                  queued batch over the tier distribution)

Requests enter at the ingress gateway (``submit``).  Each ``tick`` applies
the fault events due on the logical clock, runs one scrape-and-update
cycle through the :class:`ControlLoop`, routes the ingress backlog over
the tiers by the composed R_t distribution (each request crossing the
links down to its tier, charged RTT + payload on its latency clock), and
serves every tier's own gateway with a continuous-batching loop: one
shared ``decode_all`` step over every slot-resident request, finished
rows retired at once, queued requests admitted into the freed slots the
same step (packed bucketed prefill).  With ``topology.waterfall`` a
stalled tier spills its pending load down the chain.

The live controls:

* **Hedging** (``"auto+hedge"``): a queued request older than its
  function's p99 gets a twin on another tier; the first arm home wins,
  the loser's slot is evicted the same step and records no latency.
* **Mid-stream migration** (a policy with ``migrate_threshold``, e.g.
  ``"auto+migrate"``): once a boundary's R_t reaches the threshold, the
  tier cancels its most slot-hungry rows, ships their cache rows over the
  link (live cache bytes + token tail on the request's clock) and the
  destination resumes decode at the same position, no re-prefill; the
  token stream equals the unmigrated one.  A landing on a full
  destination aborts back to the source; a transfer still in flight when
  a step-capped tick ends lands on a later tick.
* **Live faults** (``faults=`` or :meth:`apply_fault`): links degrade or
  partition through a mutable :class:`LinkState`; a crashed tier loses
  its pool and replays its residents elsewhere, and comes back through
  the replication path.
* **Per-tick caps**: ``max_waves_per_tick`` caps admission rounds,
  ``max_steps_per_tick`` decode steps (long requests stay slot-resident
  across ticks).  ``scheduler="wave"`` keeps the run-to-completion wave
  drain as the before/after baseline.

A tier whose spec sets ``page_size`` serves from a paged KV pool: its
admission walks the queue head in pages (memory actually reserved, not
slots alone), and its KPA scrape meters demand in full-row equivalents
of pages.  Every tier's endpoint holds a reference to the one set of
weights deployed.  Each boundary parses the policy against its own link's
bandwidth and the ``req_bytes`` hint, so ``"auto+net"`` caps offload by
the link actually crossed (as the simulator's boundaries do).  A
``trace=`` submits each row at the top of the tick covering its arrival
time.  ``eq1="sketch"`` reads Eq (1) from decayed histograms fed the
latencies each tier recorded since the last scrape
(:meth:`~repro_torch.core.policy.ControlLoop.step_stream`).
"""

from __future__ import annotations

import dataclasses
import math
import time
import warnings
import zlib
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.autoscaler import Autoscaler
from repro_torch.core.metrics import MetricsRegistry
from repro_torch.core.offload import OffloadConfig
from repro_torch.core.policy import (AutoOffload, ControlLoop, Policy,
                                     PolicySpec)
from repro_torch.core.replication import (AutoscalingPolicy, FunctionSpec,
                                          ReplicationController)
from repro_torch.core.topology import TierSpec, Topology
from repro_torch.device import DeviceLike, resolve
from repro_torch.models.common import ModelConfig
from repro_torch.serving import sharded
from repro_torch.serving.engine import Endpoint, Request
from repro_torch.workloads.faults import (LINK_KINDS, FaultEvent,
                                          FaultSchedule, LinkState)
from repro_torch.workloads.trace import Trace

#: default latency charged to a rejected request (the queue-proxy's fast
#: 503), the ``reject_latency_s`` of :class:`EdgeCloudContinuum`
REJECT_LATENCY_S = 0.005


@dataclasses.dataclass
class TierConfig:
    """Legacy two-tier tier shape (sugar for a named TierSpec via
    ``Topology.pair``)."""
    slots: int = 4
    max_len: int = 256
    # synthetic per-request overhead (edge->cloud WAN RTT), seconds
    extra_latency_s: float = 0.0
    # default KPA bounds for functions deployed without an explicit policy
    autoscaling: Optional[AutoscalingPolicy] = None
    stable_window_s: float = 60.0
    panic_window_s: float = 6.0


@dataclasses.dataclass
class _Queued:
    """One gateway queue entry (+ hedge bookkeeping)."""
    fn: str
    req: Request
    t_submit: float
    tick_no: int = 0
    hedge: bool = False
    pair: Optional["_HedgePair"] = None


@dataclasses.dataclass
class _InFlight:
    """One slot-resident request inside a tier's continuous decode loop."""
    item: _Queued
    slot: int
    toks: List[int]               # generated tokens so far (first from prefill)
    need: int                     # total tokens to generate
    done_at: float = 0.0


@dataclasses.dataclass
class _Transit:
    """One migrated request's extracted state, in flight over a link.

    Made by :meth:`EdgeCloudContinuum._fire_migrations` (the source tier
    has already cancelled the row and freed its slot); resolved by
    :meth:`EdgeCloudContinuum._land_migrations` once the clock passes
    ``t_land``, possibly ticks later when the link is slow.  ``rows`` is
    one ``Endpoint.extract_rows`` state: a dict of cloned leaves on the
    card (dense) or a ``PagedRow`` of the filled pages (paged).
    """
    item: _Queued
    fn: str
    rows: object                   # Endpoint.extract_rows state (one row)
    pos: int                       # decode position at extraction
    toks: List[int]                # tokens generated so far
    need: int                      # total tokens to generate
    src: int                       # source tier index
    dst: int                       # destination tier index
    t_land: float                  # clock time of the landing
    nbytes: float                  # cache bytes + token tail shipped


@dataclasses.dataclass
class _HedgePair:
    """Links a primary request to its hedge twin so only the winning
    arm's latency feeds the controller.

    Under the continuous scheduler the race settles the moment one arm
    finishes: ``winner`` flips from ``None`` to ``"primary"``/``"twin"``
    and :meth:`EdgeCloudContinuum._evict_loser` cancels the slot-resident
    sibling the same step.  The wave scheduler runs both arms to
    completion and compares latencies (:meth:`note`).
    """
    fn: str
    # continuous-scheduler resolution state
    winner: Optional[str] = None            # None | "primary" | "twin"
    winner_req: Optional[Request] = None
    primary_ref: Optional[Tuple[int, _InFlight]] = None   # (tier_idx, rec)
    twin_ref: Optional[Tuple[int, _InFlight]] = None
    # wave-scheduler bookkeeping
    primary_lat: Optional[float] = None
    primary_tier: Optional["Tier"] = None
    twin_lat: Optional[float] = None
    twin_tier: Optional["Tier"] = None
    twin_req: Optional[Request] = None

    def note(self, item: _Queued, tier: "Tier", lat: float) -> None:
        if item.hedge:
            self.twin_lat, self.twin_tier = lat, tier
            self.twin_req = item.req
        else:
            self.primary_lat, self.primary_tier = lat, tier

    def set_ref(self, hedge: bool, tier_idx: int, rec: _InFlight) -> None:
        """Remember where an arm is slot-resident, so the loser can be
        evicted the step its sibling completes."""
        if hedge:
            self.twin_ref = (tier_idx, rec)
        else:
            self.primary_ref = (tier_idx, rec)


class Gateway:
    """One tier's bounded backlog queue (the Knative queue-proxy stand-in).

    ``capacity`` bounds the resting backlog (``None`` = unbounded): client
    submits and requeues past it are rejected (the live 503), while
    in-tick placement uses ``force=True``.
    """

    def __init__(self, capacity: Optional[int] = None):
        self.capacity = capacity
        self.items: Deque[_Queued] = deque()
        self.rejected = 0

    def push(self, item: _Queued, force: bool = False) -> bool:
        if (not force and self.capacity is not None
                and len(self.items) >= self.capacity):
            self.rejected += 1
            return False
        self.items.append(item)
        return True

    def pop_all(self) -> List[_Queued]:
        items = list(self.items)
        self.items.clear()
        return items

    def backlog_ages(self, now: float, tick_no: int,
                     fn_ids: Dict[str, int],
                     num_functions: int) -> List[List[float]]:
        """Per-function ages of true backlog: entries that survived a
        previous scheduler round (fresh arrivals would drag p50 to ~0)."""
        ages: List[List[float]] = [[] for _ in range(num_functions)]
        for item in self.items:
            if item.tick_no < tick_no:
                ages[fn_ids[item.fn]].append(now - item.t_submit)
        return ages

    def __len__(self) -> int:
        return len(self.items)


class Tier:
    """One serving location: endpoints by function name + metrics +
    per-function KPA autoscalers."""

    def __init__(self, name: str, cfg, device: DeviceLike = "cuda"):
        self.name = name
        self.cfg = cfg
        self.device = resolve(device)
        self.endpoints: Dict[str, Endpoint] = {}
        self.autoscalers: Dict[str, Autoscaler] = {}
        self.metrics = MetricsRegistry([])
        # continuous-batching decode loop state: fn -> slot -> _InFlight
        self.inflight: Dict[str, Dict[int, _InFlight]] = {}

    def deploy(self, fn_name: str, model_cfg: ModelConfig, params,
               autoscaling: Optional[AutoscalingPolicy] = None) -> None:
        """Stand up this tier's endpoint pool for one function (over the
        caller's params, shared, not copied); paged when the tier's spec
        sets ``page_size``.

        A cost-modeled spec must arrive resolved (``Topology.costed`` or
        ``resolve_costs``): its ``slots`` are then the HBM-clamped count
        that also set the simulator's service rate.  ``spec.model`` names
        the architecture that priced the tier; ``model_cfg`` is what the
        pool serves.  A ``mesh_shape`` of more than one device deploys the
        pool tensor-parallel (:mod:`repro_torch.serving.sharded`) over the
        host's devices of this tier's kind (the cards; the CPU once), and
        unsharded with the reference's warning when the host has too few
        (``repro/serving/sharded.py:64-78``)."""
        if getattr(self.cfg, "model", None) is not None and \
                not getattr(self.cfg, "resolved", True):
            raise ValueError(
                f"tier {self.name!r} declares a cost model "
                f"({self.cfg.model}) but is unresolved; build the chain "
                f"via Topology.costed(...) or call .resolve_costs() "
                f"before deploying")
        mesh = None
        mesh_shape = getattr(self.cfg, "mesh_shape", None)
        if mesh_shape is not None and (
                int(mesh_shape[0]) * int(mesh_shape[1])) > 1:
            mesh = sharded.tier_mesh(mesh_shape, self.device)
        page_size = getattr(self.cfg, "page_size", None)
        self.endpoints[fn_name] = Endpoint(
            model_cfg, params, slots=self.cfg.slots,
            max_len=self.cfg.max_len, device=self.device,
            paged=page_size is not None,
            page_size=page_size if page_size is not None else 16,
            total_pages=getattr(self.cfg, "pool_pages", None), mesh=mesh)
        self.inflight.setdefault(fn_name, {})
        self.metrics.register(fn_name)
        # A TierSpec that declares its own KPA bounds governs its pool;
        # legacy TierConfig bounds apply only when the function has none.
        if isinstance(self.cfg, TierSpec) and self.cfg.autoscaling is not None:
            policy = self.cfg.autoscaling
        else:
            policy = autoscaling or self.cfg.autoscaling or AutoscalingPolicy()
        self.autoscalers[fn_name] = Autoscaler(
            policy,
            stable_window_s=self.cfg.stable_window_s,
            panic_window_s=self.cfg.panic_window_s)

    # -- capacity ----------------------------------------------------------
    def free_slots(self, fn_name: str) -> int:
        ep = self.endpoints[fn_name]
        return ep.slots - ep.active

    def capacity(self, fn_name: str) -> int:
        """Admitted concurrency right now: ceil(replicas x target
        concurrency), bounded by the KV-cache pool; 0 when scaled to zero."""
        asc = self.autoscalers[fn_name]
        want = math.ceil(asc.replicas * asc.policy.target_concurrency)
        return min(self.endpoints[fn_name].slots, want)

    def replicas(self, fn_name: str) -> int:
        return self.autoscalers[fn_name].replicas

    def inflight_count(self, fn_name: str) -> int:
        return len(self.inflight.get(fn_name, ()))

    def admission_budget(self, fn_name: str, items: List[_Queued],
                         cap: Optional[int] = None) -> int:
        """How many of ``items`` (in order) this tier can admit right now:
        free slots bounded by ``cap`` (the caller's KPA-admitted
        concurrency).  A paged pool also walks the queue head charging each
        request the pages it must be able to reserve (sharing-blind, so
        never an overclaim)."""
        ep = self.endpoints[fn_name]
        budget = self.free_slots(fn_name)
        if cap is not None:
            budget = min(budget, cap)
        budget = max(0, min(budget, len(items)))
        if not ep.paged or budget == 0:
            return budget
        free = ep.admissible_pages
        n = 0
        for item in items[:budget]:
            need = ep.page_need(len(item.req.tokens),
                                max(item.req.max_new, 1))
            if need > free:
                break
            free -= need
            n += 1
        return n

    # -- continuous-batching decode loop ------------------------------------
    def admit(self, fn_name: str, items: List[_Queued]
              ) -> Tuple[List[_InFlight], List[_InFlight]]:
        """Claim slots for ``items`` and run one packed bucketed prefill.

        Returns ``(in_flight, finished)``: requests needing only their
        prefill token retire at once; the rest join the tier's in-flight
        set.  Over-admission raises; a failed prefill releases every
        claimed slot and re-raises.
        """
        ep = self.endpoints[fn_name]
        claimed: List[Tuple[_Queued, int]] = []
        for item in items:
            slot = ep.try_claim(tokens=item.req.tokens,
                                max_new=max(item.req.max_new, 1))
            if slot is None:
                for _, s in claimed:
                    ep.release(s)
                raise RuntimeError(
                    f"{self.name}/{fn_name}: admission of {len(items)} "
                    f"exceeds free slots — scheduler admitted past capacity")
            claimed.append((item, slot))
        try:
            firsts = ep.prefill_batch(
                {slot: item.req.tokens for item, slot in claimed})
        # lint: ignore[swallowed-exception] -- cleanup-and-reraise: slots
        # must be released on ANY prefill failure or they leak forever
        except Exception:
            for _, s in claimed:
                ep.release(s)
            raise
        now = time.perf_counter()
        in_flight: List[_InFlight] = []
        finished: List[_InFlight] = []
        for item, slot in claimed:
            item.req.t_first = now
            rec = _InFlight(item, slot, [firsts[slot]],
                            max(item.req.max_new, 1))
            if rec.need == 1:
                rec.done_at = now
                ep.release(slot)
                finished.append(rec)
            else:
                self.inflight[fn_name][slot] = rec
                in_flight.append(rec)
        return in_flight, finished

    def step(self, fn_name: str) -> List[_InFlight]:
        """One shared ``decode_all`` step over every in-flight slot of
        ``fn_name``; finished rows are released and returned."""
        fl = self.inflight.get(fn_name)
        if not fl:
            return []
        ep = self.endpoints[fn_name]
        nxt = ep.decode_all({slot: rec.toks[-1] for slot, rec in fl.items()})
        now = time.perf_counter()
        finished: List[_InFlight] = []
        for slot, tok in nxt.items():
            rec = fl[slot]
            rec.toks.append(tok)
            if len(rec.toks) >= rec.need:
                rec.done_at = now
                ep.release(slot)
                del fl[slot]
                finished.append(rec)
        return finished

    def cancel(self, fn_name: str, slot: int) -> _InFlight:
        """Evict one in-flight request mid-decode (a hedge loser, a
        migration victim): the slot frees at once and no latency sample
        is recorded."""
        rec = self.inflight[fn_name].pop(slot)
        self.endpoints[fn_name].release(slot)
        return rec

    def finish(self, fn_name: str, rec: _InFlight) -> float:
        """Fill the request's output from a retired record and return its
        end-to-end latency (recording it is the caller's call: hedge
        losers never record)."""
        req = rec.item.req
        req.output = np.asarray(rec.toks, np.int32)
        req.t_done = rec.done_at
        req.latency_s = (rec.done_at - rec.item.t_submit
                         + self.cfg.extra_latency_s)
        return req.latency_s

    # -- serving -----------------------------------------------------------
    def serve_batch(self, fn_name: str,
                    items: List[Tuple[Request, float]],
                    record: Optional[List[bool]] = None
                    ) -> List[Tuple[np.ndarray, float]]:
        """Serve a wave of ``(request, t_submit)`` together on one
        endpoint, run to completion: one packed prefill and one shared
        ``decode_all`` stream; each latency runs from the submit stamp to
        the step that finished the request.  ``record`` masks which
        latencies feed this tier's metrics (hedged arms defer to the
        pair's winner).  Admission past the pool raises; any failure
        mid-stream releases every claimed slot and re-raises."""
        ep = self.endpoints[fn_name]
        claimed: List[Tuple[Request, float, int]] = []
        for req, t_submit in items:
            slot = ep.try_claim(tokens=req.tokens,
                                max_new=max(req.max_new, 1))
            if slot is None:
                for _, _, s in claimed:
                    ep.release(s)
                raise RuntimeError(
                    f"{self.name}/{fn_name}: wave of {len(items)} exceeds "
                    f"free slots/pages — scheduler admitted past capacity")
            claimed.append((req, t_submit, slot))
        try:
            firsts = ep.prefill_batch(
                {slot: req.tokens for req, _, slot in claimed})
            now = time.perf_counter()
            outs: Dict[int, List[int]] = {}
            need: Dict[int, int] = {}
            done_at: Dict[int, float] = {}
            active: Dict[int, int] = {}
            for req, _, slot in claimed:
                outs[slot] = [firsts[slot]]
                need[slot] = max(req.max_new, 1)
                done_at[slot] = now
                req.t_first = now
                if need[slot] > 1:
                    active[slot] = firsts[slot]
            while active:
                nxt = ep.decode_all(active)
                now = time.perf_counter()
                for s, tok in nxt.items():
                    outs[s].append(tok)
                    if len(outs[s]) >= need[s]:
                        del active[s]
                        done_at[s] = now
                    else:
                        active[s] = tok
        # lint: ignore[swallowed-exception] -- cleanup-and-reraise: decode
        # slots must be released on ANY mid-stream failure or they leak
        except Exception:
            for _, _, s in claimed:
                ep.release(s)
            raise
        results: List[Tuple[np.ndarray, float]] = []
        for i, (req, t_submit, slot) in enumerate(claimed):
            lat = done_at[slot] - t_submit + self.cfg.extra_latency_s
            if record is None or record[i]:
                self.metrics.record_latency(fn_name, lat)
            req.output = np.asarray(outs[slot], np.int32)
            req.t_done = done_at[slot]
            req.latency_s = lat
            ep.release(slot)
            results.append((req.output, lat))
        return results

    def serve_one(self, fn_name: str, req: Request
                  ) -> Tuple[np.ndarray, float]:
        """The serial single-request path (the pre-batching baseline)."""
        [(out, lat)] = self.serve_batch(fn_name, [(req, time.perf_counter())])
        return out, lat


class EdgeCloudContinuum:
    """The platform: replication + policy-driven offloading across an
    N-tier topology, with per-tier gateways and a continuous-batching
    scheduler (``scheduler="wave"`` keeps the run-to-completion wave
    drain).

    ``device`` (default ``"cuda"``) is where every tier's endpoints run;
    ``seed`` seeds the routing generator and, apart, the trace's prompt
    tokens.  ``req_bytes`` is the average payload a net-aware boundary
    divides its link by; ``trace`` drives arrivals
    (``trace_prompts="per_fn"`` gives each function one prompt per
    length); ``faults`` is a fault schedule applied against the logical
    clock.  ``reject_latency_s`` is the latency a 503 records.
    ``max_waves_per_tick`` caps the admission rounds and
    ``max_steps_per_tick`` the decode steps of one tick (None: no cap).
    ``eq1`` picks the controller's Eq-(1) front end, ``"window"`` (exact
    percentiles of the latency windows) or ``"sketch"`` (histograms of
    ``sketch``, a :class:`~repro_torch.core.quantile.SketchSpec`, fed the
    fresh samples of each scrape)."""

    def __init__(self, edge=None, cloud=None,
                 policy: PolicySpec = "auto",
                 offload_cfg: Optional[OffloadConfig] = None,
                 window: int = 64, seed: int = 0,
                 control_interval_s: float = 1.0,
                 max_waves_per_tick: Optional[int] = None,
                 topology: Optional[Topology] = None,
                 reject_latency_s: float = REJECT_LATENCY_S,
                 scheduler: str = "continuous",
                 max_steps_per_tick: Optional[int] = None,
                 device: DeviceLike = "cuda",
                 req_bytes: Optional[float] = None,
                 trace: Optional[Trace] = None,
                 faults: Optional[FaultSchedule] = None,
                 trace_vocab: int = 128,
                 trace_prompts: str = "random",
                 eq1: str = "window",
                 sketch=None):
        if trace_prompts not in ("random", "per_fn"):
            raise ValueError(
                f"trace_prompts must be 'random' or 'per_fn', "
                f"got {trace_prompts!r}")
        if scheduler not in ("continuous", "wave"):
            raise ValueError(
                f"scheduler must be 'continuous' or 'wave', got {scheduler!r}")
        if eq1 not in ("window", "sketch"):
            raise ValueError(f'eq1 must be "window" or "sketch", got {eq1!r}')
        self.device = resolve(device)
        if topology is None:
            if edge is None or cloud is None:
                raise ValueError(
                    "pass either topology=... or the 2-tier edge=/cloud= pair")
            topology = Topology.pair(edge, cloud)
        self.topology = topology
        self.tiers: List[Tier] = [Tier(spec.name, spec, self.device)
                                  for spec in topology.tiers]
        self.gateways: List[Gateway] = [
            Gateway(None if spec.queue_depth_per_slot is None
                    else spec.slots * spec.queue_depth_per_slot)
            for spec in topology.tiers]
        self.offload_cfg = offload_cfg or OffloadConfig()
        self._policy_spec: PolicySpec = policy
        self.req_bytes = req_bytes
        self.policy = Policy.parse(policy, offload_cfg=self.offload_cfg,
                                   req_bytes=req_bytes)
        if scheduler == "wave" and self.policy.migrate_threshold is not None:
            # the wave scheduler runs every admitted request to
            # completion: there is no slot-resident state to migrate
            warnings.warn(
                "mid-stream migration (migrate_threshold="
                f"{self.policy.migrate_threshold}) requires the "
                "continuous scheduler; scheduler='wave' will never "
                "migrate", stacklevel=2)
        self.window = window
        self.control_interval_s = control_interval_s
        self.eq1 = eq1
        self.sketch = sketch
        # fast rejections are part of the latency distribution Eq (1)
        # scrapes (queue-proxy 503 semantics, as in the simulator)
        self.reject_latency_s = reject_latency_s
        # one reconciler per shallower tier, so a crashed tier's view can
        # be wiped and rebuilt without touching its siblings
        self.replicators: List[ReplicationController] = [
            ReplicationController()
            for _ in range(max(len(self.tiers) - 1, 1))]
        self.cloud_specs: Dict[str, FunctionSpec] = {}
        # what each function was deployed with: a restored tier redeploys
        # from here through a fresh reconciler
        self._artifacts: Dict[str, Tuple[ModelConfig, object]] = {}
        self.fn_names: List[str] = []
        self._fn_ids: Dict[str, int] = {}
        self.control: Optional[ControlLoop] = None
        self.rng = np.random.default_rng(seed)
        # demand per boundary since the last scrape: boundary b counts the
        # requests that reached tier b, one (F,) vector per boundary
        self._num_boundaries = max(len(self.tiers) - 1, 1)
        self._crossings: List[np.ndarray] = [
            np.zeros(0, np.int64) for _ in range(self._num_boundaries)]
        # platform-level counters (hedging, migration, faults)
        self.metrics = MetricsRegistry([])
        # mid-stream migrations in flight over a link, and the cumulative
        # per-link egress bytes of every crossing (routing, spill, hedge
        # twins, migrated cache state)
        self.migrations: List[_Transit] = []
        self.link_bytes: List[float] = [0.0] * len(topology.links)
        self._link_bytes_seen: List[float] = [0.0] * len(topology.links)
        self.max_waves_per_tick = max_waves_per_tick
        self.scheduler = scheduler
        self.max_steps_per_tick = max_steps_per_tick
        self.log: List[Dict] = []
        self._clock = 0.0          # logical control-plane time (scrapes)
        self._tick_no = 0
        self._rejected_seen = 0
        # fault overlay: links are crossed through their mutable LinkState
        # (identity multipliers while healthy); a crashed tier forwards
        # traffic but cannot serve
        self.link_state: List[LinkState] = [LinkState(l)
                                            for l in topology.links]
        self.tier_up: List[bool] = [True] * len(self.tiers)
        self.faults = faults
        if faults is not None:
            faults.validate(len(self.tiers))
            faults.reset()
        # trace-driven arrivals: rows enter at the top of the tick covering
        # their arrival time, prompt tokens from a generator of their own
        self.trace = trace
        self.trace_vocab = trace_vocab
        self.trace_prompts = trace_prompts
        self.trace_requests: List[Request] = []
        self._trace_pos = 0
        self._trace_rng = np.random.default_rng(seed)

    # ingress / deepest tier aliases (the historical two-tier attributes)
    @property
    def edge(self) -> Tier:
        return self.tiers[0]

    @property
    def cloud(self) -> Tier:
        return self.tiers[-1]

    @property
    def queued(self) -> int:
        """Total backlog across every tier's gateway."""
        return sum(len(g) for g in self.gateways)

    @property
    def in_flight(self) -> int:
        """Slot-resident requests across every tier, plus migrated state
        still in flight over a link (nonzero between ticks only under
        ``max_steps_per_tick`` or while a cross-tick migration lands)."""
        return (sum(t.inflight_count(fn)
                    for t in self.tiers for fn in t.endpoints)
                + len(self.migrations))

    @property
    def migrations_open(self) -> int:
        """Mid-stream migrations fired but not yet landed or aborted."""
        return len(self.migrations)

    @property
    def hedges_open(self) -> int:
        """Hedge pairs still racing (fired, neither won nor cancelled)."""
        c = self.metrics.counter
        return int(c("hedges_fired") - c("hedges_won")
                   - c("hedges_cancelled"))

    # -- deployment (paper §3.3.1) ------------------------------------------
    def deploy(self, spec: FunctionSpec, model_cfg: ModelConfig,
               params) -> None:
        """Deploy to the deepest tier; replication mirrors the spec to
        every shallower tier of the chain (same params object)."""
        self.cloud.deploy(spec.name, model_cfg, params, spec.autoscaling)
        self.cloud_specs[spec.name] = spec
        self._artifacts[spec.name] = (model_cfg, params)
        for i, tier in enumerate(self.tiers[:-1]):
            changed = self.replicators[i].reconcile(self.cloud_specs)
            if changed.get(spec.name, True):
                tier.deploy(spec.name, model_cfg, params, spec.autoscaling)
        if spec.name not in self.fn_names:
            self._fn_ids[spec.name] = len(self.fn_names)
            self.fn_names.append(spec.name)
            self._crossings = [np.concatenate([c, np.zeros(1, np.int64)])
                               for c in self._crossings]
            # each boundary parses the policy against ITS link, so
            # auto+net caps by the link actually crossed (as the simulator)
            links = self.topology.links
            self.control = ControlLoop(
                self.policy, len(self.fn_names), window=self.window,
                control_interval_s=self.control_interval_s,
                num_tiers=len(self.tiers),
                boundary_policies=[
                    Policy.parse(self._policy_spec,
                                 offload_cfg=self.offload_cfg,
                                 link_bytes_per_s=(
                                     links[min(b, len(links) - 1)]
                                     .bandwidth_Bps if links else None),
                                 req_bytes=self.req_bytes)
                    for b in range(self._num_boundaries)],
                eq1=self.eq1, sketch=self.sketch)

    # -- request path (paper §3.3.2) ------------------------------------------
    def submit(self, fn_name: str, req: Request) -> bool:
        """Queue a request at the ingress gateway.  Returns False when the
        bounded backlog is full (the live 503)."""
        req.arrival_s = time.perf_counter()
        item = _Queued(fn_name, req, req.arrival_s, tick_no=self._tick_no)
        self._count_crossing(0, fn_name)
        if not self.gateways[0].push(item):
            req.failed = True
            self._reject(0, fn_name)
            return False
        return True

    def _count_crossing(self, b: int, fn: str) -> None:
        if b < self._num_boundaries:
            i = self._fn_ids.get(fn)
            if i is not None:
                self._crossings[b][i] += 1

    def _reject(self, ti: int, fn: str) -> None:
        """A 503: counted, and (below the deepest tier) recorded as a fast
        latency sample, since Eq (1) reads rejections too."""
        self.metrics.inc("rejected")
        if ti < len(self.tiers) - 1 or len(self.tiers) == 1:
            self.tiers[ti].metrics.record_latency(fn, self.reject_latency_s)

    def _cross_link(self, item: _Queued, l: int) -> None:
        """Move one queued request over link l (tier l -> tier l+1):
        charge RTT + payload serialization, as the link's fault state
        has it, to its latency clock (by backdating its submit stamp)
        and count the boundary crossing (not for a hedge twin, which is
        duplicate work, not demand)."""
        if l < len(self.topology.links):
            item.t_submit -= self.link_state[l].latency_s(
                item.req.tokens.nbytes)
            self.link_bytes[l] += item.req.tokens.nbytes
        if not item.hedge:
            self._count_crossing(l + 1, item.fn)

    # -- fault injection ------------------------------------------------------
    def _route_target(self, j: int) -> Optional[int]:
        """Resolve an assigned tier against the fault state: crashed tiers
        forward but cannot serve, a partitioned link cuts off everything
        past it.  The shallowest serviceable tier at or past ``j``, else
        the deepest one before it; None when nothing can serve (the
        request 503s)."""
        if self.faults is None and all(self.tier_up):
            return j
        reach = 0
        for l in range(len(self.tiers) - 1):
            if not self.link_state[l].up:
                break
            reach = l + 1
        up = [i for i in range(reach + 1) if self.tier_up[i]]
        if not up:
            return None
        for i in up:
            if i >= j:
                return i
        return up[-1]

    def apply_fault(self, ev: FaultEvent) -> None:
        """Apply one fault event now (the ``faults=`` schedule calls it at
        the top of each tick; tests drive the live runtime and the
        simulator through the same events with it)."""
        self.metrics.inc("faults_applied")
        if ev.kind in LINK_KINDS:
            ls = self.link_state[ev.target]
            ls.apply(ev)
            # a net-aware boundary re-caps against the changed link
            if self.control is not None:
                pol = self.control.policies[
                    min(ev.target, len(self.control.policies) - 1)]
                if isinstance(pol, AutoOffload):
                    pol.set_link_capacity(ls.effective_capacity())
        elif ev.kind == "crash_tier":
            self._crash_tier(ev.target)
        else:
            self._restore_tier(ev.target)

    def _replay(self, item: _Queued, away_from: int) -> None:
        """Re-route one request lost to a crash or partition: into a
        reachable serviceable gateway (its submit stamp kept: the lost
        work stays on its latency clock), or failed when nothing can
        serve.  Nothing is dropped silently."""
        self.metrics.inc("replayed")
        tgt = self._route_target(away_from)
        if tgt is None or not self.gateways[tgt].push(item, force=True):
            item.req.failed = True
            self._reject(0, item.fn)

    def _crash_tier(self, i: int) -> None:
        """Tier ``i`` goes down: slots, in-flight rows, backlog and the
        tier's replicated specs are lost.  Every resident primary replays
        at a reachable tier; hedge arms resolve so the conservation and
        hedge identities hold (a lost twin concedes to its primary, a
        primary whose twin already won adopts the twin's result)."""
        tier = self.tiers[i]
        self.tier_up[i] = False
        lost: List[_Queued] = self.gateways[i].pop_all()
        for fl in tier.inflight.values():
            for rec in fl.values():
                item = rec.item
                pair = item.pair
                if item.hedge:
                    if pair.winner is None:
                        pair.winner = "primary"
                        self.metrics.inc("hedges_cancelled")
                    continue
                if pair is not None and pair.winner == "twin":
                    self._adopt(item, pair)
                    continue
                lost.append(item)
        # the pool is gone (its cache memory with it); restore rebuilds
        # endpoints, autoscalers and the edge view through the reconciler
        tier.endpoints = {}
        tier.autoscalers = {}
        tier.inflight = {}
        if i < len(self.tiers) - 1:
            self.replicators[i] = ReplicationController()
        for item in lost:
            self._replay(item, i)

    def _restore_tier(self, i: int) -> None:
        """Tier ``i`` comes back empty.  A shallower tier re-registers its
        functions through the replication path (fresh reconciler, every
        spec reports changed, redeploy from the stored artifacts) with
        fresh autoscalers at ``min_scale``; the deepest tier redeploys
        directly (it is the spec source).  A restore of a tier that is
        up changes nothing, as in the simulator: redeploying would drop
        its resident rows (the reference does, and loses them)."""
        if self.tier_up[i]:
            return
        self.tier_up[i] = True
        if i < len(self.tiers) - 1:
            changed = self.replicators[i].reconcile(self.cloud_specs)
        else:
            changed = {name: True for name in self.cloud_specs}
        for name, spec in self.cloud_specs.items():
            if changed.get(name, True):
                model_cfg, params = self._artifacts[name]
                self.tiers[i].deploy(name, model_cfg, params,
                                     spec.autoscaling)

    # -- trace-driven arrivals ------------------------------------------------
    def _ingest_trace(self) -> int:
        """Submit every trace row arriving within the interval this tick
        covers.  Rows name functions by the trace's ``fn_names``; a name
        not deployed here falls back to deployment order by index."""
        if self.trace is None:
            return 0
        horizon = self._clock + self.control_interval_s
        n = 0
        while (self._trace_pos < len(self.trace)
               and float(self.trace.t[self._trace_pos]) < horizon):
            i = self._trace_pos
            self._trace_pos += 1
            name = self.trace.fn_names[int(self.trace.fn[i])]
            if name not in self._fn_ids:
                if not self.fn_names:
                    raise RuntimeError(
                        "trace ingestion before any function is deployed")
                name = self.fn_names[int(self.trace.fn[i])
                                     % len(self.fn_names)]
            L = max(int(self.trace.prompt_len[i]), 1)
            if self.trace_prompts == "per_fn":
                fn_rng = np.random.default_rng(
                    zlib.crc32(f"{name}:{L}".encode()))
                tokens = fn_rng.integers(0, self.trace_vocab,
                                         L).astype(np.int32)
            else:
                tokens = self._trace_rng.integers(
                    0, self.trace_vocab, L).astype(np.int32)
            req = Request(rid=len(self.trace_requests), tokens=tokens,
                          max_new=max(int(self.trace.max_new[i]), 1))
            self.trace_requests.append(req)
            self.submit(name, req)
            n += 1
        return n

    def controller_update(self) -> np.ndarray:
        """One scrape-and-update cycle: boundary b sees tier b's latency
        windows (or, under ``eq1="sketch"``, the samples tier b recorded
        since the last scrape), its gateway's backlog ages and the demand
        that crossed into tier b; returns the ingress boundary's R_t
        percentages."""
        now = time.perf_counter()
        qages = []
        tier_of = [min(b, len(self.tiers) - 1)     # 1-tier chain: b=0
                   for b in range(self.control.num_boundaries)]
        for i in tier_of:
            qages.append(self.gateways[i].backlog_ages(
                now, self._tick_no, self._fn_ids, len(self.fn_names)))
        arrivals = list(self._crossings)
        if self.control.eq1 == "sketch":
            samples = [self.tiers[i].metrics.drain_fresh() for i in tier_of]
            R_all = self.control.step_stream(samples, queue_ages=qages,
                                             arrivals=arrivals)
        else:
            lats, valids = zip(*[self.tiers[i].metrics.latency_windows(
                self.window) for i in tier_of])
            R_all = self.control.step_tiers(list(lats), list(valids),
                                            queue_ages=qages,
                                            arrivals=arrivals)
        self._crossings = [np.zeros_like(c) for c in self._crossings]
        return R_all[0]

    # -- scheduler ------------------------------------------------------------
    def tick(self) -> Dict:
        """One scheduler round: due fault events, trace arrivals, the
        controller update, mid-stream migrations, tier assignment of the
        ingress backlog (with hedge twins), then the serving loop over
        every tier (continuous, or the wave drain).  Returns (and logs)
        the round's record."""
        if self.faults is not None:
            for ev in self.faults.due(self._clock):
                self.apply_fault(ev)
        self._ingest_trace()
        R = self.controller_update()
        self._clock += self.control_interval_s
        self._tick_no += 1
        # boundaries whose R_t reached their migrate threshold ship
        # slot-resident rows down-chain now: the freed slots are
        # admissible this tick, the state lands when its transfer ends
        mig_fired = self._fire_migrations()
        last = len(self.tiers) - 1
        hedged = 0
        pairs: List[_HedgePair] = []
        twins: List[Tuple[int, _Queued]] = []

        # Route the ingress gateway's queue over the tiers; each request
        # crosses the links down to its tier's gateway.  Deeper gateways'
        # backlogs belong to their tier and are not re-routed.
        items = self.gateways[0].pop_all()
        if items:
            fn_ids = np.asarray([self._fn_ids[it.fn] for it in items],
                                np.int32)
            tier_idx = self.control.route_tiers(self.rng, fn_ids)
            now = time.perf_counter()
            ages = np.asarray([now - it.t_submit for it in items], np.float32)
            lat, valid = self.edge.metrics.latency_windows(self.window)
            hedge = self.control.hedge(ages, fn_ids, lat, valid)
            for it, tj, hedge_it in zip(items, tier_idx, hedge):
                j = self._route_target(int(tj))
                if j is None:
                    # no serviceable tier is reachable: the live 503
                    it.req.failed = True
                    self._reject(0, it.fn)
                    continue
                if bool(hedge_it) and it.pair is None:
                    # a backup on another tier; an already-paired leftover
                    # is never hedged again.  The twin is stamped before
                    # the primary crosses a link, and pays its own links
                    # (no crossing counts: duplicate work, not demand),
                    # else the win comparison favours a free-riding twin
                    bj = self._route_target(0 if j == last else last)
                    if bj is not None:
                        twin = Request(rid=it.req.rid, tokens=it.req.tokens,
                                       max_new=it.req.max_new,
                                       arrival_s=it.req.arrival_s)
                        pair = _HedgePair(fn=it.fn)
                        it.pair = pair
                        twin_item = _Queued(it.fn, twin, it.t_submit,
                                            tick_no=self._tick_no,
                                            hedge=True, pair=pair)
                        for l in range(bj):
                            self._cross_link(twin_item, l)
                        twins.append((bj, twin_item))
                        pairs.append(pair)
                        hedged += 1
                for l in range(j):
                    self._cross_link(it, l)
                self.gateways[j].push(it, force=True)
        if hedged:
            self.metrics.inc("hedges_fired", hedged)

        # this tick's work: every tier's gateway contents + hedge twins
        pending: Dict[Tuple[int, str], List[_Queued]] = {}
        for ti, gw in enumerate(self.gateways):
            for it in gw.pop_all():
                pending.setdefault((ti, it.fn), []).append(it)
        for bj, it in twins:
            pending.setdefault((bj, it.fn), []).append(it)

        # KPA scrape: every (tier, fn) observes its assigned concurrency,
        # queued plus slot-resident plus migrated state headed there (the
        # destination must not scale to zero under it), zeros included
        # (that ages idle functions to zero).  A paged pool meters demand
        # in pages, normalized to full-row equivalents.
        for ti, tier in enumerate(self.tiers):
            for fn, asc in tier.autoscalers.items():
                ep = tier.endpoints.get(fn)
                inbound = [tr for tr in self.migrations
                           if tr.dst == ti and tr.fn == fn]
                if ep is not None and ep.paged:
                    pages = sum(ep.page_need(len(it.req.tokens),
                                             max(it.req.max_new, 1))
                                for it in pending.get((ti, fn), []))
                    pages += ep.resident_page_demand()
                    pages += sum(
                        ep.pages_for(max(tr.pos + tr.need - len(tr.toks), 1))
                        for tr in inbound)
                    conc = pages / ep.pages_per_row
                else:
                    conc = (len(pending.get((ti, fn), []))
                            + tier.inflight_count(fn) + len(inbound))
                asc.observe(self._clock, float(conc))
                asc.desired(self._clock)

        if self.scheduler == "wave":
            body = self._run_waves(pending, pairs)
        else:
            body = self._run_continuous(pending)

        rejected_total = sum(g.rejected for g in self.gateways)
        rejected_tick = rejected_total - self._rejected_seen
        self._rejected_seen = rejected_total
        served = body.pop("served")
        link_MB = [(b - s) / 1e6 for b, s in
                   zip(self.link_bytes, self._link_bytes_seen)]
        self._link_bytes_seen = list(self.link_bytes)
        rec = {"R": float(R.mean()) if len(R) else 0.0,
               "edge": served[self.tiers[0].name],
               "cloud": served[self.tiers[-1].name],
               "tiers": dict(served),
               "hedged": hedged,
               "migrations_fired": mig_fired,
               **body,
               "link_MB": link_MB,
               "backlog": {t.name: len(g)
                           for t, g in zip(self.tiers, self.gateways)},
               "rejected": rejected_tick,
               "replicas": {t.name: {fn: t.replicas(fn)
                                     for fn in t.autoscalers}
                            for t in self.tiers}}
        self.log.append(rec)
        return rec

    # -- hedge resolution -----------------------------------------------------
    def _adopt(self, item: _Queued, pair: _HedgePair) -> None:
        """A losing or stranded primary's client still gets the winning
        twin's result (served once, by the twin)."""
        item.req.output = pair.winner_req.output
        item.req.t_first = pair.winner_req.t_first
        item.req.t_done = pair.winner_req.t_done
        item.req.latency_s = pair.winner_req.latency_s

    def _evict_loser(self, pair: _HedgePair) -> None:
        """Cancel the losing arm of a just-resolved pair if it is still
        slot-resident: the slot frees this very step, the evicted arm
        records no latency, and a cancelled primary adopts the winner's
        output."""
        ref = pair.primary_ref if pair.winner == "twin" else pair.twin_ref
        if ref is None:
            return
        ti, rec = ref
        tier = self.tiers[ti]
        if tier.inflight.get(pair.fn, {}).get(rec.slot) is rec:
            tier.cancel(pair.fn, rec.slot)
            if pair.winner == "twin":
                self._adopt(rec.item, pair)

    def _settle_resolved(self, item: _Queued) -> bool:
        """A queued item whose hedge pair already resolved never runs: a
        losing twin is dropped, a primary whose twin won adopts the twin's
        result.  Returns True when the item leaves the queue."""
        pair = item.pair
        if pair is None or pair.winner is None:
            return False
        if item.hedge:
            return True
        if pair.winner == "twin":
            self._adopt(item, pair)
            return True
        item.pair = None           # twin lost or abandoned: runs normally
        return False

    # -- mid-stream migration (continuous scheduler only) ----------------------
    def _fire_migrations(self) -> int:
        """Launch mid-stream migrations for every boundary whose policy
        carries a ``migrate_threshold`` that its current R_t reaches.

        Tier b picks ``ceil(eligible * R_t / 100)`` victims among its
        slot-resident rows, longest remaining decode first, cancels them
        (their slots free now), extracts their cache rows and ships them
        over link b: ``nbytes`` is the live cache bytes at the row's
        position plus its token tail (4 B a prompt or generated token),
        counted toward the link's egress, and the transfer occupies the
        request's clock until it lands.  Rows move only between
        compatible pools, never into a partition or a crashed tier.
        Hedge twins and rows of resolved pairs never migrate.
        """
        if self.control is None or self.scheduler != "continuous":
            return 0
        fired = 0
        now = time.perf_counter()
        for b in range(min(self._num_boundaries, len(self.tiers) - 1)):
            pol = self.control.policies[b]
            thr = pol.migrate_threshold
            if thr is None:
                continue
            if not (self.link_state[b].up and self.tier_up[b + 1]):
                continue
            tier, dst = self.tiers[b], self.tiers[b + 1]
            link = self.link_state[b]
            for fn, fl in tier.inflight.items():
                if not fl:
                    continue
                R_b = float(self.control.R_all[b][self._fn_ids[fn]])
                if R_b < thr:
                    continue
                ep = tier.endpoints[fn]
                dep = dst.endpoints.get(fn)
                if dep is None or not ep.compatible_with(dep):
                    continue
                eligible = [
                    rec for rec in fl.values()
                    if not rec.item.hedge
                    and (rec.item.pair is None
                         or rec.item.pair.winner is None)
                    and rec.need - len(rec.toks) >= pol.migrate_min_remaining]
                n = min(len(eligible), math.ceil(len(eligible) * R_b / 100.0))
                if n <= 0:
                    continue
                eligible.sort(key=lambda r: (-(r.need - len(r.toks)), r.slot))
                victims = eligible[:n]
                states = ep.extract_rows([r.slot for r in victims])
                for rec, state in zip(victims, states):
                    pos = int(ep.slot_pos[rec.slot])
                    tier.cancel(fn, rec.slot)
                    nbytes = (ep.cache_nbytes_per_row(pos)
                              + 4.0 * (len(rec.item.req.tokens)
                                       + len(rec.toks)))
                    self.link_bytes[b] += nbytes
                    self._count_crossing(b + 1, fn)
                    self.migrations.append(_Transit(
                        item=rec.item, fn=fn, rows=state, pos=pos,
                        toks=rec.toks, need=rec.need, src=b, dst=b + 1,
                        t_land=now + link.latency_s(nbytes),
                        nbytes=nbytes))
                    fired += 1
        if fired:
            self.metrics.inc("migrations_fired", fired)
        return fired

    def _readmit(self, ti: int, tr: _Transit, force: bool = False) -> bool:
        """Insert a landed row into tier ``ti``'s pool and resume its
        decode (no re-prefill).  Respects the autoscaler-admitted budget
        unless ``force`` (the migration analogue of the scale-from-zero
        floor); a paged pool must reserve pages for the row's remaining
        decode, even under force."""
        tier = self.tiers[ti]
        ep = tier.endpoints.get(tr.fn)
        if ep is None:             # tier crashed: its pool is gone
            return False
        if not force and min(
                tier.free_slots(tr.fn),
                tier.capacity(tr.fn) - tier.inflight_count(tr.fn)) <= 0:
            return False
        extent = max(tr.pos + max(tr.need - len(tr.toks), 0), 1)
        if ep.paged and ep.admissible_pages < ep.pages_for(extent):
            return False
        slot = ep.try_claim(reserve_tokens=extent if ep.paged else None)
        if slot is None:
            return False
        ep.insert_rows([tr.rows], [slot], [tr.pos])
        rec = _InFlight(tr.item, slot, tr.toks, tr.need)
        tier.inflight[tr.fn][slot] = rec
        if tr.item.pair is not None:
            tr.item.pair.set_ref(tr.item.hedge, ti, rec)
        return True

    def _abort_transit(self, tr: _Transit) -> None:
        """A transit that can never land: resume at the source, or, when
        the source too is crashed or full, replay the request from
        scratch at a reachable gateway.  Counted aborted either way; never
        lost, never left in transit."""
        self.metrics.inc("migrations_aborted")
        pair = tr.item.pair
        if pair is not None and pair.winner is not None:
            if pair.winner == "twin":
                self._adopt(tr.item, pair)
            return
        if self.tier_up[tr.src] and self._readmit(tr.src, tr, force=True):
            return
        self._replay(tr.item, tr.src)

    def _land_migrations(self) -> Tuple[int, int]:
        """Resolve the migrations whose transfer completed: a landing row
        re-enters decode at the destination; a full destination aborts it
        back to its source (both full: it stays in transit and retries
        next step); a row whose hedge pair resolved against it mid-flight
        is dropped, counted aborted; a partitioned link or a crashed
        destination aborts at once.  Returns ``(completed, aborted)``."""
        if not self.migrations:
            return 0, 0
        now = time.perf_counter()
        completed = aborted = 0
        still: List[_Transit] = []
        for tr in self.migrations:
            if (not self.link_state[tr.dst - 1].up
                    or not self.tier_up[tr.dst]):
                # the state never arrives: abort now, not at t_land, so
                # drain() can never spin on an unlandable transit
                self._abort_transit(tr)
                aborted += 1
                continue
            if now < tr.t_land:
                still.append(tr)
                continue
            pair = tr.item.pair
            if pair is not None and pair.winner is not None:
                if pair.winner == "twin":
                    self._adopt(tr.item, pair)
                self.metrics.inc("migrations_aborted")
                aborted += 1
            elif self._readmit(tr.dst, tr):
                self.metrics.inc("migrations_completed")
                completed += 1
            elif self._readmit(tr.src, tr):
                self.metrics.inc("migrations_aborted")
                aborted += 1
            else:
                still.append(tr)
        self.migrations = still
        return completed, aborted

    def _spill(self, pending: Dict[Tuple[int, str], List[_Queued]],
               capped: bool) -> int:
        """Waterfall: a tier with no admitted capacity (say scaled to zero
        with scale-up off) spills its pending load over the link to the
        next tier's work queue, unless the link is down or the next tier
        crashed.  ``capped`` bounds the check by the tier's KPA-admitted
        concurrency less its residents.  Returns the requests spilled."""
        last = len(self.tiers) - 1
        spilled = 0
        for (ti, fn), lst in list(pending.items()):
            tier = self.tiers[ti]
            if not (lst and ti < last and self.link_state[ti].up
                    and self.tier_up[ti + 1]):
                continue
            cap = tier.capacity(fn)
            if capped:
                cap -= tier.inflight_count(fn)
            if tier.admission_budget(fn, lst[:1], cap=cap) > 0:
                continue
            for it in lst:
                self._cross_link(it, ti)
            pending.setdefault((ti + 1, fn), []).extend(lst)
            pending[(ti, fn)] = []
            spilled += len(lst)
        return spilled

    def _run_continuous(self, pending: Dict[Tuple[int, str], List[_Queued]]
                        ) -> Dict:
        """The continuous-batching decode loop over every tier.

        Each iteration is one scheduler step: (0) land migrated state
        whose transfer completed; (1) one shared ``decode_all`` step per
        endpoint with in-flight slots, retiring finished rows at once (a
        retiring hedge arm wins its pair and evicts its slot-resident
        sibling); (2) one admission pass packing queued requests into the
        freed slots (bucketed prefill), at most ``max_waves_per_tick``
        rounds.  With ``max_steps_per_tick`` set, long requests stay
        slot-resident across ticks; otherwise the tick runs until all
        admitted work retires.  Leftovers go back to their tier's gateway
        with their stamps; a full bounded backlog 503s them."""
        served: Dict[str, int] = {t.name: 0 for t in self.tiers}
        waves = steps = spilled = 0
        won = cancelled = 0
        mig_completed = mig_aborted = 0

        def adm_capped() -> bool:
            return (self.max_waves_per_tick is not None
                    and waves >= self.max_waves_per_tick)

        def stp_capped() -> bool:
            return (self.max_steps_per_tick is not None
                    and steps >= self.max_steps_per_tick)

        def retire(ti: int, fn: str, rec: _InFlight) -> None:
            """A finished row left its slot: resolve its hedge pair (the
            first arm home wins) and record and count it; a losing arm
            records nothing."""
            nonlocal won, cancelled
            tier = self.tiers[ti]
            item = rec.item
            lat = tier.finish(fn, rec)
            pair = item.pair
            arm = "twin" if item.hedge else "primary"
            if pair is not None and pair.winner is None:
                pair.winner = arm
                pair.winner_req = item.req
                if item.hedge:
                    won += 1
                    self.metrics.inc("hedges_won")
                else:
                    cancelled += 1
                    self.metrics.inc("hedges_cancelled")
                self._evict_loser(pair)
            elif pair is not None and pair.winner != arm:
                return             # the loser outran its eviction: drop
            tier.metrics.record_latency(fn, lat)
            served[tier.name] += 1

        def admit_batch(ti: int, fn: str, batch: List[_Queued]) -> None:
            in_flight, finished = self.tiers[ti].admit(fn, batch)
            for rec in in_flight:
                if rec.item.pair is not None:
                    rec.item.pair.set_ref(rec.item.hedge, ti, rec)
            for rec in finished:
                retire(ti, fn, rec)

        def admit_round() -> bool:
            admitted_any = False
            for (ti, fn), lst in pending.items():
                if not lst:
                    continue
                lst[:] = [it for it in lst if not self._settle_resolved(it)]
                tier = self.tiers[ti]
                budget = tier.admission_budget(
                    fn, lst, cap=tier.capacity(fn) - tier.inflight_count(fn))
                if budget <= 0 or not lst:
                    continue
                batch, pending[(ti, fn)] = lst[:budget], lst[budget:]
                admit_batch(ti, fn, batch)
                admitted_any = True
            return admitted_any

        def land() -> None:
            nonlocal mig_completed, mig_aborted
            c, a = self._land_migrations()
            mig_completed += c
            mig_aborted += a

        def await_landing() -> None:
            """Nothing to decode or admit until a transfer lands: sleep to
            the earliest landing (a step-capped tick instead breaks out
            and the row lands a later tick).  When both ends refuse it
            for capacity, force-land it anyway (the scale-from-zero floor
            of a migration)."""
            nonlocal mig_completed, mig_aborted
            wait = (min(tr.t_land for tr in self.migrations)
                    - time.perf_counter())
            if wait > 0:
                time.sleep(wait)
            c, a = self._land_migrations()
            mig_completed += c
            mig_aborted += a
            if c or a:
                return
            now = time.perf_counter()
            idx = next(i for i, tr in enumerate(self.migrations)
                       if tr.t_land <= now)
            tr = self.migrations.pop(idx)
            if self._readmit(tr.dst, tr, force=True):
                self.metrics.inc("migrations_completed")
                mig_completed += 1
            elif self._readmit(tr.src, tr, force=True):
                self.metrics.inc("migrations_aborted")
                mig_aborted += 1
            else:
                raise RuntimeError("scheduler wedged: migrated state "
                                   "cannot land on any tier")

        while True:
            land()
            # (1) one decode step across every endpoint with work
            stepped = False
            for ti, tier in enumerate(self.tiers):
                for fn in tier.endpoints:
                    if tier.inflight_count(fn) == 0:
                        continue
                    stepped = True
                    for rec in tier.step(fn):
                        retire(ti, fn, rec)
            if stepped:
                steps += 1
            # (2) admit into freed slots, same step (under a step cap too,
            # so paced ticks keep admitting beside slot-resident work)
            admitted = False
            if not adm_capped():
                admitted = admit_round()
                if admitted:
                    waves += 1
            if stepped and stp_capped():
                break              # in-flight work carries to the next tick
            if self.in_flight == 0:
                if not any(pending.values()):
                    break
                if adm_capped():
                    break          # leftovers requeue below
            if stepped or admitted:
                continue
            if not any(pending.values()):
                if not self.migrations:
                    break          # only resolved-pair items were swept
                await_landing()
                continue
            # stalled: nothing decoding, nothing admissible
            if self.topology.waterfall:
                n = self._spill(pending, capped=True)
                spilled += n
                if n:
                    continue
            # scale-from-zero floor: a queued request implies >= 1 desired
            # replica next scrape; don't deadlock on degenerate bounds
            progress = False
            for (ti, fn), lst in pending.items():
                if lst and self.tiers[ti].admission_budget(fn, lst[:1]) > 0:
                    admit_batch(ti, fn, [lst.pop(0)])
                    waves += 1
                    progress = True
                    break
            if not progress:
                if self.migrations:
                    await_landing()    # a landing frees slots or capacity
                    continue
                raise RuntimeError("scheduler wedged: pending work but "
                                   "no free slot on any tier")

        # Tick over: unserved hedge twins are abandoned (the pair resolves
        # to the primary, which records normally when it completes).
        for lst in pending.values():
            for it in lst:
                if it.hedge and it.pair.winner is None:
                    it.pair.winner = "primary"
                    cancelled += 1
                    self.metrics.inc("hedges_cancelled")
        # Unserved primaries whose twin already won adopt its result; the
        # rest go back to their tier's gateway, sorted by submit time,
        # with their stamps kept (the backlog age the next scrape reads
        # stays monotone).  A primary whose twin is still slot-resident
        # keeps its pair: the race settles next tick.
        requeue: Dict[int, List[_Queued]] = {}
        for (ti, fn), lst in pending.items():
            for it in lst:
                if it.hedge:
                    continue
                pair = it.pair
                if pair is not None and pair.winner == "twin":
                    self._adopt(it, pair)
                    continue
                if pair is not None and pair.winner == "primary":
                    it.pair = None
                requeue.setdefault(ti, []).append(it)
        for ti, lst in requeue.items():
            for it in sorted(lst, key=lambda it: it.t_submit):
                if not self.gateways[ti].push(it):
                    # the tier's bounded backlog is full: dropped for good
                    # (a 503), and the request says so
                    it.req.failed = True
                    self._reject(ti, it.fn)
                    if it.pair is not None and it.pair.winner is None:
                        # a dropped primary can never adopt: end the race
                        # and evict its still-running twin
                        it.pair.winner = "primary"
                        cancelled += 1
                        self.metrics.inc("hedges_cancelled")
                        self._evict_loser(it.pair)
        return {"served": served, "hedges_won": won,
                "hedges_cancelled": cancelled, "spilled": spilled,
                "waves": waves, "steps": steps,
                "migrated": mig_completed,
                "migrations_aborted": mig_aborted,
                "inflight": self.in_flight}

    # -- the run-to-completion wave scheduler ---------------------------------
    def _run_waves(self, pending: Dict[Tuple[int, str], List[_Queued]],
                   pairs: List[_HedgePair]) -> Dict:
        """Drain every tier's gateway in autoscaler-budgeted waves, each
        run to completion through ``Tier.serve_batch`` (the baseline the
        continuous scheduler is measured against).  Both arms of a hedge
        run to completion; the faster one wins and only its latency is
        recorded."""
        served: Dict[str, int] = {t.name: 0 for t in self.tiers}
        waves = spilled = 0

        def dispatch(ti: int, fn: str, batch: List[_Queued]) -> None:
            nonlocal waves
            tier = self.tiers[ti]
            record = [it.pair is None for it in batch]
            results = tier.serve_batch(
                fn, [(it.req, it.t_submit) for it in batch], record=record)
            waves += 1
            for it, (_, lat) in zip(batch, results):
                if it.pair is not None:
                    it.pair.note(it, tier, lat)
                if not it.hedge:
                    served[tier.name] += 1

        def capped() -> bool:
            return (self.max_waves_per_tick is not None
                    and waves >= self.max_waves_per_tick)

        while any(pending.values()) and not capped():
            progress = False
            for (ti, fn), lst in pending.items():
                if not lst or capped():
                    continue
                tier = self.tiers[ti]
                budget = tier.admission_budget(fn, lst,
                                               cap=tier.capacity(fn))
                if budget <= 0:
                    continue
                batch, pending[(ti, fn)] = lst[:budget], lst[budget:]
                dispatch(ti, fn, batch)
                progress = True
            if not progress and self.topology.waterfall:
                n = self._spill(pending, capped=False)
                spilled += n
                progress = n > 0
            if not progress:
                # scale-from-zero floor, as in the continuous loop
                for (ti, fn), lst in pending.items():
                    if lst and self.tiers[ti].admission_budget(
                            fn, lst[:1]) > 0:
                        dispatch(ti, fn, [lst.pop(0)])
                        progress = True
                        break
                if not progress:
                    raise RuntimeError("scheduler wedged: pending work but "
                                       "no free slot on any tier")

        # Wave budget spent: an unserved primary whose twin completed
        # adopts the twin's result (served once, by the twin); the rest go
        # back to their tier's gateway with their stamps.  Unserved twins
        # are dropped.
        adopted = 0
        requeue: Dict[int, List[_Queued]] = {}
        for (ti, fn), lst in pending.items():
            for it in lst:
                if it.hedge:
                    continue
                pair = it.pair
                if pair is not None and pair.twin_lat is not None:
                    pair.winner = "twin"
                    pair.winner_req = pair.twin_req
                    self._adopt(it, pair)
                    pair.twin_tier.metrics.record_latency(it.fn,
                                                          pair.twin_lat)
                    served[pair.twin_tier.name] += 1
                    adopted += 1
                    continue
                if pair is not None:
                    # the unserved twin is dropped with its primary
                    # requeued: the hedge is over (counted cancelled)
                    pair.winner = "primary"
                it.pair = None       # a requeued primary records normally
                requeue.setdefault(ti, []).append(it)
        for ti, lst in requeue.items():
            for it in sorted(lst, key=lambda it: it.t_submit):
                if not self.gateways[ti].push(it):
                    it.req.failed = True
                    self._reject(ti, it.fn)

        # resolve hedge pairs by latency: only the winner's sample feeds
        # the controller windows
        won = adopted
        cancelled = 0
        for pair in pairs:
            if pair.primary_lat is None:
                if pair.winner == "primary" and pair.twin_lat is None:
                    cancelled += 1   # both arms unserved: hedge abandoned
                continue
            if pair.twin_lat is not None and pair.twin_lat < pair.primary_lat:
                pair.twin_tier.metrics.record_latency(pair.fn, pair.twin_lat)
                pair.winner = "twin"
                won += 1
            else:
                pair.primary_tier.metrics.record_latency(pair.fn,
                                                         pair.primary_lat)
                pair.winner = "primary"
                cancelled += 1
        if won:
            self.metrics.inc("hedges_won", won)
        if cancelled:
            self.metrics.inc("hedges_cancelled", cancelled)
        return {"served": served, "hedges_won": won,
                "hedges_cancelled": cancelled, "spilled": spilled,
                "waves": waves, "steps": 0, "migrated": 0,
                "migrations_aborted": 0, "inflight": 0}
