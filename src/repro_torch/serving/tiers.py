"""The live N-tier continuum runtime.

The port's counterpart of ``repro/serving/tiers.py``, for the default
path: the continuous-batching scheduler, the ``"auto"``, ``"auto+net"``
and static policies, exact-window Eq (1), and trace-driven arrivals::

    EdgeCloudContinuum (over a Topology chain, ingress at tier 0)
      ├── tier 0..N-1:  Gateway (bounded backlog queue) + Endpoint pool
      │                 (slots/model) + MetricsRegistry + per-function
      │                 Autoscaler (Knative-KPA concurrency)
      ├── ReplicationController  (deepest-tier spec -> shallower tiers)
      ├── ControlLoop + Policy   (Eqs (1)-(4) / static, one boundary per
      │                           adjacent tier pair)
      └── Router                 (expectation-matched assignment of the
                                  queued batch over the tier distribution)

Requests enter at the ingress gateway (``submit``).  Each ``tick`` runs
one scrape-and-update cycle through the :class:`ControlLoop`, routes the
ingress backlog over the tiers by the composed R_t distribution (each
request crossing the links down to its tier, charged RTT + payload on its
latency clock), and serves every tier's own gateway with a
continuous-batching loop: one shared ``decode_all`` step over every
slot-resident request, finished rows retired at once, queued requests
admitted into the freed slots the same step (packed bucketed prefill).
With ``topology.waterfall`` a stalled tier spills its pending load down
the chain.

A tier whose spec sets ``page_size`` serves from a paged KV pool: its
admission walks the queue head in pages (memory actually reserved, not
slots alone), and its KPA scrape meters demand in full-row equivalents
of pages.  Every tier's endpoint holds a reference to the one set of
weights deployed.  Each boundary parses the policy against its own link's
bandwidth and the ``req_bytes`` hint, so ``"auto+net"`` caps offload by
the link actually crossed (as the simulator's boundaries do).  A
``trace=`` submits each row at the top of the tick covering its arrival
time.  Hedging, live migration (a policy with a migrate threshold), live
faults (``faults=``), the wave scheduler and the sketch front end are not
ported yet and raise (ROADMAP.md, open item 3).
"""

from __future__ import annotations

import dataclasses
import math
import time
import zlib
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.autoscaler import Autoscaler
from repro_torch.core.metrics import MetricsRegistry
from repro_torch.core.offload import OffloadConfig
from repro_torch.core.policy import ControlLoop, Policy, PolicySpec
from repro_torch.core.replication import (AutoscalingPolicy, FunctionSpec,
                                          ReplicationController)
from repro_torch.core.topology import TierSpec, Topology
from repro_torch.device import DeviceLike, resolve
from repro_torch.models.common import ModelConfig
from repro_torch.serving.engine import Endpoint, Request
from repro_torch.workloads.trace import Trace

#: latency charged to a rejected request (the queue-proxy's fast 503)
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
    """One gateway queue entry."""
    fn: str
    req: Request
    t_submit: float
    tick_no: int = 0


@dataclasses.dataclass
class _InFlight:
    """One slot-resident request inside a tier's continuous decode loop."""
    item: _Queued
    slot: int
    toks: List[int]               # generated tokens so far (first from prefill)
    need: int                     # total tokens to generate
    done_at: float = 0.0


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
        sets ``page_size``."""
        page_size = getattr(self.cfg, "page_size", None)
        self.endpoints[fn_name] = Endpoint(
            model_cfg, params, slots=self.cfg.slots,
            max_len=self.cfg.max_len, device=self.device,
            paged=page_size is not None,
            page_size=page_size if page_size is not None else 16,
            total_pages=getattr(self.cfg, "pool_pages", None))
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
        set.  Over-admission raises.
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

    def finish(self, fn_name: str, rec: _InFlight) -> float:
        """Fill the request's output from a retired record and return its
        end-to-end latency (recording it is the caller's call)."""
        req = rec.item.req
        req.output = np.asarray(rec.toks, np.int32)
        req.t_done = rec.done_at
        req.latency_s = (rec.done_at - rec.item.t_submit
                         + self.cfg.extra_latency_s)
        return req.latency_s


class EdgeCloudContinuum:
    """The platform: replication + policy-driven offloading across an
    N-tier topology, with per-tier gateways and a continuous-batching
    scheduler.  ``device`` (default ``"cuda"``) is where every tier's
    endpoints run; ``seed`` seeds the routing generator and, apart, the
    trace's prompt tokens.  ``req_bytes`` is the average payload a
    net-aware boundary divides its link by; ``trace`` drives arrivals
    (``trace_prompts="per_fn"`` gives each function one prompt per
    length).  ``faults`` and a migrate threshold raise: live faults and
    live migration are not ported yet (ROADMAP.md, open item 3)."""

    def __init__(self, edge=None, cloud=None,
                 policy: PolicySpec = "auto",
                 offload_cfg: Optional[OffloadConfig] = None,
                 window: int = 64, seed: int = 0,
                 control_interval_s: float = 1.0,
                 topology: Optional[Topology] = None,
                 device: DeviceLike = "cuda",
                 req_bytes: Optional[float] = None,
                 trace: Optional[Trace] = None,
                 faults=None,
                 trace_vocab: int = 128,
                 trace_prompts: str = "random"):
        if trace_prompts not in ("random", "per_fn"):
            raise ValueError(
                f"trace_prompts must be 'random' or 'per_fn', "
                f"got {trace_prompts!r}")
        if faults is not None:
            raise NotImplementedError(
                "faults=: live fault injection is not ported yet "
                "(ROADMAP.md, open item 3); the simulator takes faults")
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
        if self.policy.migrate_threshold is not None:
            raise NotImplementedError(
                f"policy {self.policy.spec!r}: live mid-stream migration "
                f"is not ported yet (ROADMAP.md, open item 3); the "
                f"simulator migrates")
        self.window = window
        self.control_interval_s = control_interval_s
        # one reconciler per shallower tier
        self.replicators: List[ReplicationController] = [
            ReplicationController()
            for _ in range(max(len(self.tiers) - 1, 1))]
        self.cloud_specs: Dict[str, FunctionSpec] = {}
        self.fn_names: List[str] = []
        self._fn_ids: Dict[str, int] = {}
        self.control: Optional[ControlLoop] = None
        self.rng = np.random.default_rng(seed)
        # demand per boundary since the last scrape: boundary b counts the
        # requests that reached tier b, one (F,) vector per boundary
        self._num_boundaries = max(len(self.tiers) - 1, 1)
        self._crossings: List[np.ndarray] = [
            np.zeros(0, np.int64) for _ in range(self._num_boundaries)]
        self.metrics = MetricsRegistry([])
        # cumulative per-link egress bytes (routing and spill crossings)
        self.link_bytes: List[float] = [0.0] * len(topology.links)
        self._link_bytes_seen: List[float] = [0.0] * len(topology.links)
        self.log: List[Dict] = []
        self._clock = 0.0          # logical control-plane time (scrapes)
        self._tick_no = 0
        self._rejected_seen = 0
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
        """Slot-resident requests across every tier."""
        return sum(t.inflight_count(fn)
                   for t in self.tiers for fn in t.endpoints)

    # -- deployment (paper §3.3.1) ------------------------------------------
    def deploy(self, spec: FunctionSpec, model_cfg: ModelConfig,
               params) -> None:
        """Deploy to the deepest tier; replication mirrors the spec to
        every shallower tier of the chain (same params object)."""
        self.cloud.deploy(spec.name, model_cfg, params, spec.autoscaling)
        self.cloud_specs[spec.name] = spec
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
                    for b in range(self._num_boundaries)])

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
            self.tiers[ti].metrics.record_latency(fn, REJECT_LATENCY_S)

    def _cross_link(self, item: _Queued, l: int) -> None:
        """Move one queued request over link l (tier l -> tier l+1):
        charge RTT + payload serialization to its latency clock (by
        backdating its submit stamp) and count the boundary crossing."""
        if l < len(self.topology.links):
            item.t_submit -= self.topology.links[l].latency_s(
                item.req.tokens.nbytes)
            self.link_bytes[l] += item.req.tokens.nbytes
        self._count_crossing(l + 1, item.fn)

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
        windows, its gateway's backlog ages and the demand that crossed
        into tier b; returns the ingress boundary's R_t percentages."""
        now = time.perf_counter()
        qages, lats, valids = [], [], []
        for b in range(self.control.num_boundaries):
            tier_i = min(b, len(self.tiers) - 1)   # 1-tier chain: b=0
            qages.append(self.gateways[tier_i].backlog_ages(
                now, self._tick_no, self._fn_ids, len(self.fn_names)))
            lat, valid = self.tiers[tier_i].metrics.latency_windows(
                self.window)
            lats.append(lat)
            valids.append(valid)
        R_all = self.control.step_tiers(lats, valids, queue_ages=qages,
                                        arrivals=list(self._crossings))
        self._crossings = [np.zeros_like(c) for c in self._crossings]
        return R_all[0]

    # -- scheduler ------------------------------------------------------------
    def tick(self) -> Dict:
        """One scheduler round: controller update, tier assignment of the
        ingress backlog, then the continuous-batching loop over every
        tier.  Trace rows due this interval enter first (their demand is
        part of this scrape).  Returns (and logs) the round's record."""
        self._ingest_trace()
        R = self.controller_update()
        self._clock += self.control_interval_s
        self._tick_no += 1

        # Route the ingress gateway's queue over the tiers; each request
        # crosses the links down to its tier's gateway.  Deeper gateways'
        # backlogs belong to their tier and are not re-routed.
        items = self.gateways[0].pop_all()
        if items:
            fn_ids = np.asarray([self._fn_ids[it.fn] for it in items],
                                np.int32)
            tier_idx = self.control.route_tiers(self.rng, fn_ids)
            for it, tj in zip(items, tier_idx):
                for l in range(int(tj)):
                    self._cross_link(it, l)
                self.gateways[int(tj)].push(it, force=True)

        pending: Dict[Tuple[int, str], List[_Queued]] = {}
        for ti, gw in enumerate(self.gateways):
            for it in gw.pop_all():
                pending.setdefault((ti, it.fn), []).append(it)

        # KPA scrape: every (tier, fn) observes its assigned concurrency,
        # queued plus slot-resident, zeros included (that ages idle
        # functions to zero).  A paged pool meters demand in pages,
        # normalized to full-row equivalents (a half-row request is half
        # a unit of demand).
        for ti, tier in enumerate(self.tiers):
            for fn, asc in tier.autoscalers.items():
                ep = tier.endpoints[fn]
                if ep.paged:
                    pages = sum(ep.page_need(len(it.req.tokens),
                                             max(it.req.max_new, 1))
                                for it in pending.get((ti, fn), []))
                    pages += ep.resident_page_demand()
                    conc = pages / ep.pages_per_row
                else:
                    conc = (len(pending.get((ti, fn), []))
                            + tier.inflight_count(fn))
                asc.observe(self._clock, float(conc))
                asc.desired(self._clock)

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

    def _run_continuous(self, pending: Dict[Tuple[int, str], List[_Queued]]
                        ) -> Dict:
        """The continuous-batching decode loop over every tier.

        Each iteration is one scheduler step: (1) one shared
        ``decode_all`` step per endpoint with in-flight slots, retiring
        finished rows at once; (2) one admission pass packing queued
        requests into the freed slots (bucketed prefill).  The tick runs
        until every admitted request has retired and nothing is pending."""
        served: Dict[str, int] = {t.name: 0 for t in self.tiers}
        last = len(self.tiers) - 1
        waves = steps = spilled = 0

        def retire(ti: int, fn: str, rec: _InFlight) -> None:
            tier = self.tiers[ti]
            tier.metrics.record_latency(fn, tier.finish(fn, rec))
            served[tier.name] += 1

        def admit_batch(ti: int, fn: str, batch: List[_Queued]) -> None:
            _, finished = self.tiers[ti].admit(fn, batch)
            for rec in finished:
                retire(ti, fn, rec)

        def admit_round() -> bool:
            admitted_any = False
            for (ti, fn), lst in pending.items():
                if not lst:
                    continue
                tier = self.tiers[ti]
                budget = tier.admission_budget(
                    fn, lst, cap=tier.capacity(fn) - tier.inflight_count(fn))
                if budget <= 0:
                    continue
                batch, pending[(ti, fn)] = lst[:budget], lst[budget:]
                admit_batch(ti, fn, batch)
                admitted_any = True
            return admitted_any

        while True:
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
            # (2) admit into freed slots, same step
            admitted = admit_round()
            if admitted:
                waves += 1
            if self.in_flight == 0 and not any(pending.values()):
                break
            if stepped or admitted:
                continue
            # Stalled: nothing decoding, nothing admissible.
            progress = False
            if self.topology.waterfall:
                # a tier with no admitted capacity spills its pending load
                # over the link to the next tier's work queue
                for (ti, fn), lst in list(pending.items()):
                    tier = self.tiers[ti]
                    if (lst and ti < last
                            and tier.admission_budget(
                                fn, lst[:1],
                                cap=tier.capacity(fn)
                                - tier.inflight_count(fn)) <= 0):
                        for it in lst:
                            self._cross_link(it, ti)
                        pending.setdefault((ti + 1, fn), []).extend(lst)
                        pending[(ti, fn)] = []
                        spilled += len(lst)
                        progress = True
            if progress:
                continue
            # Scale-from-zero floor: a queued request implies >= 1 desired
            # replica next scrape; don't deadlock on degenerate bounds.
            for (ti, fn), lst in pending.items():
                if lst and self.tiers[ti].admission_budget(fn, lst[:1]) > 0:
                    admit_batch(ti, fn, [lst.pop(0)])
                    waves += 1
                    progress = True
                    break
            if not progress:
                raise RuntimeError("scheduler wedged: pending work but "
                                   "no free slot on any tier")
        return {"served": served, "spilled": spilled, "waves": waves,
                "steps": steps}
