"""``repro_torch.platform`` — the front door to the port's continuum.

The counterpart of ``repro/platform.py``, for both deployments::

    from repro_torch.platform import Continuum, TierConfig, Topology

    # live, two-tier sugar: deploy models, submit requests, tick
    cc = Continuum(edge=TierConfig(slots=2), cloud=TierConfig(slots=16),
                   policy="auto")            # device="cuda" by default
    cc.deploy(spec, model_cfg, params)       # params already on the card
    cc.submit("fn", request)                 # ingress Gateway
    cc.tick()                                # scrape -> route -> serve
    cc.drain()                               # finish every backlog

    # live, N-tier, trace-driven, net-aware
    cc = Continuum.from_topology(Topology.device_edge_cloud(),
                                 policy="auto+net", req_bytes=6.0e6,
                                 trace=Trace.bursty(0.5, 8.0, 30.0))

    # simulated: the paper's testbed, same policy objects, any topology
    res = Continuum.simulate("matmult", "auto+net")
    res3 = Continuum.simulate("matmult", "auto",
                              topology=Topology.device_edge_cloud(),
                              faults=edge_brownout(30.0, 60.0))
    table = Continuum.sweep("matmult", policies=(0.0, 50.0, "auto"))

    # live controls: hedging, mid-stream migration, live faults, caps
    cc = Continuum.from_topology(Topology.device_edge_cloud(),
                                 policy="auto+net+hedge+migrate",
                                 max_steps_per_tick=4,
                                 faults=tier_outage(10.0, 14.0, tier=1))

A tier of the chain may hold a paged KV pool with prefix sharing
(``TierSpec(page_size=16, pool_pages=...)``).  Policy shorthands: a
number in [0, 100] (static split), ``"auto"`` (the paper's Eqs (1)-(4)),
and its modifiers in any combination: ``+net`` (the link-capacity cap),
``+hedge`` (p99 straggler backups), ``+migrate`` (mid-stream migration of
slot-resident rows with their cache state).  ``scheduler="wave"`` keeps
the run-to-completion wave drain as the baseline.  ``eq1="sketch"``
(in ``simulate`` and ``from_topology``) reads the controller's Eq (1)
from streaming histograms instead of sorted windows.  The simulator is
numpy on the host and runs anywhere; the live runtime defaults to the
card.

Cost-modeled tiers name the architecture that prices them::

    topo = Topology.device_edge_cloud(cost_model=True)   # on an H100
    tier_cost("llama3-405b", mesh_shape=(16, 16), requested_slots=64)
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from repro_torch.core.offload import OffloadConfig
from repro_torch.core.policy import (AutoOffload, ControlLoop,
                                     HedgedOffload, MigratingOffload,
                                     NetAwareOffload, Policy, PolicySpec,
                                     StaticSplit)
from repro_torch.core.replication import AutoscalingPolicy, FunctionSpec
from repro_torch.core.simulator import (ContinuumSimulator, SimConfig,
                                        SimResult)
from repro_torch.core.topology import LinkSpec, TierSpec, Topology
from repro_torch.launch.tier_cost import TierCost, tier_cost
from repro_torch.serving.engine import Request
from repro_torch.serving.tiers import EdgeCloudContinuum, Gateway, TierConfig
from repro_torch.workloads.faults import (FaultEvent, FaultSchedule,
                                          cloud_partition, edge_brownout,
                                          merge_schedules, tier_outage)
from repro_torch.workloads.trace import Trace

__all__ = [
    "Continuum", "TierConfig", "TierSpec", "LinkSpec", "Topology",
    "Gateway", "SimConfig", "SimResult", "Request", "Policy",
    "StaticSplit", "AutoOffload", "NetAwareOffload", "HedgedOffload",
    "MigratingOffload",
    "ControlLoop", "OffloadConfig", "AutoscalingPolicy", "FunctionSpec",
    "Trace", "FaultEvent", "FaultSchedule",
    "edge_brownout", "cloud_partition", "tier_outage", "merge_schedules",
    "tier_cost", "TierCost",
]


class Continuum(EdgeCloudContinuum):
    """Instances are the live batched runtime (see
    :class:`~repro_torch.serving.tiers.EdgeCloudContinuum`); the
    classmethods run the same policies through the simulator."""

    @classmethod
    def from_topology(cls, topology: Topology, policy: PolicySpec = "auto",
                      eq1: str = "window", sketch=None,
                      **kwargs) -> "Continuum":
        """The live runtime over an explicit N-tier chain; ``eq1`` and
        ``sketch`` pick the controller's Eq-(1) front end."""
        return cls(policy=policy, topology=topology, eq1=eq1,
                   sketch=sketch, **kwargs)

    def drain(self, max_ticks: int = 1000) -> int:
        """Tick until every gateway backlog, in-flight slot and migration
        still crossing a link is empty (``in_flight`` counts transits; a
        ``max_steps_per_tick``-paced run leaves long requests resident
        across ticks).  Returns the number of ticks it took; raises if
        ``max_ticks`` is not enough."""
        for n in range(max_ticks):
            if self.queued == 0 and self.in_flight == 0:
                return n
            self.tick()
        if self.queued or self.in_flight:
            raise RuntimeError(
                f"drain: {self.queued} queued / {self.in_flight} in flight "
                f"after {max_ticks} ticks")
        return max_ticks

    @classmethod
    def simulate(cls, workload: str, policy: PolicySpec,
                 cfg: Optional[SimConfig] = None,
                 offload_cfg: Optional[OffloadConfig] = None,
                 topology: Optional[Topology] = None,
                 trace=None, faults: Optional[FaultSchedule] = None,
                 eq1: str = "window", sketch=None) -> SimResult:
        """One simulator run of ``workload`` under ``policy`` over the
        paper's 2-tier apparatus or an explicit ``topology``; a ``trace``
        replaces the ramped-Poisson arrivals, ``faults`` injects link
        and tier faults mid-run, and ``eq1="sketch"`` (with an optional
        ``sketch`` spec) switches Eq (1) to the streaming sketch."""
        return ContinuumSimulator(workload, policy, cfg or SimConfig(),
                                  offload_cfg=offload_cfg,
                                  topology=topology, trace=trace,
                                  faults=faults, eq1=eq1,
                                  sketch=sketch).run()

    @classmethod
    def sweep(cls, workload: str,
              policies: Sequence[PolicySpec] = (0.0, 25.0, 50.0, 75.0,
                                                100.0, "auto"),
              cfg: Optional[SimConfig] = None,
              topology: Optional[Topology] = None,
              trace=None, faults: Optional[FaultSchedule] = None
              ) -> Dict[str, SimResult]:
        """The paper's Table 2 row for one workload."""
        cfg = cfg or SimConfig()
        return {str(p): cls.simulate(workload, p, cfg, topology=topology,
                                     trace=trace, faults=faults)
                for p in policies}
