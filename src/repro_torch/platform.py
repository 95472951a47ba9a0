"""``repro_torch.platform`` — the front door to the port's continuum.

The counterpart of ``repro/platform.py`` for the live runtime::

    from repro_torch.platform import Continuum, TierConfig

    cc = Continuum(edge=TierConfig(slots=2), cloud=TierConfig(slots=16),
                   policy="auto")            # device="cuda" by default
    cc.deploy(spec, model_cfg, params)       # params already on the card
    cc.submit("fn", request)                 # ingress Gateway
    cc.tick()                                # scrape -> route -> serve
    cc.drain()                               # finish every backlog

A chain of :class:`TierSpec` (``Continuum(topology=Topology(...))``)
may give a tier a paged KV pool with prefix sharing
(``TierSpec(page_size=16, pool_pages=...)``).  Policy shorthands: a
number in [0, 100] (static split) or ``"auto"`` (the paper's Eqs
(1)-(4)).  The simulator (``Continuum.simulate`` / ``sweep``) is not
ported yet.
"""

from __future__ import annotations

from repro_torch.core.offload import OffloadConfig
from repro_torch.core.policy import (AutoOffload, ControlLoop, Policy,
                                     StaticSplit)
from repro_torch.core.replication import AutoscalingPolicy, FunctionSpec
from repro_torch.core.topology import LinkSpec, TierSpec, Topology
from repro_torch.serving.engine import Request
from repro_torch.serving.tiers import EdgeCloudContinuum, Gateway, TierConfig

__all__ = [
    "Continuum", "TierConfig", "TierSpec", "LinkSpec", "Topology",
    "Gateway", "Request", "Policy", "StaticSplit", "AutoOffload",
    "ControlLoop", "OffloadConfig", "AutoscalingPolicy", "FunctionSpec",
]


class Continuum(EdgeCloudContinuum):
    """The live batched runtime (see
    :class:`~repro_torch.serving.tiers.EdgeCloudContinuum`)."""

    def drain(self, max_ticks: int = 1000) -> int:
        """Tick until every gateway backlog and in-flight slot is empty.
        Returns the number of ticks it took; raises if ``max_ticks`` is
        not enough."""
        for n in range(max_ticks):
            if self.queued == 0 and self.in_flight == 0:
                return n
            self.tick()
        if self.queued or self.in_flight:
            raise RuntimeError(
                f"drain: {self.queued} queued / {self.in_flight} in flight "
                f"after {max_ticks} ticks")
        return max_ticks
