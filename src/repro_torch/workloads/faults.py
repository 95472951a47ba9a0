"""Fault injection: the chaos half of ``repro_torch.workloads``.

The port's copy of ``repro/workloads/faults.py``.  A
:class:`FaultSchedule` is an ordered list of timed :class:`FaultEvent`\\ s
over a :class:`~repro_torch.core.topology.Topology` — link degradation
(bandwidth/RTT multipliers), link partition, tier crash (slots and
in-flight state lost) and recovery.  The simulator applies it as fault
events in its heap, the live runtime at the top of each tick (and
through ``EdgeCloudContinuum.apply_fault``).

The frozen :class:`~repro_torch.core.topology.LinkSpec`\\ s are never
mutated: fault state lives in a mutable :class:`LinkState` overlay per
link (``bw_mult`` / ``rtt_mult`` / ``up``), which every crossing consults
and which net-aware policies are re-capped from
(:meth:`repro_torch.core.policy.AutoOffload.set_link_capacity`).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Tuple

from repro_torch.core.topology import LinkSpec

#: event kinds, and which target field they address
LINK_KINDS = ("degrade_link", "partition_link", "restore_link")
TIER_KINDS = ("crash_tier", "restore_tier")
KINDS = LINK_KINDS + TIER_KINDS


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One timed fault on the deployment clock (simulator seconds /
    live logical scrape time).

    ``target`` is a link index (``degrade_link`` / ``partition_link`` /
    ``restore_link`` — link b joins tier b to tier b+1) or a tier index
    (``crash_tier`` / ``restore_tier``).  ``bw_mult`` / ``rtt_mult``
    apply to ``degrade_link`` only: effective bandwidth is
    ``spec.bandwidth_Bps * bw_mult``, effective RTT is
    ``spec.rtt_s * rtt_mult``.  ``restore_link`` clears both and any
    partition.
    """

    t: float
    kind: str
    target: int
    bw_mult: float = 1.0
    rtt_mult: float = 1.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"pick from {KINDS}")
        if self.t < 0:
            raise ValueError(f"fault time must be >= 0, got {self.t}")
        if self.bw_mult <= 0 or self.rtt_mult <= 0:
            raise ValueError("bw_mult/rtt_mult must be > 0 "
                             "(use partition_link to sever a link)")


class FaultSchedule:
    """An ordered fault script, consumed once per run.

    Consumers call :meth:`due` with their current clock and apply the
    returned events in order; :meth:`reset` rewinds for a fresh run (the
    schedule itself is immutable).
    """

    def __init__(self, events: Iterable[FaultEvent] = ()):
        self.events: Tuple[FaultEvent, ...] = tuple(
            sorted(events, key=lambda e: e.t))
        self._next = 0

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    def __repr__(self) -> str:
        kinds = [f"{e.kind}@{e.t:g}s" for e in self.events]
        return f"FaultSchedule({', '.join(kinds)})"

    def reset(self) -> None:
        self._next = 0

    def due(self, now: float) -> List[FaultEvent]:
        """Pop every event with ``t <= now`` (in time order)."""
        out = []
        while (self._next < len(self.events)
               and self.events[self._next].t <= now):
            out.append(self.events[self._next])
            self._next += 1
        return out

    @property
    def exhausted(self) -> bool:
        return self._next >= len(self.events)

    def validate(self, num_tiers: int) -> "FaultSchedule":
        """Check every target index against a topology's shape."""
        for e in self.events:
            hi = num_tiers - 1 if e.kind in LINK_KINDS else num_tiers
            if not 0 <= e.target < hi:
                what = "link" if e.kind in LINK_KINDS else "tier"
                raise ValueError(
                    f"{e.kind} targets {what} {e.target}, but the "
                    f"topology has {hi} {what}s")
        return self


class LinkState:
    """Mutable runtime overlay over one frozen :class:`LinkSpec`."""

    def __init__(self, spec: LinkSpec):
        self.spec = spec
        self.bw_mult = 1.0
        self.rtt_mult = 1.0
        self.up = True

    def _effective(self) -> LinkSpec:
        """The degraded link as a real :class:`LinkSpec`, so every cost
        query goes through the ONE canonical latency formula instead of
        a re-typed copy that could drift from it."""
        if self.bw_mult == 1.0 and self.rtt_mult == 1.0:
            return self.spec
        return dataclasses.replace(
            self.spec,
            rtt_s=self.spec.rtt_s * self.rtt_mult,
            bandwidth_Bps=self.spec.bandwidth_Bps * self.bw_mult)

    @property
    def bandwidth_Bps(self) -> float:
        return self._effective().bandwidth_Bps

    @property
    def rtt_s(self) -> float:
        return self._effective().rtt_s

    def latency_s(self, nbytes: float = 0.0) -> float:
        return self._effective().latency_s(nbytes)

    def effective_capacity(self) -> float:
        """Bytes/s a net-aware controller should cap against: the
        degraded bandwidth, or ~zero when partitioned (R_t caps to 0)."""
        return self.bandwidth_Bps if self.up else 1e-6

    def apply(self, ev: FaultEvent) -> None:
        if ev.kind == "degrade_link":
            self.bw_mult, self.rtt_mult = ev.bw_mult, ev.rtt_mult
        elif ev.kind == "partition_link":
            self.up = False
        elif ev.kind == "restore_link":
            self.bw_mult = self.rtt_mult = 1.0
            self.up = True
        else:
            raise ValueError(f"{ev.kind} is not a link fault")

    def __repr__(self) -> str:
        state = ("up" if self.bw_mult == self.rtt_mult == 1.0 else
                 f"degraded(bw x{self.bw_mult:g}, rtt x{self.rtt_mult:g})"
                 ) if self.up else "PARTITIONED"
        return f"LinkState({state})"


# -- named scenarios --------------------------------------------------------

def edge_brownout(t0: float, t1: float, link: int = 0,
                  bw_mult: float = 0.05, rtt_mult: float = 5.0
                  ) -> FaultSchedule:
    """Brownout of an edge link: heavy degradation over ``[t0, t1)``."""
    return FaultSchedule([
        FaultEvent(t0, "degrade_link", link, bw_mult=bw_mult,
                   rtt_mult=rtt_mult),
        FaultEvent(t1, "restore_link", link)])


def cloud_partition(t0: float, t1: float, link: int) -> FaultSchedule:
    """Full partition of the cloud-ward link over ``[t0, t1)``:
    nothing crosses, in-transit migrations abort back to source."""
    return FaultSchedule([FaultEvent(t0, "partition_link", link),
                          FaultEvent(t1, "restore_link", link)])


def tier_outage(t0: float, t1: float, tier: int) -> FaultSchedule:
    """Crash one tier over ``[t0, t1)``: slots and in-flight state are
    lost (resident requests replay via the replication path), recovery
    re-registers the tier's functions from the cloud specs."""
    return FaultSchedule([FaultEvent(t0, "crash_tier", tier),
                          FaultEvent(t1, "restore_tier", tier)])


def merge_schedules(*schedules: Optional[FaultSchedule]) -> FaultSchedule:
    """Compose scenario helpers into one time-ordered schedule."""
    events: List[FaultEvent] = []
    for s in schedules:
        if s is not None:
            events.extend(s.events)
    return FaultSchedule(events)
