"""``repro_torch.workloads`` — arrival traces and fault schedules.

The port's copy of ``repro.workloads``: :mod:`.trace` (materialized
:class:`Trace` columns from seeded generators, CSV replay, and the
inline-draw :class:`ArrivalProcess` form) and :mod:`.faults` (timed
:class:`FaultEvent` schedules over a topology, applied through a mutable
:class:`LinkState` overlay).  Both are numpy with explicit generators,
bit-identical to the reference on the same seeds.
"""

from repro_torch.workloads.faults import (FaultEvent, FaultSchedule,
                                          LinkState, cloud_partition,
                                          edge_brownout, merge_schedules,
                                          tier_outage)
from repro_torch.workloads.trace import (ArrivalProcess, RampedPoisson,
                                         StationaryPoisson, Trace,
                                         request_rounds, trace_requests)

__all__ = [
    "ArrivalProcess", "RampedPoisson", "StationaryPoisson", "Trace",
    "request_rounds", "trace_requests",
    "FaultEvent", "FaultSchedule", "LinkState",
    "edge_brownout", "cloud_partition", "tier_outage", "merge_schedules",
]
