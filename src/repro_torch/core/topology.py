"""Declarative N-tier continuum topologies.

The port's counterpart of ``repro/core/topology.py``: an ordered chain of
tiers (:class:`TierSpec`) joined by links (:class:`LinkSpec`), ingress at
tier 0.  ``waterfall=True`` lets a stalled tier spill its backlog down
the chain.  The historical two-tier API is :meth:`Topology.pair`, with
waterfall disabled so a full edge queue rejects (503) as in the seed
semantics.

``page_size`` switches a tier's endpoints to the paged KV pool
(``pool_pages`` pages of ``page_size`` tokens, default ``slots`` full
rows), with the reference's validation.  Not ported yet (ROADMAP.md):
the cost-modeled tiers (``model=``, the hardware cost table) raise
``NotImplementedError``; the simulator-only fields are absent.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence, Tuple

from repro_torch.core.replication import AutoscalingPolicy


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One serving location in the chain: concurrent ``slots`` of
    ``max_len`` context, a synthetic per-request overhead, KPA bounds and
    a bounded gateway backlog of ``slots * queue_depth_per_slot``
    (``None`` = unbounded, the elastic cloud).  ``page_size`` (which must
    divide ``max_len``) makes the KV pool paged, of ``pool_pages`` pages
    (at least one full row; default ``slots`` full rows)."""

    name: str
    slots: int = 4
    max_len: int = 256
    # synthetic per-request overhead paid at this tier (e.g. WAN RTT)
    extra_latency_s: float = 0.0
    # per-tier KPA bounds; when set they override each function's spec
    autoscaling: Optional[AutoscalingPolicy] = None
    stable_window_s: float = 60.0
    panic_window_s: float = 6.0
    queue_depth_per_slot: Optional[int] = 8
    # paged KV pool (None = dense per-slot rows)
    page_size: Optional[int] = None
    pool_pages: Optional[int] = None
    # not ported yet: asking for it raises
    model: Optional[str] = None

    def __post_init__(self):
        if self.model is not None:
            raise NotImplementedError(
                f"tier {self.name!r}: cost-modeled tiers (model=...) need "
                f"the H100 cost table, not ported yet (ROADMAP.md)")
        if self.page_size is not None:
            if self.page_size <= 0 or self.max_len % self.page_size:
                raise ValueError(
                    f"page_size must divide max_len ({self.max_len}), "
                    f"got {self.page_size}")
            ppr = self.max_len // self.page_size
            if self.pool_pages is not None and self.pool_pages < ppr:
                raise ValueError(
                    f"pool_pages={self.pool_pages} cannot hold one full "
                    f"row ({ppr} pages)")
        elif self.pool_pages is not None:
            raise ValueError("pool_pages requires page_size")

    @property
    def pages_per_row(self) -> int:
        return 0 if self.page_size is None else self.max_len // self.page_size

    @property
    def total_pages(self) -> int:
        """Usable pool pages (0 for dense tiers)."""
        if self.page_size is None:
            return 0
        if self.pool_pages is not None:
            return self.pool_pages
        return self.slots * self.pages_per_row


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """The hop between tier i and tier i+1 (RTT + a bandwidth cap that
    payloads serialize over)."""

    rtt_s: float = 0.04
    bandwidth_Bps: float = 100e6

    # lint: ignore[parity-drift] -- the port imports nothing of repro;
    # tests/test_torch_control.py::test_link_latency_matches_reference
    # holds this copy against repro.core.topology.LinkSpec.latency_s
    def latency_s(self, nbytes: float = 0.0) -> float:
        """Wall-clock cost of moving one ``nbytes`` payload over the hop
        (RTT + serialization), charged whenever a request crosses it."""
        return self.rtt_s + nbytes / self.bandwidth_Bps


class Topology:
    """An ordered chain of N tiers joined by N-1 links, ingress at tier 0.

    Construction validates the chain: non-empty, unique tier names,
    ``len(links) == len(tiers) - 1``, non-negative RTTs, queues and slots.
    """

    def __init__(self, tiers: Sequence[TierSpec],
                 links: Optional[Sequence[LinkSpec]] = None,
                 waterfall: bool = True):
        tiers = tuple(tiers)
        if not tiers:
            raise ValueError("topology needs at least one tier")
        names = [t.name for t in tiers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tier names in {names}")
        for t in tiers:
            if not isinstance(t, TierSpec):
                raise TypeError(f"expected TierSpec, got {type(t).__name__}")
            if t.slots < 0:
                raise ValueError(f"tier {t.name!r}: negative slots")
            if (t.queue_depth_per_slot is not None
                    and t.queue_depth_per_slot < 0):
                raise ValueError(
                    f"tier {t.name!r}: negative queue_depth_per_slot")
        if links is None:
            links = tuple(LinkSpec() for _ in tiers[1:])
        links = tuple(links)
        if len(links) != len(tiers) - 1:
            raise ValueError(
                f"{len(tiers)} tiers need {len(tiers) - 1} links, "
                f"got {len(links)}")
        for i, l in enumerate(links):
            if l.rtt_s < 0:
                raise ValueError(f"link {i}: negative RTT")
            if l.bandwidth_Bps <= 0:
                raise ValueError(f"link {i}: bandwidth must be > 0")
        self.tiers: Tuple[TierSpec, ...] = tiers
        self.links: Tuple[LinkSpec, ...] = links
        self.waterfall = bool(waterfall)

    def __len__(self) -> int:
        return len(self.tiers)

    def __iter__(self) -> Iterator[TierSpec]:
        return iter(self.tiers)

    def __repr__(self) -> str:
        chain = " -> ".join(t.name for t in self.tiers)
        return f"Topology({chain}, waterfall={self.waterfall})"

    @classmethod
    def pair(cls, edge, cloud, link: Optional[LinkSpec] = None) -> "Topology":
        """The historical two-tier continuum as a Topology.

        Accepts :class:`TierSpec` or the legacy ``TierConfig`` shape.
        Waterfall is disabled (a full edge queue rejects rather than
        spilling); the default link has zero RTT because the legacy API
        expresses the WAN hop as the cloud tier's ``extra_latency_s``.
        The edge's backlog is bounded, the elastic cloud's is not.
        """
        return cls(tiers=(_as_spec(edge, "edge"),
                          _as_spec(cloud, "cloud", queue_depth=None)),
                   links=(link or LinkSpec(rtt_s=0.0),), waterfall=False)


def _as_spec(obj, name: str, queue_depth: Optional[int] = 8) -> TierSpec:
    """Coerce a TierSpec or legacy TierConfig-shaped object to a TierSpec."""
    if isinstance(obj, TierSpec):
        return obj
    return TierSpec(
        name=name,
        slots=obj.slots,
        max_len=obj.max_len,
        extra_latency_s=getattr(obj, "extra_latency_s", 0.0),
        autoscaling=getattr(obj, "autoscaling", None),
        stable_window_s=getattr(obj, "stable_window_s", 60.0),
        panic_window_s=getattr(obj, "panic_window_s", 6.0),
        queue_depth_per_slot=getattr(obj, "queue_depth_per_slot",
                                     queue_depth))
