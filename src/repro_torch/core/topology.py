"""Declarative N-tier continuum topologies.

The port's counterpart of ``repro/core/topology.py``: an ordered chain of
tiers (:class:`TierSpec`) joined by links (:class:`LinkSpec`), ingress at
tier 0.  ``waterfall=True`` lets a stalled tier spill its backlog down
the chain.  The historical two-tier API is :meth:`Topology.pair`, with
waterfall disabled so a full edge queue rejects (503) as in the seed
semantics.

``page_size`` switches a tier's endpoints to the paged KV pool
(``pool_pages`` pages of ``page_size`` tokens, default ``slots`` full
rows), with the reference's validation.  ``service_rate_mult`` is the
simulator's service speed relative to the workload's edge time (``None``
= the position's default).  :meth:`Topology.device_edge_cloud` is the
reference's canonical 3-tier chain.

A tier that names a ``model`` (and optionally a ``mesh_shape``) is
cost-modeled: :meth:`Topology.resolve_costs` derives its ``slots``,
``decode_step_ms`` and ``service_rate_mult`` from
``repro_torch.launch.tier_cost`` on a hardware record (the H100 SXM5 by
default), and both deployments refuse a spec left unresolved.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Iterator, Optional, Sequence, Tuple

from repro_torch.core.replication import AutoscalingPolicy

if TYPE_CHECKING:
    from repro_torch.launch.roofline import Hardware


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One serving location in the chain: concurrent ``slots`` of
    ``max_len`` context, a synthetic per-request overhead, KPA bounds and
    a bounded gateway backlog of ``slots * queue_depth_per_slot``
    (``None`` = unbounded, the elastic cloud).  ``page_size`` (which must
    divide ``max_len``) makes the KV pool paged, of ``pool_pages`` pages
    (at least one full row; default ``slots`` full rows).
    ``service_rate_mult`` drives the simulator only: ``mean =
    edge_service_s / mult``; ``None`` runs the ingress tier at the
    profile's edge speed, the deepest at its cloud speed and those between
    geometrically between.

    ``model`` names the architecture that prices a cost-modeled tier and
    ``mesh_shape`` the ``(data, model)`` device mesh it decodes over;
    :meth:`Topology.resolve_costs` then sets ``slots`` (KV rows that fit
    beside the sharded weights), ``decode_step_ms`` and
    ``service_rate_mult`` together.  ``decode_step_ms`` is an output of
    that resolution, never an input: a cost-modeled spec without it is
    unresolved, and neither deployment runs it."""

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
    # simulator only: service speed relative to the profile's edge time
    service_rate_mult: Optional[float] = None
    # cost model (None = hand-set capacity and rates)
    model: Optional[str] = None
    mesh_shape: Optional[Tuple[int, int]] = None
    decode_step_ms: Optional[float] = None

    def __post_init__(self):
        if self.mesh_shape is not None:
            if self.model is None:
                raise ValueError("mesh_shape requires model")
            if (len(self.mesh_shape) != 2
                    or any(int(a) <= 0 for a in self.mesh_shape)):
                raise ValueError(
                    f"mesh_shape must be two positive (data, model) dims, "
                    f"got {self.mesh_shape}")
        if self.decode_step_ms is not None:
            if self.model is None:
                raise ValueError("decode_step_ms requires model (it is an "
                                 "output of cost resolution, not an input)")
            if self.decode_step_ms <= 0:
                raise ValueError(
                    f"tier {self.name!r}: decode_step_ms must be > 0")
        if self.model is not None:
            # resolution sets both derived fields or neither
            if (self.service_rate_mult is None) != (self.decode_step_ms
                                                    is None):
                raise ValueError(
                    f"tier {self.name!r}: cost-modeled specs derive "
                    f"service_rate_mult and decode_step_ms together via "
                    f"Topology.resolve_costs(); set neither by hand")
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

    @property
    def cost_modeled(self) -> bool:
        """True when capacity and rates come from the cost model."""
        return self.model is not None

    @property
    def resolved(self) -> bool:
        """True when this spec is runnable: hand-set, or cost-derived."""
        return self.model is None or self.decode_step_ms is not None

    @property
    def devices(self) -> int:
        """Devices this tier's endpoint spans (the mesh's product)."""
        if self.mesh_shape is None:
            return 1
        return int(self.mesh_shape[0]) * int(self.mesh_shape[1])


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
            if t.service_rate_mult is not None and t.service_rate_mult <= 0:
                raise ValueError(
                    f"tier {t.name!r}: service_rate_mult must be > 0")
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

    @property
    def num_tiers(self) -> int:
        return len(self.tiers)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(t.name for t in self.tiers)

    def index(self, name: str) -> int:
        return self.names.index(name)

    def __len__(self) -> int:
        return len(self.tiers)

    def __iter__(self) -> Iterator[TierSpec]:
        return iter(self.tiers)

    def __repr__(self) -> str:
        return f"Topology({' -> '.join(self.names)}, waterfall={self.waterfall})"

    def resolve_costs(self, hw: Optional["Hardware"] = None) -> "Topology":
        """Resolve every cost-modeled tier on ``hw`` (default the H100
        SXM5 record): derived ``slots``, ``decode_step_ms`` and
        ``service_rate_mult`` from ``launch.tier_cost.resolve_specs``;
        hand-set specs pass through as they are.  Returns ``self`` when
        nothing needs resolving, else a new resolved Topology."""
        if all(t.resolved for t in self.tiers):
            return self
        from repro_torch.launch import tier_cost
        kw = {} if hw is None else {"hw": hw}
        return type(self)(tier_cost.resolve_specs(self.tiers, **kw),
                          links=self.links, waterfall=self.waterfall)

    @classmethod
    def costed(cls, tiers: Sequence[TierSpec],
               links: Optional[Sequence[LinkSpec]] = None,
               waterfall: bool = True,
               hw: Optional["Hardware"] = None) -> "Topology":
        """Build a chain and resolve its cost-modeled tiers in one step."""
        return cls(tiers, links=links,
                   waterfall=waterfall).resolve_costs(hw)

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

    @classmethod
    def device_edge_cloud(cls, device_slots: int = 2, edge_slots: int = 4,
                          cloud_slots: int = 64, max_len: int = 256,
                          autoscaling: Optional[AutoscalingPolicy] = None,
                          cost_model: bool = False,
                          hw: Optional["Hardware"] = None) -> "Topology":
        """The canonical 3-tier chain: on-device -> edge site -> cloud,
        waterfall on, over a 5 ms / 50 MB/s and a 40 ms / 100 MB/s link.

        By default the device runs at half the edge's speed (queue depth
        4), the edge at the profile's edge speed (depth 8), the elastic
        cloud at the profile default (unbounded).  With
        ``cost_model=True`` the tiers are priced on ``hw`` (default the
        H100 SXM5): stablelm-1.6b on the device, qwen2.5-14b on a (1, 2)
        edge mesh, llama3-405b on a (16, 16) cloud mesh; the requested
        slot counts become ceilings, clamped to what fits in HBM, and
        each hop down the chain serves a bigger, slower model."""
        if cost_model:
            return cls(
                tiers=(TierSpec("device", slots=device_slots,
                                max_len=max_len, autoscaling=autoscaling,
                                model="stablelm-1.6b", mesh_shape=(1, 1),
                                queue_depth_per_slot=4),
                       TierSpec("edge", slots=edge_slots, max_len=max_len,
                                autoscaling=autoscaling,
                                model="qwen2.5-14b", mesh_shape=(1, 2),
                                queue_depth_per_slot=8),
                       TierSpec("cloud", slots=cloud_slots, max_len=max_len,
                                autoscaling=autoscaling,
                                model="llama3-405b", mesh_shape=(16, 16),
                                queue_depth_per_slot=None)),
                links=(LinkSpec(rtt_s=0.005, bandwidth_Bps=50e6),
                       LinkSpec(rtt_s=0.04, bandwidth_Bps=100e6)),
                waterfall=True).resolve_costs(hw)
        return cls(
            tiers=(TierSpec("device", slots=device_slots, max_len=max_len,
                            autoscaling=autoscaling,
                            service_rate_mult=0.5, queue_depth_per_slot=4),
                   TierSpec("edge", slots=edge_slots, max_len=max_len,
                            autoscaling=autoscaling,
                            service_rate_mult=1.0, queue_depth_per_slot=8),
                   TierSpec("cloud", slots=cloud_slots, max_len=max_len,
                            autoscaling=autoscaling,
                            service_rate_mult=None,
                            queue_depth_per_slot=None)),
            links=(LinkSpec(rtt_s=0.005, bandwidth_Bps=50e6),
                   LinkSpec(rtt_s=0.04, bandwidth_Bps=100e6)),
            waterfall=True)


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
