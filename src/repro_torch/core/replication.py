"""Cloud-to-Edge replication with selective field merge (paper §3.3.1).

The port's own copy of ``repro/core/replication.py`` (the port imports
nothing of the reference package).

The paper's Knative Edge controller mirrors Knative Service definitions from
the cloud cluster into each edge cluster. The naive mirror triggers a
reconcile feedback loop (edge controller reacts to its own writes); the
paper's fix is a *selective* merge: copy only the cloud-owned subset of
fields, preserve the edge-local state and non-owned annotations, and write
only when the merged definition actually differs.

Here a "Knative Service" becomes a :class:`FunctionSpec` — a deployable model
endpoint (architecture config + revision + autoscaling bounds). The merge is
a pure function, which turns the paper's anti-feedback-loop argument into two
testable invariants:

  idempotence:      merge(merge(e, c), c) == merge(e, c)
  edge-ownership:   merge(e, c) preserves every edge-owned field of e

This module is the control-plane object model.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, Mapping, Optional, Tuple

EDGE_ANNOTATION_PREFIX = "edge.repro.dev/"


@dataclasses.dataclass(frozen=True)
class AutoscalingPolicy:
    """Knative KPA-shaped bounds, per function."""
    min_scale: int = 0                 # 0 => scale-to-zero allowed
    max_scale: int = 4
    target_concurrency: float = 4.0    # requests in flight per instance
    panic_threshold: float = 2.0       # panic if short-window load > this x target
    scale_to_zero_grace_s: float = 30.0


@dataclasses.dataclass(frozen=True)
class FunctionSpec:
    """Cloud-owned definition of a serverless function (model endpoint)."""
    name: str
    arch: str                          # key into the architecture registry
    revision: int = 1
    checkpoint_ref: str = ""           # content address of the weights
    autoscaling: AutoscalingPolicy = dataclasses.field(default_factory=AutoscalingPolicy)
    env: Mapping[str, str] = dataclasses.field(default_factory=dict)
    # annotations are split by ownership: cloud writes plain keys, the edge
    # runtime writes keys under EDGE_ANNOTATION_PREFIX.
    annotations: Mapping[str, str] = dataclasses.field(default_factory=dict)

    def spec_hash(self) -> str:
        """Stable content hash of the cloud-owned fields only."""
        payload = {
            "name": self.name,
            "arch": self.arch,
            "revision": self.revision,
            "checkpoint_ref": self.checkpoint_ref,
            "autoscaling": dataclasses.asdict(self.autoscaling),
            "env": dict(sorted(self.env.items())),
            "annotations": {k: v for k, v in sorted(self.annotations.items())
                            if not k.startswith(EDGE_ANNOTATION_PREFIX)},
        }
        blob = json.dumps(payload, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()


@dataclasses.dataclass(frozen=True)
class EdgeServiceState:
    """The edge cluster's view of a function: replicated spec + edge-owned state."""
    spec: FunctionSpec
    # --- edge-owned, never overwritten by replication -----------------
    ready_instances: int = 0
    traffic_pct_to_cloud: float = 0.0      # written by the offload controller
    last_seen_revision: int = 0
    edge_annotations: Mapping[str, str] = dataclasses.field(default_factory=dict)
    status: str = "Unknown"                # Ready | NotReady | Unknown

    def with_spec(self, spec: FunctionSpec) -> "EdgeServiceState":
        return dataclasses.replace(self, spec=spec,
                                   last_seen_revision=spec.revision)


def merge(edge: EdgeServiceState, cloud: FunctionSpec) -> Tuple[EdgeServiceState, bool]:
    """Selective-field merge (paper §3.3.1).

    Copies the current edge definition and overwrites only the cloud-owned
    subset of fields; edge-owned state and ``edge.repro.dev/`` annotations
    persist. Returns ``(new_state, changed)`` — ``changed`` is False when
    the merged spec hash equals the current one, in which case the caller
    must NOT redeploy (this break in the write cycle is what kills the
    feedback loop).
    """
    # Preserve edge-prefixed annotations from the *edge* copy, take the rest
    # from the cloud definition.
    edge_ann = {k: v for k, v in edge.spec.annotations.items()
                if k.startswith(EDGE_ANNOTATION_PREFIX)}
    cloud_ann = {k: v for k, v in cloud.annotations.items()
                 if not k.startswith(EDGE_ANNOTATION_PREFIX)}
    merged_spec = dataclasses.replace(
        cloud, annotations={**cloud_ann, **edge_ann})
    changed = merged_spec.spec_hash() != edge.spec.spec_hash()
    if not changed:
        return edge, False
    return edge.with_spec(merged_spec), True


class ReplicationController:
    """Watches a cloud registry of FunctionSpecs and reconciles edge state.

    A deliberately small, deterministic reconciler: one ``reconcile`` call
    folds the current cloud view into the edge view and reports which
    functions actually redeployed. ``writes`` counts edge deployments — the
    paper's feedback-loop bug would show up as ``writes`` growing without
    cloud-side changes; tests pin it to zero in steady state.
    """

    def __init__(self) -> None:
        self.edge: Dict[str, EdgeServiceState] = {}
        self.writes = 0
        self.reconciles = 0

    def reconcile(self, cloud_view: Mapping[str, FunctionSpec]) -> Dict[str, bool]:
        self.reconciles += 1
        out: Dict[str, bool] = {}
        # Create/update
        for name, spec in cloud_view.items():
            cur = self.edge.get(name)
            if cur is None:
                self.edge[name] = EdgeServiceState(spec=spec,
                                                   last_seen_revision=spec.revision)
                self.writes += 1
                out[name] = True
                continue
            merged, changed = merge(cur, spec)
            if changed:
                self.edge[name] = merged
                self.writes += 1
            out[name] = changed
        # Garbage-collect deleted functions.
        for name in list(self.edge):
            if name not in cloud_view:
                del self.edge[name]
                self.writes += 1
                out[name] = True
        return out

    def set_edge_state(self, name: str, **fields: Any) -> None:
        """Edge-runtime writes (offload pct, readiness) — never replicated."""
        self.edge[name] = dataclasses.replace(self.edge[name], **fields)

    def get(self, name: str) -> Optional[EdgeServiceState]:
        return self.edge.get(name)
