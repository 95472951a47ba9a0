"""Logical-axis sharding rules: the port's counterpart of
``repro/sharding.py:35-87``.

Parameters carry *logical* axis names ("embed", "heads", "ffn", "vocab",
...; ``ParamSpec.axes``).  An :class:`AxisRules` bound to a mesh maps
them to mesh axes, and :meth:`AxisRules.spec` gives one parameter's
partition spec: a tuple with one entry per dimension (a mesh axis name,
a tuple of them, or None for a replicated dimension), trailing Nones
dropped, as ``jax.sharding.PartitionSpec`` holds them.

The reference's in-graph activation constraints (``shd`` and its
thread-local rule contexts) have no counterpart: eager PyTorch has no
sharding constraint, and the tensor-parallel layer places every tensor
itself (``serving/sharded.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

MeshAxes = Union[None, str, Tuple[str, ...]]
#: one parameter's partition spec, entry by dimension
Spec = Tuple[MeshAxes, ...]


@dataclasses.dataclass(frozen=True, eq=False)
class AxisRules:
    """Logical-axis -> mesh-axis mapping bound to a mesh (anything with
    ``axis_names`` and a ``shape`` dict, as :class:`repro_torch.launch.
    mesh.Mesh`)."""

    mesh: Any
    map: Dict[str, MeshAxes]

    def spec(self, axes: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None) -> Spec:
        """The partition spec of a tuple of logical axis names.

        A mesh axis is used once per spec (a later dimension loses it).
        Given ``shape``, the mesh axes whose product does not divide a
        dimension are dropped, trailing first, so 8 kv heads on a 16-way
        "model" axis stay replicated instead of making an invalid spec.
        """
        entries = []
        used: set = set()
        for i, ax in enumerate(axes):
            m = self.map.get(ax) if ax is not None else None
            if m is None:
                entries.append(None)
                continue
            ms = (m,) if isinstance(m, str) else tuple(m)
            ms = tuple(a for a in ms
                       if a not in used and a in self.mesh.axis_names)
            if shape is not None:
                while ms and shape[i] % math.prod(
                        self.mesh.shape[a] for a in ms):
                    ms = ms[:-1]
            used.update(ms)
            if not ms:
                entries.append(None)
            elif len(ms) == 1:
                entries.append(ms[0])
            else:
                entries.append(ms)
        while entries and entries[-1] is None:
            entries.pop()
        return tuple(entries)
