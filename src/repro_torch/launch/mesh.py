"""Device meshes: the port's counterpart of ``repro/launch/mesh.py``.

A :class:`Mesh` is a record of ``torch.device``s in mesh order under
named axes.  The port is single-controller, as the reference is: one
Python process drives every device of a mesh, and a tensor-parallel
endpoint (``serving/sharded.py``) places each shard's parameters and KV
cache on its device.  Nothing in the record needs the devices to be
distinct; :func:`forced_devices` lets one device stand for several, the
counterpart of ``--xla_force_host_platform_device_count``.

``make_production_mesh`` is a function, not a module constant, so that
importing this module never touches a device.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

#: the device count :func:`forced_devices` reports, when set
_FORCED: contextvars.ContextVar[Optional[int]] = contextvars.ContextVar(
    "forced_devices", default=None)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Named mesh axes over devices: ``shape`` maps each axis name to its
    size, in ``axis_names`` order (as a ``jax`` mesh's does), and
    ``devices`` is an object array of ``torch.device`` of that shape."""

    shape: Dict[str, int]
    axis_names: Tuple[str, ...]
    devices: np.ndarray


def host_devices(kind: str = "cuda") -> List[torch.device]:
    """This host's devices of ``kind``: its cards (none without one), or
    the CPU.  Under :func:`forced_devices` the first of them, repeated."""
    if kind == "cuda":
        found = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
    elif kind == "cpu":
        found = [torch.device("cpu")]
    else:
        raise ValueError(f"unsupported device kind {kind!r}")
    n = _FORCED.get()
    if n is not None and found:
        return [found[0]] * n
    return found


@contextlib.contextmanager
def forced_devices(n: int) -> Iterator[None]:
    """Within the block, :func:`host_devices` reports its first device
    ``n`` times: ``n`` shards of a mesh then share one device.  A testing
    aid (the counterpart of ``--xla_force_host_platform_device_count``),
    never set on the serving path."""
    if n < 1:
        raise ValueError(f"forced_devices needs n >= 1, got {n}")
    token = _FORCED.set(int(n))
    try:
        yield
    finally:
        _FORCED.reset(token)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """A mesh of ``shape`` over the first ``prod(shape)`` of ``devices``
    (default: the host's cards); raises when there are fewer."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"rank")
    devices = list(host_devices("cuda") if devices is None else devices)
    need = math.prod(shape)
    if len(devices) < need:
        raise ValueError(f"mesh {tuple(shape)} over {tuple(axes)} needs "
                         f"{need} devices, got {len(devices)}")
    grid = np.empty(need, dtype=object)
    grid[:] = devices[:need]
    return Mesh(dict(zip(axes, (int(a) for a in shape))), tuple(axes),
                grid.reshape(shape))


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence[torch.device]] = None
                         ) -> Mesh:
    """The reference's serving meshes: (16, 16) over ("data", "model"),
    or (2, 16, 16) over ("pod", "data", "model"); raises unless the host
    (or ``devices``) has 256 or 512 devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def make_local_mesh(devices: Optional[Sequence[torch.device]] = None
                    ) -> Mesh:
    """A one-device mesh with the production axis names."""
    return make_mesh((1, 1), ("data", "model"), devices)
