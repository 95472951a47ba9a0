"""The paper's four FaaS workloads as PyTorch function bodies.

§4.1: "matrix multiplication (MatMult), image processing (Image Proc.),
random I/O, and a combination of these three loads (Mixed)".  The port's
counterpart of ``repro/core/workloads.py``: each body is split into its
draws and a pure function of the drawn tensors, so a test can feed the
arrays the reference's ``jax.random`` drew:

    matmult_body(a, b)          a, b: (n, n) standard normal
    image_proc_body(img)        img: (1, 3, hw, hw) uniform, NCHW
    random_io_body(idx, n)      idx: (n // 4,) ints in [0, n)
    mixed_body(a, b, img, idx)  one of each, summed

``matmult(n)`` and friends draw from a ``torch.Generator`` on the device
(``device="cuda"`` by default) and run the body there.  ``PROFILES`` keeps
the reference's simulator constants unchanged: they are the paper's
calibration, not measurements of any card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve


def matmult_body(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense matmul chain — compute-bound: ``tanh((a @ b) @ b.T).mean()``."""
    c = a @ b
    c = c @ b.T
    return torch.tanh(c).mean()


def _blur_weight(dtype, device) -> torch.Tensor:
    """The reference's 5x1 binomial blur, ``broadcast_to((5, 1, 3, 3))``
    in HWIO: every (out, in) channel pair carries the same kernel, so each
    output channel sums all three blurred inputs (not depthwise).  OIHW."""
    k = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], dtype=dtype, device=device)
    k = k / k.sum()
    return k.reshape(1, 1, 5, 1).expand(3, 3, 5, 1).contiguous()


def _sobel_weight(dtype, device) -> torch.Tensor:
    """The reference's horizontal Sobel kernel on every (out, in) channel
    pair (``broadcast_to((3, 3, 3, 3))`` in HWIO), as OIHW."""
    sob = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0],
                        [-1.0, 0.0, 1.0]], dtype=dtype, device=device)
    return sob.reshape(1, 1, 3, 3).expand(3, 3, 3, 3).contiguous()


def image_proc_body(img: torch.Tensor) -> torch.Tensor:
    """Blur + Sobel + normalize over a (1, 3, hw, hw) image — memory-bound.
    "SAME" padding: 2 rows each side for the 5x1 blur, 1 all round for
    the 3x3 Sobel (both cross-correlations, as ``conv_general_dilated``).
    ``std`` is the population one (``jnp.std``)."""
    blur = F.conv2d(img, _blur_weight(img.dtype, img.device), padding=(2, 0))
    edges = F.conv2d(blur, _sobel_weight(img.dtype, img.device), padding=1)
    return (edges - edges.mean()).std(correction=0)


def random_io_body(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Random gather/scatter over an ``n``-float buffer — a latency/IO
    stand-in.  The reference's ``.at[].add`` is ``index_add_`` here; with
    duplicate indices the scattered values land in another order, but
    every value is a multiple of 0.5 below 2**23, so the buffer is exact
    either way and only the final float32 sum's order differs."""
    buf = torch.arange(n, dtype=torch.float32, device=idx.device)
    idx = idx.long()
    vals = buf[idx]
    buf.index_add_(0, (idx * 7919) % n, vals * 0.5)
    return buf.sum()


def mixed_body(a: torch.Tensor, b: torch.Tensor, img: torch.Tensor,
               idx: torch.Tensor) -> torch.Tensor:
    """The paper's combined load: one of each body, summed (``a``/``b``
    and ``img`` at ``scale``, ``idx`` over ``scale**2`` floats)."""
    scale = a.shape[0]
    return (matmult_body(a, b) + image_proc_body(img)
            + random_io_body(idx, scale * scale))


def _gen(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def draw_matmult(n: int, g: torch.Generator, device: torch.device):
    return (torch.randn((n, n), generator=g, device=device),
            torch.randn((n, n), generator=g, device=device))


def draw_image(hw: int, g: torch.Generator, device: torch.device):
    return torch.rand((1, 3, hw, hw), generator=g, device=device)


def draw_io(n: int, g: torch.Generator, device: torch.device):
    return torch.randint(0, n, (n // 4,), generator=g, device=device)


def matmult(n: int = 256, seed: int = 0,
            device: DeviceLike = "cuda") -> torch.Tensor:
    dev = resolve(device)
    return matmult_body(*draw_matmult(n, _gen(seed, dev), dev))


def image_proc(hw: int = 128, seed: int = 0,
               device: DeviceLike = "cuda") -> torch.Tensor:
    dev = resolve(device)
    return image_proc_body(draw_image(hw, _gen(seed, dev), dev))


def random_io(n: int = 1 << 16, seed: int = 0,
              device: DeviceLike = "cuda") -> torch.Tensor:
    dev = resolve(device)
    return random_io_body(draw_io(n, _gen(seed, dev), dev), n)


def mixed(scale: int = 128, seed: int = 0,
          device: DeviceLike = "cuda") -> torch.Tensor:
    dev = resolve(device)
    g = _gen(seed, dev)
    a, b = draw_matmult(scale, g, dev)
    return mixed_body(a, b, draw_image(scale, g, dev),
                      draw_io(scale * scale, g, dev))


@dataclasses.dataclass(frozen=True)
class WorkloadProfile:
    """Simulator constants for one workload (per-tier service model):
    mean single-slot service time at the edge and in the cloud, the
    request+response bytes a down-chain crossing moves, the per-request
    resident memory at the ingress tier, and the service-time CV."""
    name: str
    fn: Optional[Callable]
    edge_service_s: float
    cloud_service_s: float
    payload_bytes: float
    mem_mb: float
    cv: float = 0.10


# The reference's calibration (repro/core/workloads.py), unchanged.
PROFILES: Dict[str, WorkloadProfile] = {
    "matmult": WorkloadProfile("matmult", matmult,
                               edge_service_s=0.85, cloud_service_s=0.10,
                               payload_bytes=6.0e6, mem_mb=96.0),
    "image_proc": WorkloadProfile("image_proc", image_proc,
                                  edge_service_s=0.55, cloud_service_s=0.08,
                                  payload_bytes=2.5e6, mem_mb=48.0),
    "io": WorkloadProfile("io", random_io,
                          edge_service_s=0.40, cloud_service_s=0.06,
                          payload_bytes=2.0e5, mem_mb=16.0),
    "mixed": WorkloadProfile("mixed", mixed,
                             edge_service_s=0.60, cloud_service_s=0.08,
                             payload_bytes=2.9e6, mem_mb=56.0),
}
