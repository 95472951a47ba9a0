"""Roofline terms of one step on one device, and the hardware they use.

The port's counterpart of ``Roofline`` in ``repro/launch/hlo_analysis.py``
(the same terms, the same arithmetic), with its constants taken from a
:class:`Hardware` record instead of module constants.  The port's only
record is :data:`H100_SXM5`.

Per device:

    compute    = tensor-core FLOPs / peak + other FLOPs / vector rate
    memory     = HBM bytes / HBM bandwidth
    collective = interconnect wire bytes / link bandwidth
    step       = max of the three (they overlap)
"""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class Hardware:
    """The rates and memory of one device that the roofline divides by."""

    name: str
    #: dense tensor-core FLOP/s in the compute dtype (bf16)
    peak_flops: float
    #: FLOP/s of the elementwise work outside the tensor cores (fp32)
    vector_flops: float
    #: HBM bytes/s
    hbm_bw: float
    #: interconnect bytes/s per direction per device
    link_bw: float
    #: HBM bytes per device
    hbm_bytes: float


#: NVIDIA H100 SXM5 80 GB at its 700 W power limit, from NVIDIA's data
#: sheet (SXM part, dense rates without sparsity): 989 TFLOP/s bf16 on the
#: tensor cores, 67 TFLOP/s float32 outside them, 3.35 TB/s of HBM3,
#: NVLink 4 at 900 GB/s per GPU (450 GB/s each way) and 80 GB of HBM.  A
#: card set below 700 W runs slower than these under load.
H100_SXM5 = Hardware(
    name="NVIDIA H100 SXM5 80GB, 700 W",
    peak_flops=989e12,
    vector_flops=67e12,
    hbm_bw=3.35e12,
    link_bw=450e9,
    hbm_bytes=80e9,
)


@dataclasses.dataclass
class Roofline:
    """Per-device roofline terms (seconds) for one step on ``hw``."""

    flops_per_device: float              # total (tensor core + vector)
    bytes_per_device: float
    collective_bytes_per_device: float
    chips: int
    mxu_flops_per_device: float = 0.0    # the tensor-core share
    hw: Hardware = H100_SXM5

    @property
    def compute_s(self) -> float:
        """Tensor-core time + vector time (elementwise work)."""
        mxu = self.mxu_flops_per_device or self.flops_per_device
        vpu = max(self.flops_per_device - mxu, 0.0)
        return mxu / self.hw.peak_flops + vpu / self.hw.vector_flops

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / self.hw.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / self.hw.link_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Lower-bound step time = max of the three overlapped terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_dict(self) -> Dict[str, float]:
        return {
            "flops_per_device": self.flops_per_device,
            "mxu_flops_per_device": self.mxu_flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "step_s": self.step_s,
        }
