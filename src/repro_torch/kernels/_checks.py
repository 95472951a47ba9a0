"""Argument checks shared by the CUDA kernel launchers: the kernels take
only what is validated here (device, dtype, shape, contiguity)."""

from __future__ import annotations

from typing import Optional

import torch

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)


def cuda_inputs(what: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: every input must be on one CUDA "
                             f"device, got {[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")


def float_inputs(what: str, q, k, v) -> int:
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{what}: q/k/v must share float32 or bfloat16, "
                         f"got {q.dtype}/{k.dtype}/{v.dtype}")
    return DTYPES[q.dtype]


def aligned16(what: str, *tensors: torch.Tensor) -> None:
    """The kernels read q/k/v with 16-byte vector loads or TMA copies."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: q/k/v must be 16-byte aligned for "
                             f"the kernel's vector loads and TMA copies")


def positions(what: str, *pos: torch.Tensor) -> None:
    for p in pos:
        if p.dtype != torch.int32:
            raise ValueError(f"{what}: positions must be int32, "
                             f"got {p.dtype}")


def heads(what: str, D: int, Hq: int, Hkv: int) -> None:
    if D not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {D} not in {HEAD_DIMS}")
    if Hkv <= 0 or Hq % Hkv:
        raise ValueError(f"{what}: {Hq} query heads do not divide over "
                         f"{Hkv} kv heads")


def mask_args(what: str, window: Optional[int],
              softcap: Optional[float]) -> tuple:
    """(window, softcap) as the kernels take them: -1 and 0.0 for None."""
    if window is not None and window < 0:
        raise ValueError(f"{what}: window must be >= 0, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"{what}: softcap must be > 0, got {softcap}")
    return (-1 if window is None else int(window),
            0.0 if softcap is None else float(softcap))
