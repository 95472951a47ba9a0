"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device`` (default ``"cuda"``).
There is no fallback: asking for CUDA on a machine without a card
raises, and the CPU is used only when the caller passes
``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device]


def resolve(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises for an unavailable
    CUDA device instead of quietly running elsewhere."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def check_fits(cfg, device: torch.device, need: Optional[int] = None,
               what: str = "parameters") -> None:
    """Raise when ``need`` bytes (default: ``cfg``'s parameters) outgrow
    the card's memory (mixtral-8x7b at full width is 93.4 GB in bf16;
    the card has 80).  ``what`` names them in the message."""
    if device.type != "cuda":
        return
    if need is None:
        need = cfg.param_count() * torch.finfo(cfg.param_dtype).bits // 8
    have = torch.cuda.get_device_properties(device).total_memory
    if need > have:
        raise SystemExit(
            f"{cfg.name}: {need / 1e9:.2f} GB of {what} do not fit the "
            f"card's {have / 1e9:.2f} GB; use its smoke config instead")
