"""Launcher of kernel K4 (``csrc/rwkv6_scan.cu``): the WKV6 scan with
data-dependent decay on a CUDA card.

Replaces the Pallas TPU kernel ``repro/kernels/rwkv6_scan.py:87``.  The
plain version of the same function is
:func:`repro_torch.kernels.ref.rwkv6_scan`; callers go through
:func:`repro_torch.kernels.ops.rwkv6_scan`, which applies the reference's
length rule and picks this kernel for CUDA tensors.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build, _checks

_P = ctypes.c_void_p
_I = ctypes.c_int

#: the head dims the kernel is instantiated for
HEAD_DIMS = (8, 16, 32, 64)


def _entry():
    lib = _build.load("rwkv6_scan")
    fn = lib.repro_rwkv6_scan
    if fn.argtypes is None:
        fn.argtypes = [_P] * 8 + [_I] * 4 + [_P]
        fn.restype = ctypes.c_int
    return lib, fn


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               lw: torch.Tensor, u: torch.Tensor,
               s0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, lw: (B,S,H,D); u: (H,D); s0: (B,H,D,D); all float32,
    contiguous and 16-byte aligned on one CUDA device, D in
    :data:`HEAD_DIMS`.  Returns (y (B,S,H,D), s_final (B,H,D,D)), float32.
    Launches on the current stream and does not synchronise."""
    what = "rwkv6_scan"
    ins = (r, k, v, lw, u, s0)
    _checks.cuda_inputs(what, *ins)
    if any(t.dtype != torch.float32 for t in ins):
        raise ValueError(f"{what}: r/k/v/lw/u/s0 must be float32, got "
                         f"{[str(t.dtype) for t in ins]}")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, lw)) or \
            u.shape != r.shape[2:] or \
            s0.shape != (r.shape[0], *r.shape[2:], r.shape[3]):
        raise ValueError(f"{what}: inconsistent shapes r{tuple(r.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"lw{tuple(lw.shape)} u{tuple(u.shape)} "
                         f"s0{tuple(s0.shape)}")
    B, S, H, D = r.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {D} not in {HEAD_DIMS}")
    if any(t.data_ptr() % 16 for t in ins):
        raise ValueError(f"{what}: inputs must be 16-byte aligned")
    y = torch.empty_like(r)
    s_final = torch.empty_like(s0)
    if B * H == 0:
        return y, s_final
    lib, fn = _entry()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(*(t.data_ptr() for t in ins), y.data_ptr(),
                 s_final.data_ptr(), B, S, H, D, stream)
    _build.check(lib, err, what)
    return y, s_final
