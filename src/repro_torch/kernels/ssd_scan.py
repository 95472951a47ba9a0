"""Launcher of kernel K5 (``csrc/ssd_scan.cu``): the selective-SSM
diagonal scan h_t = a_t*h_{t-1} + b_t on a CUDA card.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py:58``.  The
plain version of the same function is
:func:`repro_torch.kernels.ref.ssd_scan`; callers go through
:func:`repro_torch.kernels.ops.ssd_scan`, which applies the reference's
length rule and picks this kernel for CUDA tensors.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build, _checks

_P = ctypes.c_void_p
_I = ctypes.c_int


def _entry():
    lib = _build.load("ssd_scan")
    fn = lib.repro_ssd_scan
    if fn.argtypes is None:
        fn.argtypes = [_P] * 5 + [_I] * 4 + [_P]
        fn.restype = ctypes.c_int
    return lib, fn


def ssd_scan(a: torch.Tensor, b: torch.Tensor,
             h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, b: (B,S,I,N); h0: (B,I,N); all float32 and contiguous on one
    CUDA device.  Returns (hs (B,S,I,N), h_final (B,I,N)), float32.
    Launches on the current stream and does not synchronise."""
    what = "ssd_scan"
    _checks.cuda_inputs(what, a, b, h0)
    if any(t.dtype != torch.float32 for t in (a, b, h0)):
        raise ValueError(f"{what}: a/b/h0 must be float32, got "
                         f"{a.dtype}/{b.dtype}/{h0.dtype}")
    if a.dim() != 4 or b.shape != a.shape or \
            h0.shape != (a.shape[0], *a.shape[2:]):
        raise ValueError(f"{what}: inconsistent shapes a{tuple(a.shape)} "
                         f"b{tuple(b.shape)} h0{tuple(h0.shape)}")
    B, S, I, N = a.shape
    hs = torch.empty_like(a)
    h_final = torch.empty_like(h0)
    if h0.numel() == 0:
        return hs, h_final
    lib, fn = _entry()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), h0.data_ptr(), hs.data_ptr(),
                 h_final.data_ptr(), B, S, I, N, stream)
    _build.check(lib, err, what)
    return hs, h_final
