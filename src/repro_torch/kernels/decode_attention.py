"""Launcher of kernel K2 (``csrc/decode_attention.cu``): flash-decode of one
query token per row against a rolling KV cache on a CUDA card.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py:189``.
The plain version of the same function is
:func:`repro_torch.kernels.ref.decode_attention`; callers go through
:func:`repro_torch.kernels.ops.decode_attention`, which picks this kernel
for CUDA tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, _checks

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _entry():
    lib = _build.load("decode_attention")
    fn = lib.repro_decode_attention
    if fn.argtypes is None:
        fn.argtypes = [_P] * 6 + [_I] * 7 + [_F, _F, _P]
        fn.restype = ctypes.c_int
    return lib, fn


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B,Hq,D); k/v: (B,T,Hkv,D); q_pos (B,), kv_pos (B,T) int32, all
    contiguous on one CUDA device.  Returns (B,Hq,D) in q.dtype.
    Launches on the current stream and does not synchronise."""
    what = "decode_attention"
    _checks.cuda_inputs(what, q, k, v, q_pos, kv_pos)
    dtype = _checks.float_inputs(what, q, k, v)
    _checks.positions(what, q_pos, kv_pos)
    B, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    _checks.heads(what, D, Hq, Hkv)
    if (k.shape != (B, T, Hkv, D) or v.shape != k.shape
            or q_pos.shape != (B,) or kv_pos.shape != (B, T)):
        raise ValueError(f"{what}: inconsistent shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"q_pos{tuple(q_pos.shape)} "
                         f"kv_pos{tuple(kv_pos.shape)}")
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: q/k/v must be 16-byte aligned for "
                             f"the kernel's vector loads")
    win, cap = _checks.mask_args(what, window, softcap)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib, fn = _entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
                 kv_pos.data_ptr(), out.data_ptr(), B, T, Hq, Hkv, D, dtype,
                 win, cap, float(D ** -0.5), stream)
    _build.check(lib, err, what)
    return out
