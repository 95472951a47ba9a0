"""Launcher of kernel K1 (``csrc/flash_attention.cu``): flash attention for
prefill on a CUDA card.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py:84``.
bfloat16 runs on the tensor cores (wgmma, with TMA copies that need
16-byte aligned q/k/v); float32 keeps a CUDA-core body.
The plain version of the same function is
:func:`repro_torch.kernels.ref.flash_attention`; callers go through
:func:`repro_torch.kernels.ops.flash_attention`, which picks this kernel
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
    lib = _build.load("flash_attention")
    fn = lib.repro_flash_attention
    if fn.argtypes is None:
        fn.argtypes = [_P] * 6 + [_I] * 9 + [_F, _F, _P]
        fn.restype = ctypes.c_int
    return lib, fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B,S,Hq,D); k/v: (B,T,Hkv,D); q_pos (B,S), kv_pos (B,T) int32,
    all contiguous on one CUDA device.  Returns (B,S,Hq,D) in q.dtype.
    Launches on the current stream and does not synchronise."""
    what = "flash_attention"
    _checks.cuda_inputs(what, q, k, v, q_pos, kv_pos)
    dtype = _checks.float_inputs(what, q, k, v)
    _checks.positions(what, q_pos, kv_pos)
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    _checks.heads(what, D, Hq, Hkv)
    if (k.shape != (B, T, Hkv, D) or v.shape != k.shape
            or q_pos.shape != (B, S) or kv_pos.shape != (B, T)):
        raise ValueError(f"{what}: inconsistent shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"q_pos{tuple(q_pos.shape)} "
                         f"kv_pos{tuple(kv_pos.shape)}")
    if q.dtype == torch.bfloat16:
        _checks.aligned16(what, q, k, v)
    win, cap = _checks.mask_args(what, window, softcap)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib, fn = _entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
                 kv_pos.data_ptr(), out.data_ptr(), B, S, T, Hq, Hkv, D,
                 dtype, int(bool(causal)), win, cap, float(D ** -0.5),
                 stream)
    _build.check(lib, err, what)
    return out
