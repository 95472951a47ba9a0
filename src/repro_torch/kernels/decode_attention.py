"""Launchers of kernels K2 and K3 (``csrc/decode_attention.cu``):
flash-decode of one query token per row against a rolling KV cache (K2)
or a paged KV pool read through page tables (K3), on a CUDA card.

Each (row, kv head, chunk of query heads) is a unit of work whose slots
the kernel splits over a thread-block cluster; :func:`split` chooses the
cluster size and the slots each block takes, from the shapes alone, so
K3 on a pool and K2 on the gathered view split alike and stay bitwise
equal.

K2 replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py:189``
and K3 ``repro/kernels/decode_attention.py:132``; both share one CUDA
body.  The plain versions of the same functions are
:func:`repro_torch.kernels.ref.decode_attention` and
:func:`repro_torch.kernels.ref.paged_decode_attention`; callers go
through :mod:`repro_torch.kernels.ops`, which picks these kernels for
CUDA tensors.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build, _checks

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _entry(name: str, argtypes):
    lib = _build.load("decode_attention")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, fn


#: blocks a launch aims for: two on each of an H100's 132 SMs
TARGET_BLOCKS = 2 * 132
#: the largest cluster (the portable limit) and the fewest slots a block
#: of a split keeps
MAX_CLUSTER, MIN_SPAN = 8, 128
#: split boundaries are multiples of this many slots: of every kernel step
#: (8 to 64 slots) and of the page sizes 16, 32 and 64
SPAN_UNIT = 64

#: entry point -> the (C, span) its last launch ran with
last_split: Dict[str, Tuple[int, int]] = {}


def head_chunks(Hq: int, Hkv: int) -> int:
    """Chunks of query heads per kv head: a block serves up to 8 of the
    G query heads of one kv head."""
    return -(-(Hq // Hkv) // 8)


def split(B: int, Hkv: int, chunks: int, T: int) -> Tuple[int, int]:
    """(C, span): each unit of work's T slots go to a cluster of C blocks
    (1, 2, 4 or 8), block r taking slots [r*span, (r+1)*span).  C is the
    smallest that puts ``TARGET_BLOCKS`` blocks on the card while a block
    keeps at least ``MIN_SPAN`` slots; span is ceil(T/C) rounded up to
    ``SPAN_UNIT``."""
    units = B * Hkv * chunks
    C = 1
    while (C < MAX_CLUSTER and units * C < TARGET_BLOCKS
           and T >= 2 * C * MIN_SPAN):
        C *= 2
    span = -(-max(T, 1) // C)
    return C, -(-span // SPAN_UNIT) * SPAN_UNIT


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
    _checks.aligned16(what, q, k, v)
    win, cap = _checks.mask_args(what, window, softcap)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    C, span = split(B, Hkv, head_chunks(Hq, Hkv), T)
    lib, fn = _entry("repro_decode_attention",
                     [_P] * 6 + [_I] * 7 + [_F, _F, _I, _I, _P])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
                 kv_pos.data_ptr(), out.data_ptr(), B, T, Hq, Hkv, D, dtype,
                 win, cap, float(D ** -0.5), C, span, stream)
    _build.check(lib, err, what)
    last_split[what] = (C, span)
    return out


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_tables: torch.Tensor,
                           q_pos: torch.Tensor, kv_pos_pages: torch.Tensor,
                           *, window: Optional[int] = None,
                           softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B,Hq,D); k_pages/v_pages: (P+1,page,Hkv,D); page_tables (B,ppr)
    int32; q_pos (B,), kv_pos_pages (P+1,page) int32, all contiguous on
    one CUDA device.  Every page id must lie in [0, P] (not checked on
    the device).  Returns (B,Hq,D) in q.dtype.  Launches on the current
    stream and does not synchronise."""
    what = "paged_decode_attention"
    _checks.cuda_inputs(what, q, k_pages, v_pages, page_tables, q_pos,
                        kv_pos_pages)
    dtype = _checks.float_inputs(what, q, k_pages, v_pages)
    _checks.positions(what, q_pos, kv_pos_pages)
    if page_tables.dtype != torch.int32:
        raise ValueError(f"{what}: page_tables must be int32, "
                         f"got {page_tables.dtype}")
    B, Hq, D = q.shape
    P1, page, Hkv = k_pages.shape[:3]
    _checks.heads(what, D, Hq, Hkv)
    if (k_pages.shape != (P1, page, Hkv, D) or v_pages.shape != k_pages.shape
            or page_tables.dim() != 2 or page_tables.shape[0] != B
            or q_pos.shape != (B,) or kv_pos_pages.shape != (P1, page)):
        raise ValueError(f"{what}: inconsistent shapes q{tuple(q.shape)} "
                         f"k_pages{tuple(k_pages.shape)} "
                         f"v_pages{tuple(v_pages.shape)} "
                         f"page_tables{tuple(page_tables.shape)} "
                         f"q_pos{tuple(q_pos.shape)} "
                         f"kv_pos_pages{tuple(kv_pos_pages.shape)}")
    ppr = page_tables.shape[1]
    _checks.aligned16(what, q, k_pages, v_pages)
    win, cap = _checks.mask_args(what, window, softcap)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    C, span = split(B, Hkv, head_chunks(Hq, Hkv), ppr * page)
    lib, fn = _entry("repro_paged_decode_attention",
                     [_P] * 7 + [_I] * 8 + [_F, _F, _I, _I, _P])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 page_tables.data_ptr(), q_pos.data_ptr(),
                 kv_pos_pages.data_ptr(), out.data_ptr(), B, ppr, page, Hq,
                 Hkv, D, dtype, win, cap, float(D ** -0.5), C, span, stream)
    _build.check(lib, err, what)
    last_split[what] = (C, span)
    return out
