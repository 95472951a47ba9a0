"""XLA:CPU's float32 rounding, reproduced on host tensors.

The reference's control plane runs as jitted XLA programs on the CPU,
and the port's controller must give the same R_t bit for bit (so that a
simulated run stands for a live one, and both for the reference).  XLA's
CPU code differs from eager PyTorch in four ways, each reproduced here
once and shared by ``core/offload.py`` and ``core/quantile.py``:

* **fused multiply-adds**: LLVM contracts ``a*b + c`` inside a fused
  kernel; :func:`_fma` rounds once (a float32 product is exact in
  float64, so ``(a*b + c)`` rounded to float32 is the FMA);
* **flushed subnormals** (:func:`_ftz`);
* **its own ``log`` and ``exp``** (:func:`_xla_log`, :func:`_xla_exp`):
  the Cephes/Eigen polynomials XLA emits, not libm's.  ``torch.log``
  differs on about 4 % of float32 inputs by an ulp, ``torch.exp`` on 10 %;
* **summation orders**: reductions add in index order from 0
  (:func:`_seq_sum`), and a small ``x @ triu(ones)`` prefix product runs
  through Eigen's kernel, which keeps four partial sums over ``k mod 4``
  (:func:`_triu_dot`).

Where the constants and the contraction points come from: the reference's
``offload_update_rows_stream_jit`` (and ``jnp.log`` / ``jnp.exp`` alone)
run under ``XLA_FLAGS=--xla_dump_to=<dir>`` with jax 0.9.0, then read off
the ``*.ir-with-opt.ll`` files of its kernels.  The optimized IR has the
plain ``fmul``/``fadd`` chain with the constants below (LLVM hex doubles
of float32 values); which pairs the backend fuses was settled by
matching XLA's result on every float32 of the ranges the sketch feeds
(``log`` on [1e-30, 1e4], ``exp`` on [-10, 8]) — the fused pairs are the
ones named at each step.  A later jax whose results differ should first
be checked against this list.
"""

from __future__ import annotations

import numpy as np
import torch

_FLT_MIN = float(np.finfo(np.float32).tiny)


def _f32(bits: str) -> torch.Tensor:
    """A float32 constant from the IR's spelling: the bits of the double
    that holds it, in hex."""
    return torch.tensor(np.uint64(int(bits, 16)).view(np.float64),
                        dtype=torch.float32)


def _ftz(x: torch.Tensor) -> torch.Tensor:
    """Flush float32 subnormals to zero, as XLA's CPU code does (R_t
    decaying by ``c_in`` every idle interval reaches them)."""
    return torch.where(x.abs() < _FLT_MIN, torch.zeros_like(x), x)


def _fma(a, b, c) -> torch.Tensor:
    """float32 ``a*b + c`` with one rounding, as a fused multiply-add:
    the float32 product is exact in float64, so only the sum rounds (a
    second rounding to float32 could differ from a true FMA only on an
    exact float32 tie after the float64 sum, which these inputs do not
    reach in practice); subnormal results flush to zero."""
    a, b, c = (torch.as_tensor(v, dtype=torch.float32) for v in (a, b, c))
    return _ftz((a.double() * b.double() + c.double()).float())


# Eigen's plog_float (Cephes logf): mantissa split at sqrt(1/2), three
# interleaved Horner chains.
_LOG_SQRTHF = _f32("0x3FE6A09E60000000")
_LOG_P = [_f32(h) for h in (
    "0x3FB2043760000000", "0xBFBD7A3700000000", "0x3FBDE4A340000000",
    "0xBFBFCBA9E0000000", "0x3FC23D37E0000000", "0xBFC555CA00000000",
    "0x3FC999D580000000", "0xBFCFFFFF80000000", "0x3FD5555540000000")]
_LOG_Q1 = _f32("0xBF2BD01060000000")       # -2.12194440e-4
_LOG_Q2 = _f32("0x3FE6300000000000")       # 0.693359375


def _xla_log(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log, bitwise XLA:CPU's ``log``.

    Fused pairs: the three chains' ``p*x + q`` steps, the two
    ``y*x^3 + y_k`` combines, and ``y*x^3 + q1*e`` with ``q1*e`` rounded
    first; ``x - 0.5*x^2`` and ``+ q2*e`` are exact either way.  x <= 0
    or NaN gives NaN, 0 (and a subnormal, read as 0) gives -inf, inf
    gives inf."""
    x = _ftz(torch.as_tensor(x, dtype=torch.float32))
    one = torch.ones((), dtype=torch.float32)
    xc = torch.where(x > _FLT_MIN, x, torch.full_like(x, _FLT_MIN))
    bits = xc.view(torch.int32)
    e = ((bits >> 23) - 127).float() + one
    m = ((bits & -2139095041) | 1056964608).view(torch.float32)
    small = m < _LOG_SQRTHF
    xm = (m - one) + torch.where(small, m, torch.zeros_like(m))
    e = e - small.float()
    x2 = xm * xm
    x3 = x2 * xm
    p = _LOG_P
    y = _fma(xm, p[0], p[1])
    y1 = _fma(xm, p[3], p[4])
    y2 = _fma(xm, p[6], p[7])
    y = _fma(y, xm, p[2])
    y1 = _fma(y1, xm, p[5])
    y2 = _fma(y2, xm, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, _LOG_Q1 * e)
    out = ((xm - 0.5 * x2) + y) + _LOG_Q2 * e
    out = torch.where((x < 0) | torch.isnan(x),
                      torch.full_like(x, float("nan")), out)
    out = torch.where(x == 0, torch.full_like(x, float("-inf")), out)
    return torch.where(torch.isinf(x) & (x > 0), x, out)


# Eigen's pexp_float (Cephes expf): range reduction by ln 2 in two parts.
_EXP_LO = _f32("0xC055F33340000000")       # -87.8
_EXP_HI = _f32("0x4056333340000000")       # 88.8
_EXP_LOG2E = _f32("0x3FF7154760000000")
_EXP_C1 = _f32("0x3FE6300000000000")       # 0.693359375
_EXP_C2 = _f32("0xBF2BD01060000000")       # -2.12194440e-4
_EXP_P = [_f32(h) for h in (
    "0x3F2A0D2CE0000000", "0x3F56E879C0000000", "0x3F81112100000000",
    "0x3FA5553820000000", "0x3FC5555540000000")]


def _xla_exp(x: torch.Tensor) -> torch.Tensor:
    """float32 exp, bitwise XLA:CPU's ``exp``.

    x is clamped to [-87.8, 88.8] (NaN passes); ``m = floor(x*log2e +
    0.5)`` is fused, clamped to [-127, 127]; ``r = x - m*c1 - m*c2`` with
    both steps fused; the Horner chain over the five Cephes coefficients
    down to 0.5 is fused step by step, as is ``r + y*r^2``; the result
    ``(1 + ...) * 2^m`` builds 2^m from the exponent bits (m = -127
    gives 0)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    x = torch.where(x < _EXP_LO, _EXP_LO, x)
    x = torch.where(x > _EXP_HI, _EXP_HI, x)
    m = torch.floor(_fma(x, _EXP_LOG2E, 0.5))
    m = torch.clamp(m, -127.0, 127.0)
    r = _fma(-_EXP_C1, m, x)
    r = _fma(-_EXP_C2, m, r)
    p = _EXP_P
    y = _fma(r, p[0], p[1])
    for c in (p[2], p[3], p[4], 0.5):
        y = _fma(y, r, c)
    y = _fma(y, r * r, r) + 1.0
    pow2 = ((m.to(torch.int32) + 127) << 23).view(torch.float32)
    return _ftz(y * pow2)


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 sum over the last axis in index order from 0, as XLA's
    reduce loops add (``((0 + x0) + x1) + ...``)."""
    acc = torch.zeros(x.shape[:-1], dtype=torch.float32)
    for k in range(x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def _prefix_sums(x: torch.Tensor, strict: bool = False,
                 parts: int = 1) -> torch.Tensor:
    """Prefix sums of (P, K) float32 along K: column j sums terms k <= j
    (k < j when ``strict``).  ``parts`` = 1 adds them in index order from
    0; ``parts`` = 4 keeps four partial sums, term k into sum ``k mod 4``,
    and returns ``(s0 + s1) + (s2 + s3)``."""
    P, K = x.shape
    acc = [torch.zeros(P, dtype=torch.float32)] * parts
    out = torch.empty((P, K), dtype=torch.float32)

    def total():
        return acc[0] if parts == 1 else (acc[0] + acc[1]) + (acc[2]
                                                              + acc[3])
    for k in range(K):
        if strict:
            out[:, k] = total()
        acc[k % parts] = acc[k % parts] + x[:, k]
        if not strict:
            out[:, k] = total()
    return out


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums of (P, K) float32 along K as XLA:CPU lowers
    ``jnp.cumsum``: past 16 wide, blocks of 16 (zero-padded at the end),
    each scanned in index order, plus the in-order sum of the blocks
    before it (``block prefix + in-block prefix``)."""
    P, K = x.shape
    if K <= 16:
        return _prefix_sums(x)
    pad = -K % 16
    if pad:
        x = torch.cat([x, torch.zeros((P, pad), dtype=torch.float32)], 1)
    nb = x.shape[1] // 16
    within = _prefix_sums(x.reshape(P * nb, 16)).reshape(P, nb, 16)
    before = torch.cat([torch.zeros((P, 1), dtype=torch.float32),
                        _cumsum(within[:, :-1, -1])], 1)
    return (before[:, :, None] + within).reshape(P, -1)[:, :K]


def _triu_dot(x: torch.Tensor, strict: bool) -> torch.Tensor:
    """``x @ triu(ones((K, K)), strict)`` on (P, K) float32 in the order
    XLA:CPU's dot thunk sums it, for the widths the histogram sketch
    gives it (K = 8 and 16, ``quantile_fast``'s two-level select):

    * one row (P = 1): the dot is rewritten into a reduce, index order;
    * P >= 2: Eigen's kernel keeps four partial sums over ``k mod 4``.

    Only the terms that multiply a one count (a term times zero adds
    +0.0, which changes no sum of counts >= 0).  Other widths follow other
    paths; the sketch's other branch (``B % 8 != 0``, one B-wide product)
    sums in index order, which is XLA's order for 49 <= B <= 63 from two
    rows up; one row of B > 32 (a vectorized reduction) and Eigen's
    paths for some other widths are not reproduced (``ROADMAP.md`` §3)."""
    P, K = x.shape
    return _prefix_sums(x, strict, 4 if P >= 2 and K in (8, 16) else 1)


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's row sum: index order, but a row wider than 32 is first
    cut into windows of 32 (its tree-reduction pass; a ragged row is
    zero-padded half before, half after), each summed in order, then the
    window sums in order."""
    K = x.shape[-1]
    if K <= 32:
        return _seq_sum(x)
    pad = -K % 32
    if pad:
        def zeros(n):
            return torch.zeros(x.shape[:-1] + (n,), dtype=torch.float32)
        x = torch.cat([zeros(pad // 2), x, zeros(pad - pad // 2)], -1)
    return _tree_sum(_seq_sum(x.reshape(x.shape[:-1] + (-1, 32))))
