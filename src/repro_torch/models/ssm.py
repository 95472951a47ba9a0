"""Selective state-space (Mamba-style S6) head, used by hymba.

The counterpart of ``repro/models/ssm.py``.  Diagonal selective SSM::

    dt_t = softplus(x_t @ W_dt + b_dt)            (B,S,I)   per-channel step
    a_t  = exp(dt_t * A)                          (B,S,I,N) A < 0 (learned log)
    h_t  = a_t . h_{t-1} + dt_t * x_t * B_t       (B,I,N)   B_t: (B,S,N)
    y_t  = sum_N h_t * C_t + D . x_t              (B,S,I)

Prefill solves the recurrence with :func:`repro_torch.kernels.ops.ssd_scan`
(kernel K5 on the card, the plain sequential scan on the CPU); decode is
the O(1) recurrence, with no kernel.  Dtypes follow the reference: the
state ``h`` is float32, the conv state is in ``compute_dtype``, ``dt``,
``B``, ``C``, ``a`` and ``b`` are float32, the output is in ``x.dtype``.

Unlike the reference, which returns the new state, :func:`ssm_block`
writes it **in place** into the ``state`` it is given (views of the
cache), as the port's attention writes its KV cache; in decode only the
rows in ``rows`` are written, so an inactive row's state stays bit for
bit as it was.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig, ParamSpec, Params

State = Dict[str, torch.Tensor]


def ssm_specs(cfg: ModelConfig, d_in: int) -> Dict[str, ParamSpec]:
    I, N, Kc = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_conv
    return {
        "in_proj": ParamSpec((d_in, 2 * I), ("embed", "ssm_inner")),
        "conv_w": ParamSpec((Kc, I), (None, "ssm_inner"), "normal", 0.5),
        "conv_b": ParamSpec((I,), ("ssm_inner",), "zeros"),
        "wB": ParamSpec((I, N), ("ssm_inner", None), scale=0.5),
        "wC": ParamSpec((I, N), ("ssm_inner", None), scale=0.5),
        "wdt": ParamSpec((I, I), ("ssm_inner", "ssm_inner"), scale=0.1),
        "dt_bias": ParamSpec((I,), ("ssm_inner",), "const", -2.0),
        "A_log": ParamSpec((I, N), ("ssm_inner", None), "const", 0.0),
        "Dskip": ParamSpec((I,), ("ssm_inner",), "ones"),
        "out_proj": ParamSpec((I, d_in), ("ssm_inner", "embed")),
    }


def ssm_recurrent_step(a_t: torch.Tensor, b_t: torch.Tensor,
                       h: torch.Tensor) -> torch.Tensor:
    return a_t * h + b_t


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 conv_state: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv.  x: (B,S,I); w: (K,I); conv_state:
    (B,K-1,I).  Returns (y (B,S,I), new_state (B,K-1,I))."""
    K, S = w.shape[0], x.shape[1]
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)     # (B,S+K-1,I)
    y = sum(xp[:, i:i + S] * w[i].to(x.dtype) for i in range(K))
    y = y + b.to(x.dtype)
    new_state = xp[:, -(K - 1):] if K > 1 else conv_state
    return y, new_state


def ssm_block(cfg: ModelConfig, p: Params, x: torch.Tensor, state: State,
              mode: str, rows: Optional[torch.Tensor] = None,
              prefix: str = "ssm/") -> torch.Tensor:
    """x: (B,S,d) -> (B,S,d).  ``state`` = {"h": (B,I,N) float32, "conv":
    (B,K-1,I)} is read and then overwritten with the new state (in decode
    only at the row indices ``rows``, when given; in train not at all)."""
    g = lambda k: p[prefix + k]                                # noqa: E731
    zx = x @ g("in_proj").to(x.dtype)                          # (B,S,2I)
    z, xin = zx.chunk(2, dim=-1)                               # (B,S,I) each
    xc, conv_new = _causal_conv(xin, g("conv_w"), g("conv_b"), state["conv"])
    xc = F.silu(xc.float())                                    # (B,S,I) fp32

    dt = F.softplus(xc @ g("wdt").float() + g("dt_bias").float())  # (B,S,I)
    Bmat = xc @ g("wB").float()                                # (B,S,N)
    Cmat = xc @ g("wC").float()
    A = -torch.exp(g("A_log").float())                         # (I,N) < 0
    a = torch.exp(dt[..., None] * A)                           # (B,S,I,N)
    b = (dt * xc)[..., None] * Bmat[:, :, None, :]             # (B,S,I,N)

    if mode == "decode":
        h = ssm_recurrent_step(a[:, 0], b[:, 0], state["h"])
        y_core = torch.einsum("bsin,bsn->bsi", h[:, None], Cmat)
    else:
        hs, h = ops.ssd_scan(a, b, state["h"])
        y_core = torch.einsum("bsin,bsn->bsi", hs, Cmat)
    conv_new = conv_new.to(state["conv"].dtype)
    if mode == "train":
        pass                            # training keeps no state
    elif rows is None:
        state["h"].copy_(h)
        state["conv"].copy_(conv_new)
    else:
        state["h"][rows] = h[rows]
        state["conv"][rows] = conv_new[rows]

    y = y_core + g("Dskip").float() * xc
    y = (y * F.silu(z.float())).to(x.dtype)
    return y @ g("out_proj").to(x.dtype)


def init_state(cfg: ModelConfig, batch: int, device=None) -> State:
    """Zero SSM state of ``batch`` rows: h (B,I,N) float32, conv
    (B,K-1,I) in ``compute_dtype``."""
    I, N, K = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_conv
    return {"h": torch.zeros((batch, I, N), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, K - 1, I), dtype=cfg.compute_dtype,
                                device=device)}
