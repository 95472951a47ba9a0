"""Carry the JAX reference's parameters over to the port.

The reference keeps parameters as a flat ``{path: array}`` dict
(``repro/models/common.py:201-205``) with per-layer weights stacked under
``layers/...``; the port uses the same keys and layout, so a parameter
set crosses over leaf by leaf through numpy.  A bfloat16 leaf arrives as
an ``ml_dtypes.bfloat16`` numpy array; its bits are reinterpreted as
uint16 and viewed back as ``torch.bfloat16`` (no rounding, and no import
of ``ml_dtypes``).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike
from repro_torch.models import model_zoo
from repro_torch.models.common import ModelConfig, Params


def tensor_from_numpy(a: np.ndarray, device: DeviceLike) -> torch.Tensor:
    """One numpy leaf as a tensor on ``device``, bit for bit."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def params_from_numpy(flat: Mapping[str, np.ndarray], cfg: ModelConfig,
                      device: DeviceLike) -> Params:
    """The port's parameter dict from the reference's flat numpy dict.

    Keys and shapes are checked against the port's own param table, so a
    layout drift between the two packages fails loudly here."""
    table = model_zoo.param_table(cfg)
    if set(flat) != set(table):
        raise ValueError(
            f"parameter keys differ: missing {sorted(set(table) - set(flat))}"
            f", unexpected {sorted(set(flat) - set(table))}")
    out = {}
    for path, spec in table.items():
        a = np.asarray(flat[path])
        if tuple(a.shape) != tuple(spec.shape):
            raise ValueError(f"{path}: shape {a.shape} != {spec.shape}")
        out[path] = tensor_from_numpy(a, device)
    return out
