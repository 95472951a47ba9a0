"""Carry the JAX reference's parameters over to the port.

The reference keeps parameters as a flat ``{path: array}`` dict
(``repro/models/common.py:201-205``) with per-layer weights stacked under
``layers/...``; the port uses the same keys and layout, so a parameter
set crosses over leaf by leaf through numpy.  A bfloat16 leaf arrives as
an ``ml_dtypes.bfloat16`` numpy array (or, read from the reference's
checkpoint by ``np.load``, as 2-byte ``|V2`` records); its bits are
reinterpreted as uint16 and viewed back as ``torch.bfloat16`` (no
rounding, and no import of ``ml_dtypes``).  :func:`tensor_from_numpy`
and :func:`tensor_to_numpy` are the port's one copy of that bit format;
``training/checkpoint.py`` uses them too.  A train state crosses over
the same way (:func:`state_from_numpy`, :func:`state_to_numpy`), onto a
device mesh too.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike
from repro_torch.models import model_zoo
from repro_torch.models.common import ModelConfig, Params

if TYPE_CHECKING:        # training/checkpoint.py imports this module
    from repro_torch.training.train_loop import TrainState


def tensor_from_numpy(a: np.ndarray, device: DeviceLike) -> torch.Tensor:
    """One numpy leaf as a tensor on ``device``, bit for bit; bfloat16
    bits (``ml_dtypes.bfloat16`` or ``|V2`` records) as ``torch.bfloat16``."""
    a = np.asarray(a, order="C")         # keeps a 0-d leaf 0-d
    if a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2"):
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


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """One tensor as a numpy array on the host, bit for bit; a bfloat16
    tensor comes back as its uint16 bit patterns (``.view(ml_dtypes.
    bfloat16)`` makes it the reference's dtype)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def state_from_numpy(state: Any, cfg: ModelConfig, device: DeviceLike,
                     shardings: Any = None, mesh: Any = None) -> TrainState:
    """The port's :class:`~repro_torch.training.train_loop.TrainState`
    from the reference's, its leaves as numpy arrays
    (``jax.tree.map(np.asarray, state)``): ``state.params``,
    ``state.opt.step``, ``state.opt.mu``, ``state.opt.nu`` and
    ``state.err`` (None without compression).  The step stays on the
    host, as the port keeps it.  With ``shardings`` (specs,
    ``launch/sharding.train_state_shardings``) and ``mesh`` the leaves
    are placed on the mesh (``device`` is where they are staged)."""
    from repro_torch.training.optimizer import OptState
    from repro_torch.training.train_loop import TrainState, place_state

    def leaves(flat: Optional[Mapping[str, np.ndarray]]):
        if flat is None:
            return None
        return {k: tensor_from_numpy(np.asarray(v), device)
                for k, v in flat.items()}

    params = params_from_numpy(state.params, cfg, device)
    step = torch.tensor(int(np.asarray(state.opt.step)), dtype=torch.int32)
    out = TrainState(params, OptState(step, leaves(state.opt.mu),
                                      leaves(state.opt.nu)),
                     leaves(state.err))
    return out if shardings is None else place_state(out, shardings, mesh)


def state_to_numpy(state: TrainState) -> Dict[str, Any]:
    """A port train state as numpy: {"params", "step", "mu", "nu", "err"}
    (:func:`tensor_to_numpy` leaves, a placed leaf joined first; ``err``
    None without compression)."""
    from repro_torch import placement

    def leaves(flat):
        if flat is None:
            return None
        return {k: tensor_to_numpy(placement.join(v, "cpu")
                                   if isinstance(v, placement.Placed)
                                   else v)
                for k, v in flat.items()}

    return {"params": leaves(state.params),
            "step": tensor_to_numpy(state.opt.step),
            "mu": leaves(state.opt.mu), "nu": leaves(state.opt.nu),
            "err": leaves(state.err)}
