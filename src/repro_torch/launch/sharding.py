"""Parameter rule tables of the serving modes: the port's counterpart of
``repro/launch/sharding.py:44-63, 90-96``.

``serve_replicated`` (the tensor-parallel endpoint's layout): weights
replicated over "data", heads / kv heads / ffn / vocab and the embed
table's model dim over "model".  ``serve`` additionally shards the
model dim ("embed") over "data" (the memory-safe layout of the largest
architectures).  Divisibility fallbacks happen in
:meth:`repro_torch.sharding.AxisRules.spec`.

Training is ported unsharded (``repro_torch.training``); the activation
rules, the cache and batch layouts and the train-state tables come with
sharded training.
"""

from __future__ import annotations

from typing import Any, Dict

from repro_torch.models.common import ModelConfig
from repro_torch.sharding import AxisRules, Spec

#: the modes these tables serve
MODES = ("serve", "serve_replicated")


def param_rules(mesh: Any, mode: str) -> AxisRules:
    """Parameter-dimension rules of a serving ``mode`` on ``mesh``."""
    if mode not in MODES:
        raise ValueError(f"unknown serving mode {mode!r}; the modes are "
                         f"{MODES}")
    fsdp = ("data",) if "data" in mesh.axis_names else ()
    table: Dict[str, Any] = {
        "embed": fsdp,
        "embed_table": "model",
        "vocab_in": fsdp,
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "ffn": "model",
        "experts": None,
        "ssm_inner": "model",
        "layers": None,
    }
    if mode == "serve_replicated":
        table = dict(table, embed=None, vocab_in=None)
    return AxisRules(mesh, table)


def param_shardings(cfg: ModelConfig, mesh: Any, mode: str
                    ) -> Dict[str, Spec]:
    """The partition spec of every parameter path, from the param
    table's logical axes."""
    from repro_torch.models import model_zoo
    rules = param_rules(mesh, mode)
    return {path: rules.spec(spec.axes, spec.shape)
            for path, spec in model_zoo.param_table(cfg).items()}
