"""Mode-specific logical-axis -> mesh-axis rule tables and the spec
builders over whole trees: the port's counterpart of
``repro/launch/sharding.py``.

Two rule sets per mode:

* **param rules** — how parameter (and optimizer-state) dimensions map
  to the mesh;
* **act rules** — how activation dimensions (and the KV / state cache)
  map.

``train`` = FSDP over "data" x TP over "model" x DP over "pod": params
and moments shard the model dim ("embed") over "data" (ZeRO-3 style) and
heads / kv heads / ffn / vocab over "model"; the batch shards over
("pod", "data"); the activation table keeps the reference's Megatron
sequence parallelism ("seq" -> "model").  ``serve`` keeps the train
weight layout (memory-safe for the largest architectures); its cache
shards the KV sequence over "model".  ``serve_replicated`` (the
tensor-parallel endpoint's layout) replicates weights over "data".
Divisibility fallbacks happen in
:meth:`repro_torch.sharding.AxisRules.spec`.

Every table is pure in the mesh (anything with ``axis_names`` and a
``shape`` dict).  Eager PyTorch has no sharding constraint, so the
activation table places nothing by itself; the cache and batch specs
place tensors through :mod:`repro_torch.placement`, and the sharded train
step (``training/train_loop.py``) places its state by
:func:`train_state_shardings` and its batch by :func:`batch_shardings`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from repro_torch.models.common import ModelConfig
from repro_torch.sharding import AxisRules, Spec

#: the modes these tables serve
MODES = ("train", "serve", "serve_replicated")

_BATCH = ("pod", "data")          # mesh axes used for the batch dim


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; the modes are {MODES}")


def param_rules(mesh: Any, mode: str) -> AxisRules:
    """Parameter-dimension rules of ``mode`` on ``mesh`` (also applied to
    the optimizer moments)."""
    _check_mode(mode)
    fsdp = ("data",) if "data" in mesh.axis_names else ()
    table: Dict[str, Any] = {
        "embed": fsdp,            # ZeRO-3: shard the model dim over data
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


def act_rules(mesh: Any, mode: str) -> AxisRules:
    """Activation rules of ``mode`` (the cache's too)."""
    _check_mode(mode)
    batch = tuple(a for a in _BATCH if a in mesh.axis_names)
    table: Dict[str, Any] = {
        "batch": batch,
        "seq": "model" if mode == "train" else None,   # Megatron SP
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "ffn": "model",
        "embed": None,
        "vocab": "model",
        "cache_seq": "model",
        "experts": None,
        "ssm_inner": "model",
    }
    return AxisRules(mesh, table)


# ---------------------------------------------------------------------------
# Whole-tree spec builders
# ---------------------------------------------------------------------------


def param_shardings(cfg: ModelConfig, mesh: Any, mode: str
                    ) -> Dict[str, Spec]:
    """The partition spec of every parameter path, from the param
    table's logical axes."""
    from repro_torch.models import model_zoo
    rules = param_rules(mesh, mode)
    return {path: rules.spec(spec.axes, spec.shape)
            for path, spec in model_zoo.param_table(cfg).items()}


def _cache_leaf_spec(key: str, shape: Tuple[int, ...], rules: AxisRules,
                     stacked: bool = True) -> Spec:
    """The spec of one KV / state cache leaf, by its name's last part.

    Layout (a stacked leaf adds a leading "layers" dim, as every leaf of
    the port's caches does):
      k/v:   (B, W, Hkv, Dh)    pos: (B, W)
      tm_x/cm_x: (B, d)         tm_s: (B, H, D, D)
      h:     (B, I, N)          conv: (B, K-1, I)
    """
    base = {
        "k": ("batch", "cache_seq", "kv_heads", "head_dim"),
        "v": ("batch", "cache_seq", "kv_heads", "head_dim"),
        "pos": ("batch", "cache_seq"),
        "tm_x": ("batch", None),
        "cm_x": ("batch", None),
        "tm_s": ("batch", "heads", None, None),
        "h": ("batch", "ssm_inner", None),
        "conv": ("batch", None, "ssm_inner"),
    }[key.rpartition("/")[2]]
    axes = (("layers",) + base) if stacked else base
    return rules.spec(axes[:len(shape)], shape)


def cache_shardings(cfg: ModelConfig, cache: Dict[str, Any], mesh: Any,
                    mode: str) -> Dict[str, Spec]:
    """The spec of every leaf of a cache dict (tensors, ``meta`` ones
    will do), by the activation rules of ``mode``.  The port stacks every
    cache leaf over its layers (hymba one stack per attention width,
    ROADMAP §3), so each spec starts with the layers' dim, replicated."""
    rules = act_rules(mesh, mode)
    return {k: _cache_leaf_spec(k, tuple(v.shape), rules)
            for k, v in cache.items()}


def batch_shardings(batch: Dict[str, Any], mesh: Any) -> Dict[str, Spec]:
    """Input batches shard their leading (global-batch) dim over ("pod",
    "data"), trailing axes dropped until the count divides it (long_500k's
    B = 1 stays replicated)."""
    rules = AxisRules(mesh, {"b": tuple(a for a in _BATCH
                                        if a in mesh.axis_names)})
    return {k: rules.spec(("b",) + (None,) * (len(v.shape) - 1),
                          tuple(v.shape))
            for k, v in batch.items()}


def opt_state_shardings(param_sh: Dict[str, Spec], mesh: Any):
    """Optimizer moments mirror their parameter's spec; the step is
    replicated."""
    from repro_torch.training.optimizer import OptState
    return OptState(step=replicated(mesh), mu=dict(param_sh),
                    nu=dict(param_sh))


def train_state_shardings(cfg: ModelConfig, mesh: Any, *,
                          compression: bool = False):
    """The specs of a whole ``TrainState``: params, moments and (with
    compression) the error buffer in the train layout."""
    from repro_torch.training.train_loop import TrainState
    psh = param_shardings(cfg, mesh, "train")
    err: Optional[Dict[str, Spec]] = dict(psh) if compression else None
    return TrainState(params=psh, opt=opt_state_shardings(psh, mesh),
                      err=err)


def replicated(mesh: Any) -> Spec:
    """The spec of a tensor every device holds whole."""
    return ()
