"""Closed-form counts of one sharded train step, per device: the port's
counterpart of what the reference's dry run reads off a compiled
program (``repro/launch/hlo_analysis.py``).

Eager PyTorch lowers nothing, so the port counts a step in closed form,
as ``launch/tier_cost.py`` does for a decode step.  These are derived
counts, not measurements.  For one (architecture, train shape, mesh)
cell :func:`train_step_counts` gives, per device:

* **argument bytes**: the train state's blocks under
  ``train_state_shardings`` (params, moments, the error buffer with
  compression, the int32 step) plus the batch's blocks under
  ``batch_shardings``: exactly the reference's
  ``memory_analysis().argument_size_in_bytes``;
* **matmul FLOPs** two ways: ``mxu_flops`` as the reference's lowering
  schedules the step (forward, backward, the remat recompute of every
  product of a layer but its last, which XLA prunes, the CE head once
  and its one-hot contraction), and ``port_mxu_flops`` as the port's
  eager step runs it (``torch.utils.checkpoint`` reruns each layer
  whole and each CE chunk's logits; the label's logit is a gather).
  Both are spread evenly over the mesh, as an SPMD program spreads the
  work; attention counts the full S x T products (min(window, S) keys
  for a windowed layer), as the reference's lowered dots do;
* **collective bytes** of the port's own scheme (``train_loop``'s
  sharded step): every microbatch each data replica gathers every
  weight whole and adds its gradient back into the blocks (ring wire
  bytes, (k - 1) / k of a leaf over its k blocks), and the global norm
  and compression's scale reduce one float32 a leaf;
* **HBM bytes** of the weights and the optimizer state alone (three
  reads of the gathered weights a microbatch, four with remat, one
  gradient write, AdamW's reads and writes of a block); activations are
  not counted, so the memory term is a lower bound.

The roofline (``Roofline`` on ``hw``) is the port's own on that mesh: a
data replica's device (the indices of ``tcfg.dp_axes``) runs its rows'
whole step, ``port_mxu_flops`` over the replica count, and moves the
bytes above.

:func:`model_flops` is the reference's useful-FLOPs formula, exact.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional

import torch

from repro_torch import configs, placement
from repro_torch.launch import roofline
from repro_torch.launch import sharding as rules_lib
from repro_torch.models import model_zoo, transformer
from repro_torch.models.common import ModelConfig

#: leaves with a model-dim axis that no product contracts
_NOT_PRODUCTS = ("conv_w", "A_log", "mu5")
#: each family's last product of a layer (its output feeds the residual
#: alone), which XLA's remat does not recompute
_LAST = {"dense": ("mlp/wo",), "moe": ("moe/experts/wo", "moe/shared/wo"),
         "hymba": ("mlp/wo",), "rwkv6": ("cm/wv",)}


def model_flops(cfg: ModelConfig, shape_kind: str, tokens: int, *,
                seq_len: int = 0, batch: int = 0) -> float:
    """Useful model FLOPs of a cell (``repro/launch/hlo_analysis.py:260``).

    train:   6 * N_active * tokens  (fwd 2ND + bwd 4ND)
    prefill: 2 * N_active * tokens
    decode:  2 * N_active * batch  + attention KV read term
    """
    n = cfg.active_param_count()
    if shape_kind == "train":
        base = 6.0 * n * tokens
    elif shape_kind == "prefill":
        base = 2.0 * n * tokens
    else:
        base = 2.0 * n * batch
    H, D, L = cfg.num_heads, cfg.head_dim, cfg.num_layers
    if shape_kind in ("train", "prefill") and H:
        S = seq_len
        attn = 2 * 2 * batch * S * S * H * D * L / 2
        if cfg.sliding_window:
            w = min(cfg.sliding_window, S)
            attn = 2 * 2 * batch * S * w * H * D * L
        base += attn * (3 if shape_kind == "train" else 1)
    elif shape_kind == "decode" and H:
        w = seq_len if not cfg.sliding_window else min(cfg.sliding_window,
                                                       seq_len)
        base += 2 * 2 * batch * w * H * D * L
    return base


def _is_product(path: str, axes) -> bool:
    dims = [a for a in axes if a != "layers"]
    return (len(dims) >= 2 and path.rpartition("/")[2] not in _NOT_PRODUCTS
            and any(a in ("embed", "ffn", "ssm_inner", "vocab")
                    for a in dims))


def _forward_products(cfg: ModelConfig, batch: int, seq: int,
                     labels: int, keys: Optional[int] = None
                     ) -> Dict[str, float]:
    """The forward's matmul FLOPs over the global batch: ``layers`` (the
    weight products and attention of every layer), ``last`` (each
    layer's last product, part of ``layers``), ``head`` (the output head
    over the ``labels`` positions) and ``onehot`` (the reference's
    contraction of the logits with the label's one-hot).  Attention runs
    ``seq`` queries over ``keys`` keys (default ``seq``; a decode step's
    are its cache's positions)."""
    keys = seq if keys is None else keys
    table = model_zoo.param_table(cfg)
    tokens = batch * seq
    layers = last = 0.0
    for path, spec in table.items():
        if not path.startswith("layers/") or not _is_product(path,
                                                             spec.axes):
            continue
        n = math.prod(spec.shape)
        if "/experts/" in path:          # E x C rows a batch row
            E, K = cfg.num_experts, cfg.top_k
            C = max(math.ceil(seq * K * cfg.capacity_factor / E), 1)
            f = 2.0 * batch * C * n
        else:
            f = 2.0 * tokens * n
        layers += f
        if path.split("/", 1)[1] in _LAST[cfg.family]:
            last += f
    if "layers/attn/wq" in table:
        for i in range(cfg.num_layers):
            w = transformer._window_for_layer(cfg, i)
            t = keys if w is None else min(w, keys)
            layers += 4.0 * batch * seq * t * cfg.num_heads * cfg.head_dim
    head = 2.0 * batch * labels * cfg.d_model * cfg.vocab_size
    onehot = 2.0 * batch * labels * cfg.vocab_size
    return {"layers": layers, "last": last, "head": head, "onehot": onehot}


class MeshShape:
    """A mesh's axis names and sizes, without devices (the spec tables
    read only these)."""

    def __init__(self, shape: Mapping[str, int]):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)


def _blocks(spec, mesh: MeshShape) -> int:
    """The number of blocks ``spec`` splits a tensor into."""
    return math.prod(placement.grid_counts(spec, mesh, len(spec)))


def _block_bytes(shape, spec, mesh: MeshShape, itemsize: int) -> int:
    return math.prod(shape) // _blocks(spec, mesh) * itemsize


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def train_step_counts(cfg: ModelConfig, tcfg, mesh_shape: Mapping[str, int],
                      shape: configs.ShapeSpec,
                      hw: roofline.Hardware = roofline.H100_SXM5
                      ) -> Dict[str, Any]:
    """The per-device counts of one train step of ``cfg`` at ``shape``
    (a train shape) on a mesh of ``mesh_shape`` ({axis: size}, e.g.
    ``{"data": 16, "model": 16}``), with ``tcfg``'s accumulation and
    compression (module docstring).  Returns a dict of the counts and
    the :class:`~repro_torch.launch.roofline.Roofline` on ``hw``."""
    if shape.kind != "train":
        raise ValueError(f"{shape.name} is a {shape.kind} shape; the train "
                         f"step counts train shapes")
    mesh = MeshShape(mesh_shape)
    chips = math.prod(mesh.shape.values())
    batch = configs.input_specs(cfg, shape)
    table = model_zoo.param_table(cfg)
    psh = rules_lib.param_shardings(cfg, mesh, "train")
    bsh = rules_lib.batch_shardings(batch, mesh)
    p_item = _itemsize(cfg.param_dtype)
    m_item = _itemsize(tcfg.opt.moment_dtype)

    # -- argument bytes: the state's blocks and the batch's -------------
    params_dev = sum(_block_bytes(s.shape, psh[k], mesh, p_item)
                     for k, s in table.items())
    moments_dev = 2 * sum(_block_bytes(s.shape, psh[k], mesh, m_item)
                          for k, s in table.items())
    err_dev = (sum(_block_bytes(s.shape, psh[k], mesh, 4)
                   for k, s in table.items())
               if tcfg.compression.enabled else 0)
    batch_dev = sum(_block_bytes(tuple(v.shape), bsh[k], mesh,
                                 _itemsize(v.dtype))
                    for k, v in batch.items())
    args = params_dev + moments_dev + err_dev + 4 + batch_dev

    # -- matmul FLOPs ---------------------------------------------------
    B = shape.global_batch
    labels = batch["labels"].shape[1]
    seq = labels + (batch["patches"].shape[1] if "patches" in batch else 0)
    f = _forward_products(cfg, B, seq, labels)
    fwd = f["layers"] + f["head"]
    remat = f["layers"] if cfg.remat else 0.0
    xla = 3 * fwd + (remat - f["last"] if cfg.remat else 0.0) + f["onehot"]
    eager = 3 * fwd + remat + f["head"]

    # -- collective bytes of the port's gathers and reductions ----------
    accum = tcfg.accum_steps
    gather = sum(math.prod(s.shape) * p_item * (1 - 1 / _blocks(psh[k], mesh))
                 for k, s in table.items())
    norm = 2 * 4 * len(table) * (chips - 1) / chips
    scale = norm if tcfg.compression.enabled else 0.0
    wire = accum * 2 * gather + norm + scale

    # -- HBM bytes: weights and optimizer state ---------------------------
    P = sum(math.prod(s.shape) for s in table.values()) * p_item
    passes = 4 if cfg.remat else 3
    grad_dev = sum(_block_bytes(s.shape, psh[k], mesh, 4)
                   for k, s in table.items())
    # AdamW reads p, g, mu, nu and writes p, mu, nu; compression reads
    # and writes the error and rewrites g
    opt_bytes = (params_dev * 2 + moments_dev * 2
                 + grad_dev * (4 if err_dev else 1))
    hbm = accum * (passes + 1) * P + opt_bytes

    # the port's step computes a data replica's rows whole on one device
    replicas = math.prod(mesh.shape.get(a, 1) for a in tcfg.dp_axes)
    roof = roofline.Roofline(eager / replicas, hbm, wire, chips,
                             mxu_flops_per_device=eager / replicas, hw=hw)
    tokens = B * shape.seq_len
    mf = model_flops(cfg, "train", tokens, seq_len=shape.seq_len, batch=B)
    return {
        "argument_bytes": args,
        "state_bytes": params_dev + moments_dev + err_dev + 4,
        "batch_bytes": batch_dev,
        # the weight-gather keeps every weight whole, with its gradient,
        # on each data replica's device
        "gathered_bytes": 2 * P,
        "mxu_flops_per_device": xla / chips,
        "port_mxu_flops_per_device": eager / chips,
        "replicas": replicas,
        "model_flops_per_device": mf / chips,
        "collective_wire_bytes": wire,
        "hbm_bytes": hbm,
        "roofline": roof,
    }
