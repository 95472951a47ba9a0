"""Closed-form counts of one serve step (a prefill, or one decode step)
on a mesh, per device: the port's counterpart of what the reference's
dry run reads off a compiled serve program
(``repro/launch/dryrun.py:120-168``).

Eager PyTorch lowers nothing, so the port counts a serve cell in closed
form, as ``launch/train_cost.py`` counts a train cell; derived counts,
not measurements.  For one (architecture, prefill or decode shape, mesh,
serve mode) :func:`serve_step_counts` gives:

* **argument bytes** per device: the params' blocks under
  ``param_shardings(cfg, mesh, serve_mode)``, the cache's under
  ``cache_shardings(..., "serve")`` and the inputs' under
  ``batch_shardings``: exactly the reference's
  ``memory_analysis().argument_size_in_bytes``;
* **matmul FLOPs** two ways, as ``train_cost`` gives them: as the
  reference's lowering schedules them (``mxu_flops_per_device``, the
  global products spread over the mesh) and as the port's step runs
  them (``port_mxu_flops_per_device``).  A serve step has no remat and
  no one-hot, so the two are the same products; what differs is where
  they run (below).  Attention runs the prompt's S x S products in a
  prefill and a decode token over the cache's T positions (min(window,
  .) for a windowed layer); the head runs on the last position only;
* **collective bytes** of ``serving/engine.make_serve_step``'s scheme
  over the mesh, term by term as ``serve_step.traffic`` counts them:
  every running data replica joins each weight's blocks its position
  does not hold (``weights``) and its rows' cache blocks likewise
  (``cache``); it writes back its rows' cache, all of it after a
  prefill, a decode step's one position and the recurrent state, to
  every other position holding it, replicas included (``writeback``);
  the logits of the other replicas come to the first (``logits``).  A
  decode step writes position ``position`` (default the cache's last:
  the reference's cell is one new token against a full cache);
* **HBM bytes** of the busiest device: the weights read once, a decode
  step's rows' cache read once, the new entries written (a prefill's
  prompt positions, a decode step's one, the recurrent state whole).
  Activations are not counted, so the memory term is a lower bound.

The roofline (``Roofline`` on ``hw``) is the port's own: the step runs
each replica's rows whole on the replica's device, so a device does the
products over the running replica count and moves its share of the
collective bytes.  ``decode_step_ms`` is a decode cell's roofline step
time, the number a cost-modeled tier adopts in the reference.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional

from repro_torch import configs, placement
from repro_torch.launch import roofline
from repro_torch.launch import sharding as rules_lib
from repro_torch.launch.train_cost import (MeshShape, _block_bytes,
                                           _forward_products, _itemsize,
                                           model_flops)
from repro_torch.models import model_zoo
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import POSITION_LEAVES

def _nbytes(t) -> int:
    return math.prod(t.shape) * _itemsize(t.dtype)


def serve_step_counts(cfg: ModelConfig, mesh_shape: Mapping[str, int],
                      shape: configs.ShapeSpec, *,
                      serve_mode: str = "serve",
                      hw: roofline.Hardware = roofline.H100_SXM5,
                      cache_len: Optional[int] = None,
                      position: Optional[int] = None) -> Dict[str, Any]:
    """The counts of one serve step of ``cfg`` at ``shape`` (a prefill
    or decode shape) on a mesh of ``mesh_shape`` ({axis: size}) with the
    params in ``serve_mode``'s layout (module docstring).  The cache
    holds ``cache_len`` positions (default ``shape.seq_len``, the
    reference's cells); a decode step writes ``position`` (default the
    last).  Returns a dict of the counts and the
    :class:`~repro_torch.launch.roofline.Roofline` on ``hw``."""
    if shape.kind not in ("prefill", "decode"):
        raise ValueError(f"{shape.name} is a {shape.kind} shape; the serve "
                         f"step counts prefill and decode shapes")
    mesh = MeshShape(mesh_shape)
    chips = math.prod(mesh.shape.values())
    B = shape.global_batch
    T = shape.seq_len if cache_len is None else cache_len
    inputs = configs.input_specs(cfg, shape)
    cache = model_zoo.init_cache(cfg, B, T, "meta")
    table = model_zoo.param_table(cfg)
    psh = rules_lib.param_shardings(cfg, mesh, serve_mode)
    csh = rules_lib.cache_shardings(cfg, cache, mesh, "serve")
    bsh = rules_lib.batch_shardings(inputs, mesh)
    p_item = _itemsize(cfg.param_dtype)

    # -- argument bytes ---------------------------------------------------
    params_dev = sum(_block_bytes(s.shape, psh[k], mesh, p_item)
                     for k, s in table.items())
    cache_dev = sum(_block_bytes(tuple(v.shape), csh[k], mesh,
                                 _itemsize(v.dtype))
                    for k, v in cache.items())
    inputs_dev = sum(_block_bytes(tuple(v.shape), bsh[k], mesh,
                                  _itemsize(v.dtype))
                     for k, v in inputs.items())

    # -- the running replicas: one a distinct block of the batch -----------
    tok = bsh["tokens"]
    ndim = len(inputs["tokens"].shape)
    homes = {}
    for coord in placement.replica_coords(
            mesh, tuple(a for a in ("pod", "data") if a in mesh.axis_names)):
        homes.setdefault(placement.block_at(tok, mesh, coord, ndim)[0],
                         coord)
    nb = placement.grid_counts(tok, mesh, ndim)[0]
    if len(homes) != nb:
        raise ValueError(f"the batch's {nb} blocks are not one a replica")
    rows = B // nb

    # -- collective bytes of the step's joins and write-backs --------------
    P = sum(math.prod(s.shape) for s in table.values()) * p_item
    weights = nb * sum(math.prod(s.shape) * p_item
                       - _block_bytes(s.shape, psh[k], mesh, p_item)
                       for k, s in table.items())
    join = writeback = 0
    pos = T - 1 if position is None else position
    for k, v in cache.items():
        leaf, spec = _nbytes(v), csh[k]
        counts = placement.grid_counts(spec, mesh, v.dim())
        k_all = math.prod(counts)
        if counts[1] != nb:
            raise ValueError(f"cache leaf {k}: {counts[1]} row blocks for "
                             f"the batch's {nb}")
        join += leaf - nb * (leaf // k_all)
        if shape.kind == "prefill" or k.rpartition("/")[2] not in \
                POSITION_LEAVES:
            writeback += (chips - nb) * (leaf // k_all)
            continue
        W = v.shape[2]
        k_seq = counts[2]
        m_s = (pos % W) // (W // k_seq)
        holders = chips // (nb * k_seq)
        part = leaf // (B * W) // (k_all // (nb * k_seq))
        for coord in homes.values():
            own = placement.block_at(spec, mesh, coord, v.dim())[2] == m_s
            writeback += rows * (holders - own) * part
    logits = (B - rows) * cfg.vocab_size * 4
    collective = {"weights": weights, "cache": join,
                  "writeback": writeback, "logits": logits}
    wire = sum(collective.values())

    # -- matmul FLOPs -----------------------------------------------------
    if shape.kind == "prefill":
        seq = sum(inputs[k].shape[1] for k in ("tokens", "patches")
                  if k in inputs)
        f = _forward_products(cfg, B, seq, 1)
    else:
        f = _forward_products(cfg, B, 1, 1, keys=T)
    products = f["layers"] + f["head"]

    # -- HBM bytes of a running replica's device ----------------------------
    hbm = P
    for k, v in cache.items():
        mine = _nbytes(v) // nb
        if k.rpartition("/")[2] not in POSITION_LEAVES:
            hbm += mine * (2 if shape.kind == "decode" else 1)
        elif shape.kind == "decode":
            hbm += mine + mine // v.shape[2]
        else:
            hbm += mine * min(seq, v.shape[2]) // v.shape[2]

    roof = roofline.Roofline(products / nb, hbm, wire / nb, chips,
                             mxu_flops_per_device=products / nb, hw=hw)
    tokens = B * (shape.seq_len if shape.kind == "prefill" else 1)
    mf = model_flops(cfg, shape.kind, tokens, seq_len=shape.seq_len,
                     batch=B)
    out = {
        "argument_bytes": params_dev + cache_dev + inputs_dev,
        "params_bytes": params_dev,
        "cache_bytes": cache_dev,
        "input_bytes": inputs_dev,
        # a running replica holds every weight and its rows' cache whole
        "gathered_bytes": P + sum(_nbytes(v) for v in cache.values()) // nb,
        "mxu_flops_per_device": products / chips,
        "port_mxu_flops_per_device": products / chips,
        "replicas": nb,
        "model_flops_per_device": mf / chips,
        "collective": collective,
        "collective_bytes": wire,
        "hbm_bytes": hbm,
        "roofline": roof,
    }
    if shape.kind == "decode":
        out["decode_step_ms"] = roof.step_s * 1e3
    return out
