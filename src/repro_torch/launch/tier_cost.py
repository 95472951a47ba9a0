"""Cost-modeled tier capacity: one roofline for the simulator and the
live runtime.

The port's counterpart of ``repro/launch/tier_cost.py``.  A
:class:`~repro_torch.core.topology.TierSpec` that names a ``model`` (and
optionally a ``mesh_shape``) does not hand-set its simulator speed or
its slot count; both are derived here:

* **decode_step_ms** — one tensor-parallel decode step of the tier's
  architecture, counted per device (weight-streaming matmuls per layer,
  the KV cache read, the psum collectives: two all-reduces a layer and
  the embed/logits all-gathers) and turned into a
  :class:`~repro_torch.launch.roofline.Roofline`; the step time is the
  max of its compute, HBM and interconnect terms.
* **slots** — the requested concurrency clamped to the KV rows that fit
  next to the (sharded) parameters in one device's HBM.
* **service_rate_mult** — the simulator's relative speed, ``ref_step /
  step`` against the chain's first cost-modeled tier, so that tier's
  multiplier is exactly 1.0.

The reference prices a synthetic decode-step HLO text with its
trip-count-aware HLO walk (``decode_step_hlo`` through
``hlo_cost.analyze_hlo``).  :func:`decode_step_counts` counts the same
step in closed form, term by term as that walk charges it (each matmul
reads its weights and activations and writes its result, the two cache
reductions read the cache window, the cast of the scores is charged at
its consumer, the loop counter and its compare count once a layer), so
the counts equal the walk's exactly
(``tests/test_torch_tier_cost.py``).  The pricing scheme is the
production psum layout (everything divided by ``tp``, head counts
ceil'd), not the live endpoint's.

The hardware is a :class:`~repro_torch.launch.roofline.Hardware` record,
the H100 SXM5 by default.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.launch.roofline import H100_SXM5, Hardware, Roofline

#: bytes a device keeps back from the KV rows for the CUDA context, the
#: library workspaces and allocator slack (a budget, not a measurement)
HBM_RESERVE_BYTES = 1e9


def _itemsize(dtype) -> int:
    return int(dtype.itemsize)


# --------------------------------------------------------------------------
# Per-device dimensions of the psum tensor-parallel decode step
# --------------------------------------------------------------------------


def _tp_dims(cfg, tp: int) -> Dict[str, int]:
    """Local (per-device) dimensions under ``tp``-way tensor parallelism.
    Head counts ceil: with more devices than KV heads each device still
    holds one (the heads are replicated across subgroups)."""
    lq = -(-cfg.num_heads // tp)              # local query heads
    lkv = -(-cfg.num_kv_heads // tp)          # local kv heads
    return {
        "d": cfg.d_model,                     # activations stay full
        "dl": -(-cfg.d_model // tp),          # embed table slice
        "Qd": lq * cfg.head_dim,
        "KVd": lkv * cfg.head_dim,
        "Fl": -(-cfg.d_ff // tp),
        "Vl": -(-cfg.vocab_size // tp),
        "lq": lq,
        "lkv": lkv,
    }


def params_bytes_per_device(cfg, tp: int) -> float:
    """Weight bytes resident per device under the psum TP layout: per
    layer q/k/v/o and the (swiglu) MLP matrices, sharded over ``tp`` with
    head counts ceil'd; embed and lm_head sharded; norms replicated."""
    t = _tp_dims(cfg, tp)
    d, Qd, KVd, Fl, dl = t["d"], t["Qd"], t["KVd"], t["Fl"], t["dl"]
    per_layer = (d * Qd + 2 * d * KVd + Qd * d     # wq, wk, wv, wo
                 + 2 * d * Fl + Fl * d             # wi, wg, wo(mlp)
                 + 4 * d)                          # norms (replicated)
    head = cfg.vocab_size * dl * (1 if cfg.tie_embeddings else 2) + 2 * d
    return float(cfg.num_layers * per_layer + head) * _itemsize(cfg.param_dtype)


def kv_row_bytes_per_device(cfg, tp: int, max_len: int) -> float:
    """KV-cache bytes one resident request costs per device: the kv heads
    shard over ``tp`` (ceil'd), the rolling window caps the extent, and
    the int32 position ledger is replicated."""
    t = _tp_dims(cfg, tp)
    width = max_len
    if cfg.sliding_window is not None:
        width = min(width, cfg.sliding_window)
    kv = 2 * width * t["lkv"] * cfg.head_dim * _itemsize(cfg.compute_dtype)
    pos = width * 4
    return float(cfg.num_layers * (kv + pos))


def decode_step_counts(cfg, *, tp: int, batch: int,
                       max_len: int) -> Dict[str, float]:
    """Per-device FLOPs, tensor-core FLOPs, HBM bytes and collective wire
    bytes of one ``tp``-way decode step at ``batch`` rows.

    The layer body runs ``num_layers`` times.  In it (a = activation
    bytes, w = weight bytes, A = batch x local query heads, W = the
    cache window):

    * norms, residual adds and the gate product: one FLOP an output
      element, reading both operands and writing the result;
    * each projection: 2 x out x contracted FLOPs on the tensor cores,
      reading its input, its weight and writing its output;
    * the K and V caches: one reduction each over (B, W, KVd), reading
      the window (+ an f32 scalar in and out);
    * scores (f32 out) and values over (A, W) per head; the bf16 cast of
      the scores is charged at the value matmul;
    * under ``tp`` > 1 an all-reduce after the attention and the MLP
      output (reads and writes (B, d));
    * the loop counter's add (12 B) and compare (9 B), a FLOP each.

    Outside the loop: the embedding gather (the rows and the ids), the
    logits matmul, and under ``tp`` > 1 the all-gathers of the embedding
    and of the logits.  Wire bytes follow the ring model: all-gather
    R(n-1)/n, all-reduce 2R(n-1)/n, summed in program order.
    """
    t = _tp_dims(cfg, tp)
    B = int(batch)
    d, dl, Qd, KVd, Fl, Vl = (t["d"], t["dl"], t["Qd"], t["KVd"],
                              t["Fl"], t["Vl"])
    W = max_len if cfg.sliding_window is None else min(max_len,
                                                       cfg.sliding_window)
    A = B * t["lq"]
    V, L, hd = cfg.vocab_size, cfg.num_layers, cfg.head_dim
    a, w = _itemsize(cfg.compute_dtype), _itemsize(cfg.param_dtype)
    sharded = tp > 1

    mxu = (2 * B * Qd * d + 2 * (2 * B * KVd * d)       # q, k, v
           + 2 * A * W * hd + 2 * A * hd * W            # scores, values
           + 2 * B * d * Qd                             # o
           + 2 * (2 * B * Fl * d) + 2 * B * d * Fl)     # wi, wg, wd
    vpu = (4 * B * d                                    # 2 norms, 2 adds
           + 2 * B * W * KVd                            # cache reductions
           + B * Fl                                     # gate product
           + 2)                                         # counter, compare
    Bda = B * d * a
    layer_bytes = (
        4 * 3 * Bda                                     # 2 norms, 2 adds
        + Bda + d * Qd * w + B * Qd * a                 # q
        + 2 * (Bda + d * KVd * w + B * KVd * a)         # k, v
        + 2 * (B * W * KVd * a + 8)                     # cache reductions
        + A * hd * a + hd * W * a + 4 * A * W           # scores
        + A * W * a + W * hd * a + A * hd * a           # values
        + B * Qd * a + Qd * d * w + Bda                 # o
        + 2 * (Bda + d * Fl * w + B * Fl * a)           # wi, wg
        + 3 * B * Fl * a                                # gate product
        + B * Fl * a + Fl * d * w + Bda                 # wd
        + (2 * 2 * Bda if sharded else 0)               # 2 all-reduces
        + 12 + 9)                                       # counter, compare
    entry_mxu = 2 * B * Vl * d                          # logits
    entry_bytes = (2 * B * dl * a + 4 * B               # embedding gather
                   + Bda + d * Vl * w + 4 * B * Vl)     # logits
    if sharded:
        entry_bytes += (B * dl * a + Bda                # embed all-gather
                        + 4 * B * Vl + 4 * B * V)       # logits all-gather
    wire = 0.0
    if sharded:
        n = tp
        wire += 1.0 * Bda * (n - 1) / n                 # embed all-gather
        for _ in range(2):                              # the all-reduces
            wire += float(L) * 2.0 * Bda * (n - 1) / n
        wire += 1.0 * (4 * B * V) * (n - 1) / n         # logits all-gather
    mxu_total = float(L * mxu + entry_mxu)
    return {
        "flops": mxu_total + float(L * vpu),
        "mxu_flops": mxu_total,
        "bytes": float(L * layer_bytes + entry_bytes),
        "collective_wire_bytes": wire,
        "num_collectives": 4 if sharded else 0,
    }


# --------------------------------------------------------------------------
# Registered single-source formulas (repro/analysis/registry.py)
# --------------------------------------------------------------------------


# lint: ignore[parity-drift] -- the port imports nothing of repro;
# tests/test_torch_tier_cost.py::test_formulas_match_reference holds this
# copy against repro.launch.tier_cost.derived_slot_capacity
def derived_slot_capacity(requested_slots: int, hbm_bytes: float,
                          params_bytes: float, reserve_bytes: float,
                          kv_row_bytes: float) -> int:
    """Slots = requested concurrency clamped to the KV rows that fit next
    to the resident (sharded) weights in per-device HBM.  Both the
    simulator's tier pools and the live endpoint are built from the
    resolved spec."""
    if kv_row_bytes <= 0.0:
        raise ValueError(f"kv_row_bytes must be > 0, got {kv_row_bytes}")
    free_bytes = float(hbm_bytes) - float(params_bytes) - float(reserve_bytes)
    if free_bytes < kv_row_bytes:
        raise ValueError(
            f"model does not fit: {params_bytes / 1e9:.2f} GB params "
            f"+ {reserve_bytes / 1e9:.2f} GB reserve leave "
            f"{free_bytes / 1e9:.2f} GB for KV rows of "
            f"{kv_row_bytes / 1e6:.1f} MB")
    fit = int(free_bytes // kv_row_bytes)
    return max(1, min(int(requested_slots), fit))


# lint: ignore[parity-drift] -- the port imports nothing of repro;
# tests/test_torch_tier_cost.py::test_formulas_match_reference holds this
# copy against repro.launch.tier_cost.derived_service_rate_mult
def derived_service_rate_mult(ref_step_s: float, step_s: float) -> float:
    """Relative speed against the chain's first cost-modeled tier, whose
    multiplier is then exactly 1.0."""
    if ref_step_s <= 0.0 or step_s <= 0.0:
        raise ValueError(
            f"decode step times must be > 0, got ref={ref_step_s} "
            f"step={step_s}")
    return float(ref_step_s) / float(step_s)


# --------------------------------------------------------------------------
# Tier costing + spec resolution
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TierCost:
    """The derived numbers for one cost-modeled tier."""

    arch: str
    mesh_shape: Tuple[int, ...]
    devices: int
    requested_slots: int
    slots: int                       # requested clamped to the KV fit
    kv_fit_slots: int
    decode_step_s: float             # at batch == slots
    params_bytes_per_device: float
    kv_row_bytes_per_device: float
    roofline: Dict[str, float]       # Roofline.to_dict() of the step

    @property
    def decode_step_ms(self) -> float:
        return self.decode_step_s * 1e3


def tier_cost(arch: str, *, mesh_shape: Optional[Tuple[int, ...]] = None,
              requested_slots: int = 4, max_len: int = 256,
              hw: Hardware = H100_SXM5) -> TierCost:
    """Price one tier on ``hw``: derived slots (in its HBM, less
    ``HBM_RESERVE_BYTES``), decode step time and its roofline."""
    from repro_torch import configs
    cfg = configs.get_config(arch)
    if cfg.family != "dense":
        raise ValueError(
            f"tier cost model covers the dense family only, "
            f"{arch!r} is {cfg.family!r}")
    hbm_bytes, reserve_bytes = hw.hbm_bytes, HBM_RESERVE_BYTES
    shape = tuple(int(a) for a in (mesh_shape or (1, 1)))
    tp = 1
    for a in shape:
        tp *= a
    pb = params_bytes_per_device(cfg, tp)
    kvb = kv_row_bytes_per_device(cfg, tp, max_len)
    free = hbm_bytes - pb - reserve_bytes
    fit = int(free // kvb) if free >= kvb else 0
    slots = derived_slot_capacity(requested_slots, hbm_bytes, pb,
                                  reserve_bytes, kvb)
    c = decode_step_counts(cfg, tp=tp, batch=slots, max_len=max_len)
    roof = Roofline(c["flops"], c["bytes"], c["collective_wire_bytes"],
                    chips=tp, mxu_flops_per_device=c["mxu_flops"], hw=hw)
    return TierCost(
        arch=arch, mesh_shape=shape, devices=tp,
        requested_slots=int(requested_slots), slots=slots, kv_fit_slots=fit,
        decode_step_s=roof.step_s,
        params_bytes_per_device=pb, kv_row_bytes_per_device=kvb,
        roofline=roof.to_dict())


def resolve_specs(specs: Sequence, *, hw: Hardware = H100_SXM5) -> Tuple:
    """Resolve every cost-modeled TierSpec of a chain: those that name a
    ``model`` get derived ``slots``, ``decode_step_ms`` and
    ``service_rate_mult``; hand-set specs pass through as the same
    objects (the elastic cloud keeps its ``service_rate_mult=None``
    sentinel).  The rate reference is the first cost-modeled tier in
    chain order."""
    costs = [tier_cost(s.model, mesh_shape=s.mesh_shape,
                       requested_slots=s.slots, max_len=s.max_len, hw=hw)
             if s.model is not None else None
             for s in specs]
    ref = next((c.decode_step_s for c in costs if c is not None), None)
    out = []
    for s, c in zip(specs, costs):
        if c is None:
            out.append(s)
            continue
        mult = derived_service_rate_mult(ref, c.decode_step_s)
        out.append(dataclasses.replace(
            s, slots=c.slots, decode_step_ms=c.decode_step_ms,
            service_rate_mult=mult))
    return tuple(out)
