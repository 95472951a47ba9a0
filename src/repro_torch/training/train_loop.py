"""Training step and fault-tolerant loop: the counterpart of
``repro/training/train_loop.py``.

``make_train_step`` builds ``(state, batch) -> (state, metrics)``: the
gradients of ``model_zoo.loss`` (``torch.autograd.grad``), summed in
float32 over ``accum_steps`` microbatches and averaged, optionally
through int8 error-feedback compression, then one AdamW update.  The
update is written **in place** into the state, which the step returns
(the counterpart of the reference's ``donate_argnums=(0,)``).  On the
card every forward of the attention and scan kernels (K1, K4, K5)
launches the kernel, and their backward differentiates the plain
versions, as the reference's ``custom_vjp`` does.

**On one device** the state's tensors live on ``device`` and the batch
moves there.

**Over a mesh** (``mesh=``; single-controller, as the reference and the
tensor-parallel endpoint are: one process holds every shard) the state
is placed by ``launch/sharding.train_state_shardings`` and the batch by
``batch_shardings`` (:mod:`repro_torch.placement`).  The step computes
what the reference's jitted sharded step computes, which is the
unsharded step:

* each microbatch's rows split, in order, over the data replicas (the
  indices of ``tcfg.dp_axes``); each replica gathers every weight whole
  onto its device (the counterpart of FSDP's and TP's all-gathers) and
  runs the forward on its rows;
* the replicas' loss sums (``model_zoo.loss_terms``) combine into the
  global loss on the first replica's device (``combine_loss``: the
  masked-token mean over every row, MoE's load balance from the summed
  routing statistics), and one ``torch.autograd.grad`` runs through all
  replicas' graphs;
* each replica's gradient is added into the blocks of a float32
  accumulator placed by ``grad_shardings`` (the counterpart of a
  reduce-scatter; default the parameter layout, which the reference's
  dry run pins);
* then compression (``compression.compress_placed``, the scale over
  every block) and AdamW block by block, the global norm summed over
  every block once.

The replicas compute whole layers, so the "model" axis shards storage,
not compute.  ``train_step.traffic`` counts the bytes a real mesh would
move: for each replica the weight and gradient blocks a mesh position
does not hold.

``Trainer`` drives the one-device step: auto-resume from the newest
complete checkpoint, periodic atomic saves, a fault hook for the
preemption tests, and the straggler ratio (p95/p50 of recent step walls,
the step ending at the loss's ``.item()``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import placement
from repro_torch.device import DeviceLike, resolve
from repro_torch.models import model_zoo
from repro_torch.models.common import ModelConfig, Params
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training import compression, optimizer
from repro_torch.training.optimizer import OptimizerConfig, OptState


class TrainState(NamedTuple):
    params: Params
    opt: OptState
    err: Optional[Params]        # compression error feedback (None if off)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptimizerConfig = OptimizerConfig()
    accum_steps: int = 1
    compression: compression.CompressionConfig = \
        compression.CompressionConfig()
    #: the mesh axes whose indices run the sharded step's data replicas
    dp_axes: Tuple[str, ...] = ("data",)


def init_state(generator: torch.Generator, cfg: ModelConfig,
               tcfg: TrainConfig) -> TrainState:
    """Seeded parameters (``model_zoo.init``, on the generator's device),
    zero moments and, with compression, a zero error buffer."""
    params = model_zoo.init(cfg, generator)
    err = compression.init_error(params) if tcfg.compression.enabled \
        else None
    return TrainState(params, optimizer.init(params, tcfg.opt), err)


def abstract_state(cfg: ModelConfig, tcfg: TrainConfig) -> TrainState:
    """The state's shapes and dtypes as ``meta`` tensors (no storage):
    the counterpart of the reference's ShapeDtypeStructs, for sizing and
    as a checkpoint template."""
    params = {k: torch.empty(spec.shape, dtype=cfg.param_dtype,
                             device="meta")
              for k, spec in model_zoo.param_table(cfg).items()}
    err = ({k: torch.empty(p.shape, dtype=torch.float32, device="meta")
            for k, p in params.items()}
           if tcfg.compression.enabled else None)
    return TrainState(params, optimizer.abstract_state(params, tcfg.opt),
                      err)


def place_state(state: TrainState, shardings: TrainState, mesh: Any
                ) -> TrainState:
    """``state`` placed on ``mesh`` by ``shardings`` (a ``TrainState``
    of specs, ``launch/sharding.train_state_shardings``); the step stays
    on the host."""
    def tree(d, specs):
        return None if d is None else {
            k: placement.place(v, specs[k], mesh) for k, v in d.items()}
    return TrainState(tree(state.params, shardings.params),
                      OptState(state.opt.step,
                               tree(state.opt.mu, shardings.opt.mu),
                               tree(state.opt.nu, shardings.opt.nu)),
                      tree(state.err, shardings.err))


def join_state(state: TrainState, device: DeviceLike = None) -> TrainState:
    """A placed ``state`` joined whole onto ``device`` (default each
    leaf's first position's device)."""
    dev = None if device is None else resolve(device)

    def tree(d):
        return None if d is None else {k: placement.join(v, dev)
                                       for k, v in d.items()}
    return TrainState(tree(state.params),
                      OptState(state.opt.step, tree(state.opt.mu),
                               tree(state.opt.nu)), tree(state.err))


def state_bytes(cfg: ModelConfig, tcfg: TrainConfig) -> int:
    """Bytes a train step holds besides activations: the parameters,
    their gradients, the two moments, the float32 accumulator of
    microbatch gradients and, with compression, the float32 error
    buffer."""
    n = cfg.param_count()
    p = torch.finfo(cfg.param_dtype).bits // 8
    m = torch.finfo(tcfg.opt.moment_dtype).bits // 8
    total = n * (2 * p + 2 * m)
    if tcfg.accum_steps > 1:
        total += 4 * n
    if tcfg.compression.enabled:
        total += 4 * n
    return total


def _split_microbatches(batch: Dict[str, torch.Tensor], accum: int):
    def r(x):
        B = x.shape[0]
        if B % accum != 0:
            raise ValueError(f"batch size {B} is not divisible by "
                             f"grad-accum factor {accum}")
        return x.reshape(accum, B // accum, *x.shape[1:])
    split = {k: r(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(accum)]


def _grads(cfg: ModelConfig, params: Params, mb: Dict[str, torch.Tensor]):
    """(loss, metrics, grads) of one microbatch; a parameter the loss
    does not reach gets a zero gradient, as ``jax.grad`` gives."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    with torch.enable_grad():
        loss, metrics = model_zoo.loss(cfg, leaves, mb)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(leaves.items(), grads)}
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, grads


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    device: DeviceLike = "cuda", *,
                    grad_shardings: Optional[Dict[str, Any]] = None,
                    mesh: Any = None) -> Callable:
    """The train step of one configuration: ``(state, batch) -> (state,
    metrics)``, ``state`` updated in place.  Without ``mesh`` it runs on
    ``device`` (default the card; raises without one), with its
    parameters there.  With ``mesh`` (a ``launch/mesh.Mesh``) it takes
    and returns a state placed on the mesh by
    ``train_state_shardings`` and a batch placed by ``batch_shardings``,
    and ``grad_shardings`` (specs by parameter path, default the
    parameters') places the float32 gradient accumulator.  The loss is
    the microbatches' mean; the metrics are the last microbatch's, plus
    ``loss``, ``grad_norm`` and ``lr``."""
    if mesh is not None:
        return _sharded_step(cfg, tcfg, mesh, grad_shardings)
    if grad_shardings is not None:
        raise ValueError("grad_shardings places gradients on a mesh; "
                         "pass mesh= too")
    dev = resolve(device)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        where = state.params["embed"].device
        if where.type != dev.type or (dev.index is not None
                                      and where != dev):
            raise ValueError(f"the train state lives on {where}, the "
                             f"step runs on {dev}")
        batch = {k: v.to(where) for k, v in batch.items()}
        if tcfg.accum_steps > 1:
            gsum = None
            lsum = torch.zeros((), dtype=torch.float32, device=where)
            for mb in _split_microbatches(batch, tcfg.accum_steps):
                loss, metrics, grads = _grads(cfg, state.params, mb)
                if gsum is None:
                    gsum = {k: torch.zeros(g.shape, dtype=torch.float32,
                                           device=where)
                            for k, g in grads.items()}
                for k, g in grads.items():
                    gsum[k] += g.float()
                del grads
                lsum = lsum + loss
            grads = {k: g.div_(tcfg.accum_steps) for k, g in gsum.items()}
            loss = lsum / tcfg.accum_steps
        else:
            loss, metrics, grads = _grads(cfg, state.params, batch)

        err = state.err
        if tcfg.compression.enabled and err is not None:
            # quantize + dequantize with error feedback (on one device
            # this stands where the cross-replica mean would)
            q, s, err = compression.compress(grads, err, tcfg.compression)
            grads = compression.decompress(q, s)

        params, opt, info = optimizer.apply_updates(
            tcfg.opt, state.params, grads, state.opt)
        metrics = dict(metrics, loss=loss, **info)
        return TrainState(params, opt, err), metrics

    return train_step


def _sharded_step(cfg: ModelConfig, tcfg: TrainConfig, mesh: Any,
                  grad_shardings: Optional[Dict[str, Any]]) -> Callable:
    """The train step over ``mesh`` (see the module docstring)."""
    replicas = placement.replica_devices(
        mesh, tuple(a for a in tcfg.dp_axes if a in mesh.axis_names))
    home = replicas[0]
    traffic = {"gather_bytes": 0, "reduce_bytes": 0}

    def away(p: placement.Placed, itemsize: int) -> int:
        """Bytes of ``p``'s blocks that one mesh position does not hold."""
        whole = int(np.prod(p.shape)) * itemsize
        return whole - whole // int(np.prod(p.counts))

    def microbatch(params, mb, acc):
        """Add one microbatch's gradient into ``acc``; (loss, metrics)."""
        rows = torch.tensor_split(torch.arange(mb["labels"].shape[0]),
                                  len(replicas))
        terms, leaves = [], []
        with torch.enable_grad():
            for dev, idx in zip(replicas, rows):
                if len(idx) == 0:
                    continue
                w = {k: placement.join(p, dev).requires_grad_()
                     for k, p in params.items()}
                traffic["gather_bytes"] += sum(
                    away(p, w[k].element_size()) for k, p in params.items())
                part = {k: v[idx.to(v.device)].to(dev)
                        for k, v in mb.items()}
                terms.append(model_zoo.loss_terms(cfg, w, part))
                leaves.append(w)
            loss, metrics = model_zoo.combine_loss(cfg, terms)
            grads = torch.autograd.grad(
                loss, [t for w in leaves for t in w.values()],
                allow_unused=True)
        del terms
        it = iter(grads)
        with torch.no_grad():
            for w in leaves:
                for k in w:
                    g = next(it)
                    if g is None:            # no gradient: a zero one
                        continue
                    traffic["reduce_bytes"] += away(acc[k],
                                                    g.element_size())
                    for b, (ap,) in placement.aligned(acc[k]):
                        ap += g[acc[k].slices(b)].to(ap.device).float()
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics

    def train_step(state: TrainState, batch: Dict[str, placement.Placed]):
        params = state.params
        for k, p in params.items():
            if not isinstance(p, placement.Placed) or p.mesh is not mesh:
                raise ValueError(f"{k}: the sharded step takes a state "
                                 f"placed on its mesh")
        gspecs = grad_shardings or {k: p.spec for k, p in params.items()}
        whole = {k: (placement.join(v, home)
                     if isinstance(v, placement.Placed) else v.to(home))
                 for k, v in batch.items()}
        acc = {k: placement.zeros(p.shape, torch.float32, gspecs[k], mesh)
               for k, p in params.items()}
        mbs = (_split_microbatches(whole, tcfg.accum_steps)
               if tcfg.accum_steps > 1 else [whole])
        lsum = torch.zeros((), dtype=torch.float32, device=home)
        for mb in mbs:
            loss, metrics = microbatch(params, mb, acc)
            lsum = lsum + loss
        loss = lsum / tcfg.accum_steps if tcfg.accum_steps > 1 else loss
        grads = {}
        for k, p in params.items():
            g = acc.pop(k)
            if g.spec != p.spec:                  # to the param layout
                g = placement.place(placement.join(g), p.spec, mesh)
            for _, (gp,) in placement.aligned(g):
                if tcfg.accum_steps > 1:
                    gp.div_(tcfg.accum_steps)
                elif p.dtype != torch.float32:    # the step's grad dtype
                    gp.copy_(gp.to(p.dtype))
            grads[k] = g

        err = state.err
        if tcfg.compression.enabled and err is not None:
            compression.compress_placed(grads, err, tcfg.compression)

        opt = state.opt
        with torch.no_grad():
            sq = [gp.float().square().sum().to(home)
                  for g in grads.values() for _, gp in g.blocks()]
            gnorm = torch.sqrt(sum(sq))
            clip = optimizer.clip_factor(tcfg.opt, gnorm)
            step = int(opt.step) + 1
            factors = optimizer.step_factors(tcfg.opt, step)
            for k, p in params.items():
                for _, (pp, gp, mp, vp) in placement.aligned(
                        p, grads[k], opt.mu[k], opt.nu[k]):
                    optimizer.update_leaf(tcfg.opt, k, pp, gp, mp, vp,
                                          clip.to(pp.device), factors)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm,
                       lr=torch.tensor(factors[0], dtype=torch.float32))
        return TrainState(params, OptState(
            torch.tensor(step, dtype=torch.int32), opt.mu, opt.nu),
            err), metrics

    train_step.traffic = traffic
    return train_step


# ---------------------------------------------------------------------------
# Fault-tolerant loop
# ---------------------------------------------------------------------------


class PreemptionError(RuntimeError):
    """Raised by fault-injection hooks to simulate a node loss."""


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep: int = 3


class Trainer:
    """Checkpoint/restart training loop on ``device`` (default the
    card; raises without one unless ``device="cpu"``).

    ``fault_hook(step)`` (tests only) may raise :class:`PreemptionError`;
    callers re-instantiate the Trainer to model a restarted job, and
    ``run`` resumes from the newest complete checkpoint — the data stream
    is seekable, so the resumed run sees the uninterrupted run's
    batches."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, lcfg: LoopConfig,
                 make_batches: Callable[[int], Iterator[Dict[str, Any]]],
                 seed: int = 0,
                 fault_hook: Optional[Callable[[int], None]] = None,
                 device: DeviceLike = "cuda"):
        self.cfg, self.tcfg, self.lcfg = cfg, tcfg, lcfg
        self.device = resolve(device)
        self.make_batches = make_batches
        self.fault_hook = fault_hook
        self.step_fn = make_train_step(cfg, tcfg, self.device)
        self.state = init_state(
            torch.Generator(device=self.device).manual_seed(seed), cfg, tcfg)
        self.start_step = 0
        self.step_times: list = []
        if lcfg.ckpt_dir:
            latest = ckpt_lib.latest_step(lcfg.ckpt_dir)
            if latest is not None:
                self.state, _ = ckpt_lib.restore(
                    lcfg.ckpt_dir, latest, self.state)
                self.start_step = latest
        self.history: list = []

    def _save(self, step: int) -> None:
        if self.lcfg.ckpt_dir:
            ckpt_lib.save(self.lcfg.ckpt_dir, step, self.state)
            ckpt_lib.gc_old(self.lcfg.ckpt_dir, self.lcfg.keep)

    def straggler_ratio(self) -> float:
        """p95/p50 of recent step wall-times — Eq (1) applied to steps."""
        if len(self.step_times) < 4:
            return 1.0
        t = np.asarray(self.step_times[-64:])
        return float(np.percentile(t, 95) / max(np.percentile(t, 50), 1e-9))

    def run(self) -> Dict[str, Any]:
        batches = self.make_batches(self.start_step)
        for step in range(self.start_step, self.lcfg.total_steps):
            if self.fault_hook:
                self.fault_hook(step)
            batch = next(batches)
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, batch)
            loss = metrics["loss"].item()   # sync point = step boundary
            self.step_times.append(time.perf_counter() - t0)
            self.history.append({"step": step + 1, "loss": loss})
            nxt = step + 1
            if self.lcfg.ckpt_dir and nxt % self.lcfg.ckpt_every == 0:
                self._save(nxt)
        if self.lcfg.ckpt_dir and self.lcfg.total_steps % self.lcfg.ckpt_every:
            self._save(self.lcfg.total_steps)
        return {"history": self.history,
                "straggler_ratio": self.straggler_ratio()}
