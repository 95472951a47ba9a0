"""Training step and fault-tolerant loop on one device: the counterpart
of ``repro/training/train_loop.py``.

``make_train_step`` builds ``(state, batch) -> (state, metrics)``: the
gradients of ``model_zoo.loss`` (``torch.autograd.grad``), summed in
float32 over ``accum_steps`` microbatches and averaged, optionally
through int8 error-feedback compression, then one AdamW update.  The
update is written **in place** into the state, which the step returns
(the counterpart of the reference's ``donate_argnums=(0,)``).  The
batch moves to the parameters' device; on the card every forward of the
attention and scan kernels (K1, K4, K5) launches the kernel, and their
backward differentiates the plain versions, as the reference's
``custom_vjp`` does.

``Trainer`` drives it: auto-resume from the newest complete checkpoint,
periodic atomic saves, a fault hook for the preemption tests, and the
straggler ratio (p95/p50 of recent step walls, the step ending at the
loss's ``.item()``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional

import numpy as np
import torch

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
    """The reference's ``dp_axes`` (the data axes of the compressed
    cross-replica mean) comes with sharded training."""
    opt: OptimizerConfig = OptimizerConfig()
    accum_steps: int = 1
    compression: compression.CompressionConfig = \
        compression.CompressionConfig()


def init_state(generator: torch.Generator, cfg: ModelConfig,
               tcfg: TrainConfig) -> TrainState:
    """Seeded parameters (``model_zoo.init``, on the generator's device),
    zero moments and, with compression, a zero error buffer."""
    params = model_zoo.init(cfg, generator)
    err = compression.init_error(params) if tcfg.compression.enabled \
        else None
    return TrainState(params, optimizer.init(params, tcfg.opt), err)


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
                    device: DeviceLike = "cuda") -> Callable:
    """The train step of one configuration on ``device`` (default the
    card; raises without one): ``(state, batch) -> (state, metrics)``,
    ``state`` updated in place and its parameters on ``device``.  The
    loss is the microbatches' mean; the metrics are the last
    microbatch's, plus ``loss``, ``grad_norm`` and ``lr``."""
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
