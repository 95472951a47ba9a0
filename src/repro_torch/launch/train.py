"""Fault-tolerant training launcher (``python -m repro_torch.launch.train``),
the port's ``python -m repro.launch.train``.

Trains ``--arch`` (the smoke config with ``--smoke``, else full width,
weights drawn from ``--seed`` on the device) on the synthetic stream of
``repro_torch.training.data`` through the checkpoint/restart loop of
``training.train_loop.Trainer``, on one device: the card by default,
``--device cpu`` for the CPU.  Before building anything on the card it
checks that the parameters, their gradients, the Adam moments, the
float32 gradient accumulator and the error-feedback buffer fit.  The
reference's ``--use-pallas`` has no counterpart: the port picks its
kernels by the tensors' device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch \\
        stablelm-1.6b --smoke --steps 50 --batch 8 --seq 128 \\
        --device cpu --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch \\
        stablelm-1.6b --batch 8 --seq 2048 --accum 2 --steps 6

Fault tolerance contract (``tests/test_torch_train_loop.py``):
  * atomic checkpoints every ``--ckpt-every`` steps (tmp dir + rename);
  * on start, auto-resume from the newest complete checkpoint;
  * the data stream is seekable: a resumed run consumes the same batches
    as an uninterrupted one.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch import configs
from repro_torch.device import check_fits, resolve
from repro_torch.training import compression, data
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_loop import (LoopConfig, TrainConfig,
                                             Trainer, state_bytes)


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    """Parse ``argv`` (default ``sys.argv[1:]``), train, print the
    summary line and return the finished :class:`Trainer`."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(configs.ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 error-feedback gradient compression")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve(args.device)
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    tcfg = TrainConfig(
        opt=OptimizerConfig(peak_lr=args.lr, warmup_steps=args.warmup,
                            total_steps=args.steps),
        accum_steps=args.accum,
        compression=compression.CompressionConfig(
            enabled=args.compress_grads))
    check_fits(cfg, device, state_bytes(cfg, tcfg),
               "parameters, gradients, moments and accumulators")
    lcfg = LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every)
    dcfg = data.DataConfig(seed=args.seed, batch=args.batch,
                           seq_len=args.seq)

    trainer = Trainer(cfg, tcfg, lcfg,
                      lambda start: data.stream(cfg, dcfg, start),
                      seed=args.seed, device=device)
    if trainer.start_step:
        print(f"resumed from step {trainer.start_step}")
    out = trainer.run()
    hist = out["history"]
    print(f"steps={len(hist)} first_loss={hist[0]['loss']:.4f} "
          f"last_loss={hist[-1]['loss']:.4f} "
          f"straggler_ratio={out['straggler_ratio']:.2f}")
    return trainer


if __name__ == "__main__":
    main()
