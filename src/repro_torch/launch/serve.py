"""Continuum serving launcher (``python -m repro_torch.launch.serve``).

Boots the weak-edge / strong-cloud pair through the
``repro_torch.platform.Continuum`` facade, deploys one model endpoint via
the replication controller, pushes a ramped open-loop request stream
through the ingress gateway, and reports per round how the traffic
policy split the load — the port's version of ``python -m
repro.launch.serve``.  Runs on the card by default; ``--device cpu``
runs the plain attention versions on the CPU.  ``--full`` serves the
full-width configuration instead of the smoke one (weights are random,
drawn from ``--seed`` on the device).  ``--device-slots N`` puts an
on-device ingress tier in front of the edge (a 3-tier device -> edge ->
cloud chain, waterfall on); ``--net-aware`` is ``--policy auto+net``.
``--scheduler wave`` serves with the run-to-completion wave drain;
``--max-steps-per-tick N`` lets long requests stay slot-resident across
ticks, which is what gives ``+migrate`` rows to move.  ``--page-size N``
serves every tier from a paged KV pool of N-token pages (hymba pages its
global layers and keeps its window rows and SSM state per slot; rwkv6
has no leaf to page and raises).

    PYTHONPATH=src python -m repro_torch.launch.serve --full --rounds 20
    PYTHONPATH=src python -m repro_torch.launch.serve --full \\
        --arch qwen2-moe-a2.7b
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch mixtral-8x7b
    PYTHONPATH=src python -m repro_torch.launch.serve --device-slots 2 \
        --net-aware
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --rounds 6 --policy auto
    PYTHONPATH=src python -m repro_torch.launch.serve --policy \\
        auto+migrate --max-steps-per-tick 4
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch hymba-1.5b --page-size 16
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import check_fits, resolve
from repro_torch.models import model_zoo
from repro_torch.platform import (AutoscalingPolicy, Continuum,
                                  FunctionSpec, LinkSpec, OffloadConfig,
                                  Request, TierSpec, Topology)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b",
                    choices=list(configs.ARCHS))
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--rps-low", type=float, default=1.0)
    ap.add_argument("--rps-high", type=float, default=8.0)
    ap.add_argument("--edge-slots", type=int, default=2)
    ap.add_argument("--cloud-slots", type=int, default=16)
    ap.add_argument("--device-slots", type=int, default=0,
                    help="> 0 adds an on-device ingress tier in front of "
                         "the edge (3-tier device/edge/cloud chain)")
    ap.add_argument("--max-new", type=int, default=4)
    ap.add_argument("--policy", default="auto",
                    help="traffic policy: 0..100 | auto | auto+net | "
                         "auto+hedge | auto+migrate (modifiers compose, "
                         "e.g. auto+net+migrate)")
    ap.add_argument("--net-aware", action="store_true",
                    help="shorthand for --policy auto+net")
    ap.add_argument("--scheduler", default="continuous",
                    choices=("continuous", "wave"),
                    help="continuous-batching decode loop (default) or the "
                         "run-to-completion wave drain")
    ap.add_argument("--max-steps-per-tick", type=int, default=0,
                    help="> 0 caps decode steps per tick so long requests "
                         "stay slot-resident across ticks (continuous "
                         "scheduler only)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--full", action="store_true",
                    help="serve the full-width config, not the smoke one")
    ap.add_argument("--page-size", type=int, default=None,
                    help="serve every tier from a paged KV pool with "
                         "pages of this many tokens")
    args = ap.parse_args()

    device = resolve(args.device)
    cfg = (configs.get_config(args.arch) if args.full
           else configs.get_smoke_config(args.arch))
    check_fits(cfg, device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model_zoo.init(cfg, gen)

    policy = "auto+net" if args.net_aware else args.policy
    sched_kw = dict(scheduler=args.scheduler,
                    max_steps_per_tick=(args.max_steps_per_tick
                                        if args.max_steps_per_tick > 0
                                        else None))
    page = dict(max_len=64, page_size=args.page_size)
    if args.device_slots > 0:
        topo = Topology(
            tiers=(TierSpec("device", slots=args.device_slots, **page),
                   TierSpec("edge", slots=args.edge_slots,
                            extra_latency_s=0.005, **page),
                   TierSpec("cloud", slots=args.cloud_slots,
                            extra_latency_s=0.02, **page)),
            links=(LinkSpec(rtt_s=0.005, bandwidth_Bps=50e6),
                   LinkSpec(rtt_s=0.04, bandwidth_Bps=100e6)))
    else:
        topo = Topology.pair(
            TierSpec("edge", slots=args.edge_slots, **page),
            TierSpec("cloud", slots=args.cloud_slots, extra_latency_s=0.02,
                     queue_depth_per_slot=None, **page))
    cc = Continuum.from_topology(
        topo, policy=policy, offload_cfg=OffloadConfig(), seed=args.seed,
        device=device, **sched_kw)
    spec = FunctionSpec(name=args.arch, arch=args.arch, revision=1,
                        autoscaling=AutoscalingPolicy())
    cc.deploy(spec, cfg, params)

    rng = np.random.default_rng(args.seed)
    rid = 0
    names = [t.name for t in cc.tiers]
    for rnd in range(args.rounds):
        frac = min(rnd / max(args.rounds * 0.5, 1), 1.0)
        rps = args.rps_low + (args.rps_high - args.rps_low) * frac
        n = rng.poisson(rps)
        for _ in range(n):
            toks = rng.integers(0, cfg.vocab_size, size=8).astype(np.int32)
            cc.submit(args.arch, Request(rid=rid, tokens=toks,
                                         max_new=args.max_new))
            rid += 1
        rec = cc.tick()
        per_tier = " ".join(f"{nm}={rec['tiers'][nm]:3d}" for nm in names)
        backlog = sum(rec["backlog"].values())
        mig = (f" migrated={rec['migrated']:2d}"
               if rec["migrations_fired"] or rec["migrated"] else "")
        print(f"round={rnd:3d} rps={rps:5.1f} queued={n:3d} {per_tier} "
              f"steps={rec['steps']:3d} inflight={rec['inflight']:2d} "
              f"backlog={backlog:3d} R_t={rec['R']:5.1f}%{mig}")
    drained = cc.drain()           # finish slot-resident stragglers

    totals = {nm: sum(r["tiers"][nm] for r in cc.log) for nm in names}
    total = sum(totals.values())
    if args.scheduler == "wave":
        rate = (f"reqs_per_wave="
                f"{total / max(sum(r['waves'] for r in cc.log), 1):.1f}")
    else:
        rate = (f"tokens_per_decode_step="
                f"{total * args.max_new / max(sum(r['steps'] for r in cc.log), 1):.1f}")
    c = cc.metrics.counter
    print(f"\nserved {' '.join(f'{nm}={n}' for nm, n in totals.items())} "
          f"offload_frac={(total - totals[names[0]]) / max(total, 1):.2f} "
          f"{rate} drain_ticks={drained} "
          f"spilled={sum(r['spilled'] for r in cc.log)} "
          f"rejected={sum(r['rejected'] for r in cc.log)} "
          f"migrated={int(c('migrations_completed'))} "
          f"migrations_aborted={int(c('migrations_aborted'))} "
          f"hedged={int(c('hedges_fired'))} "
          f"hedges_won={int(c('hedges_won'))} "
          f"hedges_cancelled={int(c('hedges_cancelled'))} "
          f"hedges_open={cc.hedges_open} device={device}")


if __name__ == "__main__":
    main()
