"""Where the time goes in one endpoint's prefill and decode on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile
    PYTHONPATH=src python -m repro_torch.launch.profile --slots 2
    PYTHONPATH=src python -m repro_torch.launch.profile --page-size 16
    PYTHONPATH=src python -m repro_torch.launch.profile \\
        --arch qwen2-moe-a2.7b

Builds ``--arch`` at full width (default stablelm-1.6b; bf16, random
weights drawn on the card from seed 0), fills an
:class:`~repro_torch.serving.engine.Endpoint` of ``--slots`` rows (the
cloud tier's 16, or the edge's 2) with prompts of 64, 128, 256, 384 or
512 tokens (lengths the recurrent families' scans admit) in a
1024-token cache (a paged pool of ``--page-size`` pages, no prefix
cache, when given), then measures, after a warm-up:

* the wall time of one prefill and of one ``decode_all`` step (host
  clock around work that ends in a synchronize, median of runs);
* a ``torch.profiler`` trace of 16 decode steps: device time by
  kernel name (top entries), the device's busy share of the unprofiled
  median step's wall time,
  and its split (:func:`breakdown`) into the port's attention kernels,
  and for a MoE model the routed expert products, the shared experts and
  the routing / dispatch / combine glue (device time under the
  :func:`moe_spans` ranges), and the rest.

Prints one JSON object as its last line.  Needs a card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import check_fits, resolve
from repro_torch.kernels import ops
from repro_torch.models import model_zoo, moe
from repro_torch.serving.engine import Endpoint

_ATTN = ("flash_fwd", "decode_fwd")   # the port's kernel symbols
MAX_LEN = 1024                         # the continuum's cache length
PROMPTS = (64, 128, 256, 384, 512)     # the main path's prompt lengths
STEPS = 16                             # decode steps under the profiler
SEED = 0

#: the MoE helpers timed under a profiler range each, by category
MOE_SPANS = {"_experts": "moe.expert_products",
             "_shared": "moe.shared_experts",
             "_route": "moe.routing_glue", "_slots": "moe.routing_glue",
             "_dispatch": "moe.routing_glue", "_combine": "moe.routing_glue"}


@contextlib.contextmanager
def moe_spans():
    """Within the block, each MoE helper of :data:`MOE_SPANS` runs under
    a ``torch.profiler.record_function`` range of its category (the model
    code carries no profiling hooks)."""
    saved = {name: getattr(moe, name) for name in MOE_SPANS}

    def spanned(fn, label):
        def run(*a, **kw):
            with torch.profiler.record_function(label):
                return fn(*a, **kw)
        return run

    for name, fn in saved.items():
        setattr(moe, name, spanned(fn, MOE_SPANS[name]))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(moe, name, fn)


def breakdown(prof, n: int) -> dict:
    """Device ms a call (``n`` calls profiled) by category: ``total``,
    ``attention`` (K1-K3), each :data:`MOE_SPANS` range's, and ``rest``.
    A range's time is the device time of the kernels its ops launched
    (the profiler's CPU tree), or, where that is empty, of its GPU
    annotation; annotations never count as kernels."""
    spans = set(MOE_SPANS.values())
    kernels, attn, tree, annot = 0.0, 0.0, {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            if e.name in spans:
                annot[e.name] = annot.get(e.name, 0.0) + us
                continue
            kernels += us
            if any(a in e.name for a in _ATTN):
                attn += us
        elif e.name in spans:
            tree[e.name] = tree.get(e.name, 0.0) + e.device_time_total
    out = {"total": kernels / 1e3 / n, "attention": attn / 1e3 / n}
    for name in sorted(spans & (set(tree) | set(annot))):
        out[name] = (tree.get(name) or annot.get(name, 0.0)) / 1e3 / n
    out["rest"] = out["total"] - sum(v for k, v in out.items()
                                     if k != "total")
    return out


def _wall(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b",
                    choices=list(configs.ARCHS))
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=None,
                    help="profile a paged endpoint with pages of this size")
    args = ap.parse_args()

    dev = resolve("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_config(args.arch)
    check_fits(cfg, dev)
    params = model_zoo.init(cfg, torch.Generator(device=dev).manual_seed(SEED))
    ep = Endpoint(cfg, params, slots=args.slots, max_len=MAX_LEN,
                  device=dev, paged=args.page_size is not None,
                  page_size=args.page_size or 16, prefix_cache=False)
    rng = np.random.default_rng(SEED)
    prompts = {}
    for _ in range(args.slots):
        s = ep.try_claim()
        L = int(rng.choice(PROMPTS))
        prompts[s] = rng.integers(0, cfg.vocab_size, L).astype(np.int32)
    toks = ep.prefill_batch(prompts)

    # one prefill of slot 0's prompt (re-filling that slot each time)
    probe = prompts[0]
    prefill_s = _wall(lambda: ep.prefill_batch({0: probe}), 3)

    def step():
        nonlocal toks
        toks = ep.decode_all(toks)

    for _ in range(3):
        step()                                     # warm-up
    decode_s = _wall(step, 5)

    ops.reset_launches()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with moe_spans(), torch.profiler.profile(activities=acts) as prof:
        for _ in range(STEPS):
            step()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    split = breakdown(prof, STEPS)
    launches = dict(ops.launches)

    by_name = {}                  # kernel name -> [device us, launches]
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.name not in MOE_SPANS.values()):
            acc = by_name.setdefault(e.name, [0.0, 0])
            acc[0] += e.time_range.elapsed_us()
            acc[1] += 1
    rows = sorted(((n, us, c) for n, (us, c) in by_name.items()),
                  key=lambda r: -r[1])
    if not rows:
        raise RuntimeError("the profiler recorded no device activity")
    device_us = sum(r[1] for r in rows)
    print(f"card: {torch.cuda.get_device_name(0)}, {cfg.name}")
    print(f"prefill of {len(probe)} tokens: {prefill_s * 1e3:.3f} ms; "
          f"decode step of {args.slots} rows: {decode_s * 1e3:.3f} ms")
    busy = device_us / 1e6 / STEPS / decode_s
    print(f"profiled {STEPS} decode steps: wall {wall * 1e3:.3f} ms "
          f"(the profiler's own cost included), device busy "
          f"{device_us / 1e3:.3f} ms, {100 * busy:.1f}% of the unprofiled "
          f"median step; launches {launches}")
    for name, us, n in rows[:15]:
        print(f"  {us / 1e3:9.3f} ms  {n:6d}x  {name[:100]}")
    print("device ms a step by category: " + ", ".join(
        f"{k} {v:.4f}" for k, v in split.items()))
    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "arch": cfg.name,
        "slots": args.slots, "step_breakdown_ms": split,
        "page_size": args.page_size,
        "max_len": MAX_LEN, "prefill_tokens": len(probe),
        "prefill_ms": prefill_s * 1e3, "decode_step_ms": decode_s * 1e3,
        "profiled_steps": STEPS, "wall_ms": wall * 1e3,
        "device_busy_ms": device_us / 1e3,
        "device_busy_share": busy,
        "launches": launches,
        "top": [{"name": n[:120], "ms": us / 1e3, "count": c}
                for n, us, c in rows[:15]]}))


if __name__ == "__main__":
    main()
