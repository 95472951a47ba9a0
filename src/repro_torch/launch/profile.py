"""Where the time goes in one endpoint's prefill and decode on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile
    PYTHONPATH=src python -m repro_torch.launch.profile --slots 2
    PYTHONPATH=src python -m repro_torch.launch.profile --page-size 16

Builds the full-width stablelm-1.6b (bf16, random weights drawn on the
card from seed 0), fills an :class:`~repro_torch.serving.engine.Endpoint`
of ``--slots`` rows (the cloud tier's 16, or the edge's 2) with prompts of
64..512 tokens in a 1024-token cache (a paged pool of ``--page-size``
pages, no prefix cache, when given), then measures, after a warm-up:

* the wall time of one bucketed prefill and of one ``decode_all`` step
  (host clock around work that ends in a synchronize, median of runs);
* a ``torch.profiler`` trace of 16 decode steps: device time by
  kernel name (top entries), the device's busy share of the wall time,
  and the share spent in the port's attention kernels.

Prints one JSON object as its last line.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve
from repro_torch.kernels import ops
from repro_torch.models import model_zoo
from repro_torch.serving.engine import Endpoint

_ATTN = ("flash_fwd", "decode_fwd")   # the port's kernel symbols
MAX_LEN = 1024                         # the continuum's cache length
PROMPT_LO, PROMPT_HI = 64, 512         # the main path's prompt range
STEPS = 16                             # decode steps under the profiler
SEED = 0


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
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=None,
                    help="profile a paged endpoint with pages of this size")
    args = ap.parse_args()

    dev = resolve("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_config("stablelm-1.6b")
    params = model_zoo.init(cfg, torch.Generator(device=dev).manual_seed(SEED))
    ep = Endpoint(cfg, params, slots=args.slots, max_len=MAX_LEN,
                  device=dev, paged=args.page_size is not None,
                  page_size=args.page_size or 16, prefix_cache=False)
    rng = np.random.default_rng(SEED)
    prompts = {}
    for _ in range(args.slots):
        s = ep.try_claim()
        L = int(rng.integers(PROMPT_LO, PROMPT_HI + 1))
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
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(STEPS):
            step()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)

    by_name = {}                  # kernel name -> [device us, launches]
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            acc = by_name.setdefault(e.name, [0.0, 0])
            acc[0] += e.time_range.elapsed_us()
            acc[1] += 1
    rows = sorted(((n, us, c) for n, (us, c) in by_name.items()),
                  key=lambda r: -r[1])
    if not rows:
        raise RuntimeError("the profiler recorded no device activity")
    device_us = sum(r[1] for r in rows)
    attn_us = sum(r[1] for r in rows if any(a in r[0] for a in _ATTN))
    print(f"card: {torch.cuda.get_device_name(0)}")
    print(f"prefill of {len(probe)} tokens: {prefill_s * 1e3:.3f} ms; "
          f"decode step of {args.slots} rows: {decode_s * 1e3:.3f} ms")
    print(f"profiled {STEPS} decode steps: wall {wall * 1e3:.3f} ms, "
          f"device busy {device_us / 1e3:.3f} ms "
          f"({100 * device_us / 1e6 / wall:.1f}%), attention kernels "
          f"{attn_us / 1e3:.3f} ms ({100 * attn_us / max(device_us, 1):.1f}% "
          f"of device time); launches {launches}")
    for name, us, n in rows[:15]:
        print(f"  {us / 1e3:9.3f} ms  {n:6d}x  {name[:100]}")
    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "slots": args.slots,
        "page_size": args.page_size,
        "max_len": MAX_LEN, "prefill_tokens": len(probe),
        "prefill_ms": prefill_s * 1e3, "decode_step_ms": decode_s * 1e3,
        "profiled_steps": STEPS, "wall_ms": wall * 1e3,
        "device_busy_ms": device_us / 1e3,
        "device_busy_share": device_us / 1e6 / wall,
        "attention_ms": attn_us / 1e3, "launches": launches,
        "top": [{"name": n[:120], "ms": us / 1e3, "count": c}
                for n, us, c in rows[:15]]}))


if __name__ == "__main__":
    main()
