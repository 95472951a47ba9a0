"""Host time of one controller tick, the scrape included.

    PYTHONPATH=src python -m repro_torch.launch.control_tick
    PYTHONPATH=<checkout>/src python src/repro_torch/launch/control_tick.py \\
        --label parent

The second form times another revision of the port: run by path, the
script imports ``repro_torch`` from ``PYTHONPATH``, so one file times
every checkout with the same loop.  Host clock only; no card is used.

Two shapes, each under every Eq-(1) front end the revision has (the
window; the sketch where ``eq1="sketch"`` constructs) and, where the
loop takes ``vectorized=``, under each of its routes:

* ``chain``: phase 5f of ``chip_smoke.py``: three tiers (two
  boundaries), one function, window 64, ``"auto+net"`` per boundary
  against 50 and 100 MB/s links with ``req_bytes`` 6.0e6;
* ``wide``: one boundary, 1024 functions, ``"auto"``.

A tick is what ``EdgeCloudContinuum.controller_update`` does after the
backlog scrape: read each tier's metrics (``latency_windows(64)``, or
``drain_fresh()`` under the sketch), then step the loop with queue ages
and per-boundary arrivals.  Latencies are recorded from a seeded rng
before each tick, outside the timed span.  Prints one JSON line a case
and, last, one JSON object with all of them.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from repro_torch.core.metrics import MetricsRegistry
from repro_torch.core.policy import ControlLoop, Policy

WINDOW = 64
CHAIN_LINKS = (50e6, 100e6)
CHAIN_REQ_BYTES = 6.0e6


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or "no card"
    except (OSError, subprocess.SubprocessError):
        return "no card"


def _loop(case: str, eq1: str, route):
    kw = {} if route == "default" else {"vectorized": route}
    if eq1 != "window":
        kw["eq1"] = eq1
    if case == "chain":
        pols = [Policy.parse("auto+net", link_bytes_per_s=bw,
                             req_bytes=CHAIN_REQ_BYTES)
                for bw in CHAIN_LINKS]
        return ControlLoop("auto+net", 1, window=WINDOW, num_tiers=3,
                           boundary_policies=pols, **kw)
    return ControlLoop("auto", 1024, window=WINDOW, **kw)


def time_case(case: str, eq1: str, route, ticks: int, warmup: int,
              seed: int = 0) -> dict:
    loop = _loop(case, eq1, route)
    F, B = loop.num_functions, loop.num_boundaries
    tiers = [MetricsRegistry([f"fn{i}" for i in range(F)])
             for _ in range(B)]
    rng = np.random.default_rng(seed)
    per_tick = 40 if case == "chain" else 2 * F
    ms = []
    for t in range(warmup + ticks):
        for reg in tiers:
            rows = rng.integers(0, F, per_tick)
            vals = rng.gamma(2.0, 0.05, per_tick)
            for r, v in zip(rows.tolist(), vals.tolist()):
                reg.windows.record(r, v)
        ages = [[sorted(rng.uniform(0, 2, int(rng.integers(0, 4))).tolist())
                 if f < 8 else [] for f in range(F)] for _ in range(B)]
        arrivals = [rng.integers(0, 9, F) for _ in range(B)]
        t0 = time.perf_counter()
        if eq1 == "sketch":
            loop.step_stream([reg.windows.drain_fresh() for reg in tiers],
                             queue_ages=ages, arrivals=arrivals)
        else:
            lats, valids = zip(*[reg.latency_windows(WINDOW)
                                 for reg in tiers])
            loop.step_tiers(list(lats), list(valids), queue_ages=ages,
                            arrivals=arrivals)
        if t >= warmup:
            ms.append(1e3 * (time.perf_counter() - t0))
    return {"case": case, "F": F, "boundaries": B, "eq1": eq1,
            "route": str(route), "ticks": ticks,
            "median_ms": statistics.median(ms),
            "p95_ms": float(np.percentile(ms, 95)),
            "mean_ms": statistics.fmean(ms)}


def _variants(case: str):
    yield "window", "default"
    try:
        _loop(case, "window", False)
        yield "window", False
        yield "window", True
    except TypeError:
        pass                            # no ``vectorized=`` knob
    try:
        _loop(case, "sketch", "default")
        yield "sketch", "default"
    except (NotImplementedError, TypeError):
        pass                            # a revision without the sketch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="this")
    ap.add_argument("--ticks", type=int, default=200)
    ap.add_argument("--warmup", type=int, default=20)
    args = ap.parse_args(argv)
    card = _card()
    rows = []
    for case in ("chain", "wide"):
        for eq1, route in _variants(case):
            row = time_case(case, eq1, route, args.ticks, args.warmup)
            row.update(label=args.label, torch=torch.__version__,
                       threads=torch.get_num_threads(), card=card)
            print(json.dumps(row), flush=True)
            rows.append(row)
    out = {"label": args.label, "card": card, "rows": rows}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
