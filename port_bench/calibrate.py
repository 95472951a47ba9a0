"""Readings for a cell's correctness limit, in one process: for each seed,
a whole run of the cell (the program, at the cell's size and load) and,
on the control's seeds, the control on the same compared sample (the
reference in the precision the cell's limit file names as ``control``,
put in the program's place).  With ``--fault``, every run has that fault
of :mod:`pbench.faults` planted in its decode path.  Not run by the
benchmark's own runs.

    python3 port_bench/calibrate.py --workload stablelm-1.6b.batch-long \\
        --seeds 101,102,103 --seconds 10 [--control-seeds 101,102,103] \\
        [--fault state]

Prints one JSON line a seed (the program's numbers, and the control's
for the control's seeds) and a summary line: for each number, the
program's largest reading (the lower one) and the control's smallest
(the upper one).
"""

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:0] = [str(ROOT / "port_bench"), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--fault", default="", help="a fault of pbench.faults")
    args = ap.parse_args()
    from pbench import bench, correct, faults, spec
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    cell = spec.Cell(spec.load_benchmark(ROOT), args.workload)
    quant = cell.limits["control"]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    prog, ctl = [], []
    for seed in [int(s) for s in args.seeds.split(",")]:
        stash = {}
        t = time.perf_counter()
        with (faults.planted(args.fault) if args.fault
              else contextlib.nullcontext()) as plant:
            out = bench.run_cell(cell, seed, args.seconds, False, stash=stash,
                                 fault=plant, log=lambda *a, **k: None)
        line = {"seed": seed, "fault": args.fault, "correct": out["correct"],
                "attempted": out["attempted"], "failed": out["failed"],
                "program": stash["gaps"],
                "metrics": {k: v["value"] for k, v in out["metrics"].items()},
                "compared": len(stash["picked"]),
                "tokens": sum(len(s.req.output) for s in stash["picked"])}
        prog.append(stash["gaps"])
        if seed in control:
            line["control_" + quant] = correct.control_gaps(
                stash["conf"], stash["params"], stash["picked"], "cuda",
                quant=quant)
            ctl.append(line)
        line["wall_s"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
        del stash, out
        gc.collect()
        torch.cuda.empty_cache()
    summary = {"workload": args.workload, "fault": args.fault,
               "card": torch.cuda.get_device_name(0)}
    for name in correct.COMPARED:
        summary[name] = {
            "program_max": max(p[name] for p in prog),
            quant + "_min": (min(c["control_" + quant][name] for c in ctl)
                             if ctl else None)}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
