"""The benchmark of ``repro_torch``, the PyTorch and CUDA port: one run of
one cell of ``BENCHMARK.json``.

    python3 port_bench/run.py --workload stablelm-1.6b.batch-long --seed 7 \\
        --seconds 30 --trace 0

from the root of a checkout, on a machine with the cards the cell asks
for.  Prints one JSON object as its last line of standard output
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
beside its limit, which also end standard error).  Exits non-zero with
no result when there is no card, too few cards, or when a module of the
JAX package (or JAX itself) was loaded.

Build and kernel caches stay in the checkout, under ``build/``.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:0] = [str(ROOT / "port_bench"), str(ROOT / "src")]
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    from pbench import bench, spec
    cell = spec.Cell(spec.load_benchmark(ROOT), args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    out = bench.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                         t_process=T_PROCESS)
    found = bench.banned_modules()
    if found:
        print(f"loaded modules of JAX or the JAX package: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
