"""The benchmark's data: ``BENCHMARK.json`` at the repository root, and the
files it names under ``port_bench/``, each found by its name.

* a cell (``workloads`` entry) names a configuration and a traffic mix;
* a configuration is ``port_bench/configs/<config>.json``: the model's
  published widths under the source's own keys, the tiers it is served
  on, and what was assumed;
* a traffic mix is ``port_bench/traffic/<traffic>.json``: clients,
  length ranges, pre-roll, step cap, drain cap;
* a cell's correctness limit is ``port_bench/limits/<workload>.json``;
* a per-layer metric is ``port_bench/metrics/<metric>.py``, a reader
  with ``read(run) -> float or None``.

Adding a cell, a mix or a metric is adding files and entries; no file
here changes.
"""

from __future__ import annotations

import importlib.util
import json
import math
from pathlib import Path
from typing import Callable, Dict, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
PEAKS_FILE = BENCH_DIR / "peaks.json"


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def load_benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


class Cell:
    """One cell of ``BENCHMARK.json`` with its files loaded."""

    def __init__(self, bench: dict, workload: str, bench_dir: Path = BENCH_DIR):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r}; the cells are "
                           f"{sorted(cells)}")
        self.entry = cells[workload]
        self.name = workload
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = _json(bench_dir.parent / self.config_entry["file"])
        self.traffic_name = self.entry["traffic"]
        self.traffic = _json(bench_dir / "traffic" / f"{self.traffic_name}.json")
        limit_path = bench_dir / "limits" / f"{workload}.json"
        self.limits = _json(limit_path) if limit_path.is_file() else {}
        self.end_to_end = [m for m in bench["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in bench["per_layer"]
                          if workload in m.get("workloads", [workload])]

    def max_len(self) -> int:
        """The tiers' cache length: the configuration's, or, where the
        mix's longest request needs more, the smallest multiple of 64
        that holds its longest prompt and output."""
        need = int(self.traffic["prompt_len"][1]) + int(
            self.traffic["max_new"][1])
        return max(int(self.config["tiers"]["max_len"]),
                   64 * math.ceil(need / 64))


def peaks() -> dict:
    return _json(PEAKS_FILE)


def load_reader(name: str, bench_dir: Path = BENCH_DIR
                ) -> Callable[[object], Optional[float]]:
    """The ``read`` function of ``port_bench/metrics/<name>.py``."""
    path = bench_dir / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for per-layer metric {name!r} "
                                f"({path})")
    spec = importlib.util.spec_from_file_location(
        "pbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_per_layer(cell: Cell, run) -> Dict[str, dict]:
    """Every per-layer metric of the cell whose reader finds something,
    in ``BENCHMARK.json`` order."""
    out: Dict[str, dict] = {}
    for m in cell.per_layer:
        value = load_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out

