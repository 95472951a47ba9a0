"""Dry run of the sharded train step on the production meshes: the
port's counterpart of ``repro/launch/dryrun.py``'s train cells.

The reference lowers and compiles every (architecture x shape) cell on
the (16, 16) and (2, 16, 16) meshes and reads memory, roofline terms and
collective bytes off the compiled program.  Eager PyTorch lowers
nothing, so the port counts each train cell in closed form
(``launch/train_cost.train_step_counts``) on the ``roofline.H100_SXM5``
record: derived counts, not measurements.  The prefill and decode cells
are not ported (ROADMAP item 8c).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single \\
        --arch qwen2.5-14b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Each cell prints the reference's line and writes
``<out-dir>/<mesh>/<arch>__<shape>.json`` (default ``build/dryrun``,
which git ignores).  It needs no device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Any, Dict, List, Optional

from repro_torch import configs
from repro_torch.launch import presets, train_cost

MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "build", "dryrun")


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             out_dir: Optional[str] = None) -> Dict[str, Any]:
    """Count one train cell; returns (and writes) its record."""
    cfg = configs.get_config(arch)
    shape = configs.SHAPES[shape_name]
    mesh = MESHES[mesh_kind]
    tcfg = dataclasses.replace(
        presets.train_preset(cfg, shape.global_batch),
        dp_axes=tuple(a for a in ("pod", "data") if a in mesh))
    c = train_cost.train_step_counts(cfg, tcfg, mesh, shape)
    roof = c.pop("roofline")
    mf = c["model_flops_per_device"]
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "chips": roof.chips, "kind": shape.kind, "counts": "closed-form",
        "hardware": roof.hw.name, "accum_steps": tcfg.accum_steps,
        "moment_dtype": str(tcfg.opt.moment_dtype).replace("torch.", ""),
        **c,
        "memory": {"argument_size_in_bytes": c["argument_bytes"],
                   "per_device_total": c["argument_bytes"]
                   + c["gathered_bytes"]},
        "roofline": roof.to_dict(),
        "roofline_fraction": (mf / roof.hw.peak_flops / roof.step_s
                              if roof.step_s else 0.0),
    }
    out_dir = os.path.join(out_dir or OUT_DIR, mesh_kind)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{arch}__{shape_name}.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


def line(r: Dict[str, Any]) -> str:
    """The reference's per-cell line, the compile time replaced by the
    counts' kind."""
    rf = r["roofline"]
    return (f"[{r['mesh']}] {r['arch']} x {r['shape']}: OK closed-form "
            f"mem/dev={r['memory']['per_device_total'] / 2**30:.2f}GiB "
            f"compute={rf['compute_s'] * 1e3:.2f}ms "
            f"memory={rf['memory_s'] * 1e3:.2f}ms "
            f"collective={rf['collective_s'] * 1e3:.2f}ms "
            f"dominant={rf['dominant']} "
            f"roofline_frac={r['roofline_fraction']:.3f}")


def main(argv: Optional[List[str]] = None) -> List[Dict[str, Any]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=list(configs.ARCHS))
    ap.add_argument("--shape", default=None, choices=list(configs.SHAPES))
    ap.add_argument("--mesh", default="both",
                    choices=("single", "multi", "both"))
    ap.add_argument("--all", action="store_true",
                    help="every valid train cell")
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args(argv)

    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    if args.all:
        cells = [(a, s) for a, s in configs.valid_cells()
                 if configs.SHAPES[s].kind == "train"]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape required unless --all is given")
        if configs.SHAPES[args.shape].kind != "train":
            ap.error(f"{args.shape} is a {configs.SHAPES[args.shape].kind} "
                     f"cell; the port's dry run counts train cells "
                     f"(ROADMAP item 8c)")
        cells = [(args.arch, args.shape)]
    out = []
    for mesh_kind in meshes:
        for arch, shape in cells:
            r = run_cell(arch, shape, mesh_kind, args.out_dir)
            print(line(r), flush=True)
            out.append(r)
    return out


if __name__ == "__main__":
    main()
