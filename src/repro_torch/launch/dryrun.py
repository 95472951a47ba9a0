"""Dry run of the train and serve steps on the production meshes: the
port's counterpart of ``repro/launch/dryrun.py``.

The reference lowers and compiles every (architecture x shape) cell on
the (16, 16) and (2, 16, 16) meshes and reads memory, roofline terms and
collective bytes off the compiled program.  Eager PyTorch lowers
nothing, so the port counts each cell in closed form on the
``roofline.H100_SXM5`` record: derived counts, not measurements.  A
train cell is counted by ``launch/train_cost.train_step_counts`` (the
sharded train step), a prefill or decode cell by
``launch/serve_cost.serve_step_counts`` (``serving/engine``'s
``make_serve_step`` over the mesh, params in the ``--serve-mode``
layout).  ``--serve-mode auto`` takes the reference's rule: weights
replicated over "data" (``serve_replicated``) when a 16th of them in
bf16 is under 8 GB, else ``serve``.  ``--set key=value`` overrides a
config field (the reference's coercion: True / False, int, float, else
the string), ``--accum`` a train cell's microbatch count, and ``--tag``
suffixes the file name (``__<tag>``).  A decode record carries
``decode_step_ms``, the roofline step time a cost-modeled tier adopts.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single \\
        --arch qwen2.5-14b --shape decode_32k --serve-mode auto
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Each cell prints the reference's line and writes
``<out-dir>/<mesh>/<arch>__<shape>[__<tag>].json`` (default
``build/dryrun``, which git ignores).  It needs no device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Any, Dict, List, Optional

from repro_torch import configs
from repro_torch.launch import presets, serve_cost, train_cost

MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "build", "dryrun")


def apply_sets(cfg, sets: Optional[List[str]]):
    """``--set key=value`` config overrides, each value coerced as the
    reference coerces it (``True`` / ``False``, int, float, else the
    string)."""
    if not sets:
        return cfg
    kv: Dict[str, Any] = {}
    for item in sets:
        k, v = item.split("=", 1)
        if v in ("True", "False"):
            kv[k] = v == "True"
            continue
        for kind in (int, float):
            try:
                kv[k] = kind(v)
                break
            except ValueError:
                pass
        else:
            kv[k] = v
    return dataclasses.replace(cfg, **kv)


def resolve_serve_mode(cfg, serve_mode: str) -> str:
    """``auto``: replicate weights over "data" when a 16th of them in
    bf16 stays under 8 GB (the reference's rule), else shard them."""
    if serve_mode != "auto":
        return serve_mode
    return ("serve_replicated" if cfg.param_count() * 2 / 16 < 8e9
            else "serve")


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             out_dir: Optional[str] = None, *, serve_mode: str = "serve",
             sets: Optional[List[str]] = None, accum: Optional[int] = None,
             tag: str = "") -> Dict[str, Any]:
    """Count one cell; returns (and writes) its record."""
    cfg = apply_sets(configs.get_config(arch), sets)
    shape = configs.SHAPES[shape_name]
    mesh = MESHES[mesh_kind]
    if shape.kind == "train":
        tcfg = dataclasses.replace(
            presets.train_preset(cfg, shape.global_batch),
            dp_axes=tuple(a for a in ("pod", "data") if a in mesh))
        if accum is not None:
            tcfg = dataclasses.replace(tcfg, accum_steps=accum)
        c = train_cost.train_step_counts(cfg, tcfg, mesh, shape)
        meta = {"accum_steps": tcfg.accum_steps,
                "moment_dtype": str(tcfg.opt.moment_dtype).replace(
                    "torch.", "")}
    else:
        mode = resolve_serve_mode(cfg, serve_mode)
        c = serve_cost.serve_step_counts(cfg, mesh, shape, serve_mode=mode)
        meta = {"serve_mode": mode}
    roof = c.pop("roofline")
    mf = c["model_flops_per_device"]
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "chips": roof.chips, "kind": shape.kind, "counts": "closed-form",
        "hardware": roof.hw.name, **meta, **c,
        "memory": {"argument_size_in_bytes": c["argument_bytes"],
                   "per_device_total": c["argument_bytes"]
                   + c["gathered_bytes"]},
        "roofline": roof.to_dict(),
        "roofline_fraction": (mf / roof.hw.peak_flops / roof.step_s
                              if roof.step_s else 0.0),
    }
    out_dir = os.path.join(out_dir or OUT_DIR, mesh_kind)
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    with open(os.path.join(out_dir, f"{arch}__{shape_name}{suffix}.json"),
              "w") as f:
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
    ap.add_argument("--all", action="store_true", help="every valid cell")
    ap.add_argument("--serve-mode", default="serve",
                    choices=("serve", "serve_replicated", "auto"))
    ap.add_argument("--set", action="append", default=None,
                    help="config override key=value (repeatable)")
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--tag", default="", help="result filename suffix")
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args(argv)

    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    if args.all:
        cells = configs.valid_cells()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape required unless --all is given")
        if not configs.cell_is_valid(args.arch, args.shape):
            ap.error(f"{args.arch} x {args.shape} is not a valid cell")
        cells = [(args.arch, args.shape)]
    out = []
    for mesh_kind in meshes:
        for arch, shape in cells:
            r = run_cell(arch, shape, mesh_kind, args.out_dir,
                         serve_mode=args.serve_mode, sets=args.set,
                         accum=args.accum, tag=args.tag)
            print(line(r), flush=True)
            out.append(r)
    return out


if __name__ == "__main__":
    main()
