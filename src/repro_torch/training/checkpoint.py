"""Atomic, self-describing checkpoints: the counterpart of
``repro/training/checkpoint.py``, in its on-disk format.

    <dir>/step_000123/
        manifest.json            # step, {key: shape, dtype}, extra
        <leaf-path>.npy          # one file per leaf, "/" written "__"

* **Atomicity** — a checkpoint is written to ``step_N.tmp/`` and renamed
  into place only after its manifest is fsync'd; :func:`latest_step`
  skips ``.tmp`` and manifest-less directories, so a crash mid-write
  resumes from the last complete checkpoint.
* **Self-describing** — the manifest lists every leaf's key, shape and
  dtype; :func:`restore` validates them against a template and fails
  loudly on a mismatch, with the reference's messages.
* **Mesh-agnostic** — leaves are whole logical arrays: :func:`save`
  joins a leaf placed on a mesh (:mod:`repro_torch.placement`) and
  writes the whole array, and :func:`restore` puts each leaf on
  ``device`` (or its template leaf's device), or, given ``shardings``
  and ``mesh``, splits it onto the mesh's devices.  Source and
  destination meshes never need to match (elastic resharding).

Leaves are keyed as the reference's ``tree_flatten_with_path`` keys
them: a NamedTuple's fields by name, a dict's keys in sorted order, a
sequence's items by index, ``None`` holds no leaf.  So a
``train_loop.TrainState`` written by either package restores in the
other.  A bfloat16 leaf is written as the reference writes it, 2-byte
records under the numpy descr ``'<V2'`` with ``"dtype": "bfloat16"`` in
the manifest, and restored by reinterpreting the bits (no
``ml_dtypes``; ``bridge``'s ``tensor_to_numpy`` and
``tensor_from_numpy`` carry the bits both ways).  The reference's own
``restore`` cannot read such a leaf (``astype`` from ``|V2`` raises),
so only the port restores a bfloat16 checkpoint.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import placement
from repro_torch.bridge import tensor_from_numpy, tensor_to_numpy

PyTree = Any

_MANIFEST = "manifest.json"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree: PyTree, prefix: str = "") -> Dict[str, Any]:
    """{"/"-joined path: leaf}, in the reference's order."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix[:-1]: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}/"))
    return out


def _unflatten(template: PyTree, leaves: Dict[str, Any],
               prefix: str = "") -> PyTree:
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, f"{prefix}{k}/")
                for k, v in template.items()}
    if _is_namedtuple(template):
        return type(template)(*(_unflatten(v, leaves, f"{prefix}{f}/")
                                for f, v in zip(template._fields, template)))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves, f"{prefix}{i}/")
                              for i, v in enumerate(template))
    return leaves[prefix[:-1]]


def _leaf_filename(key: str) -> str:
    return key.replace("/", "__") + ".npy"


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(array to write, manifest dtype); bfloat16 as uint16 bits."""
    if isinstance(leaf, placement.Placed):
        leaf = placement.join(leaf, "cpu")
    if isinstance(leaf, torch.Tensor):
        arr = tensor_to_numpy(leaf)
        if leaf.dtype == torch.bfloat16:
            return arr, "bfloat16"
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _save_leaf(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:             # the reference's bytes
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def save(ckpt_dir: str, step: int, tree: PyTree, *,
         extra: Optional[Dict] = None) -> str:
    """Write one atomic checkpoint.  Returns the final directory path."""
    flat = _flatten(tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for key, leaf in flat.items():
        arr, dtype = _to_numpy(leaf)
        _save_leaf(os.path.join(tmp, _leaf_filename(key)), arr, dtype)
        manifest["leaves"][key] = {"shape": list(arr.shape), "dtype": dtype}
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)           # atomic publish
    return final


def _complete_steps(ckpt_dir: str) -> list:
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp") and \
                os.path.exists(os.path.join(ckpt_dir, name, _MANIFEST)):
            try:
                steps.append(int(name[5:]))
            except ValueError:
                pass
    return sorted(steps)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest *complete* checkpoint (ignores .tmp partials)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _complete_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, template: PyTree,
            device=None, shardings: Optional[PyTree] = None,
            mesh: Any = None) -> Tuple[PyTree, Dict]:
    """Load checkpoint ``step`` into the structure of ``template``.

    ``template``'s leaves are tensors (``meta`` ones will do, or placed
    ones) giving each leaf's expected shape and dtype; every leaf is cast
    to its template's dtype and put on ``device``, or, without one, on
    its template leaf's device (the host for a ``meta`` one).
    ``shardings`` (a tree of specs matching ``template``'s,
    ``launch/sharding.train_state_shardings``; a None spec leaves its
    leaf whole) places each leaf on ``mesh`` instead, but a 0-d leaf
    (the optimizer step) stays on the host, as the port keeps it.
    Returns (tree, extra metadata)."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)

    flat_t = _flatten(template)
    missing = set(flat_t) - set(manifest["leaves"])
    extra_keys = set(manifest["leaves"]) - set(flat_t)
    if missing or extra_keys:
        raise ValueError(f"checkpoint/model mismatch: "
                         f"missing={sorted(missing)[:5]} "
                         f"extra={sorted(extra_keys)[:5]}")

    flat_s = _flatten_specs(shardings, template) if shardings is not None \
        else {}
    if flat_s and mesh is None:
        raise ValueError("restoring onto shardings needs their mesh")
    loaded: Dict[str, Any] = {}
    for key, spec in flat_t.items():
        want = manifest["leaves"][key]
        t = tensor_from_numpy(np.load(os.path.join(d, _leaf_filename(key))),
                              "cpu")
        if list(t.shape) != want["shape"]:
            raise ValueError(f"{key}: manifest/file shape mismatch")
        exp_shape = tuple(spec.shape)
        if tuple(t.shape) != exp_shape:
            raise ValueError(f"{key}: checkpoint {tuple(t.shape)} vs model "
                             f"{exp_shape}")
        if flat_s.get(key) is not None and t.dim() > 0:
            loaded[key] = placement.place(t.to(spec.dtype), flat_s[key],
                                          mesh)
            continue
        where = torch.device(device if device is not None else (
            spec.pieces.flat[0].device if isinstance(spec, placement.Placed)
            else spec.device))
        if where.type == "meta" or (flat_s and t.dim() == 0):
            where = torch.device("cpu")       # e.g. the step, on the host
        loaded[key] = t.to(device=where, dtype=spec.dtype)
    return _unflatten(template, loaded), manifest.get("extra", {})


def _flatten_specs(shardings: PyTree, template: PyTree) -> Dict[str, Any]:
    """{key: spec} of a tree of specs shaped like ``template``: a spec is
    a tuple, so it is read at the template's leaf positions, not
    flattened further."""
    out: Dict[str, Any] = {}

    def walk(spec_tree, tmpl, prefix):
        if tmpl is None or spec_tree is None:
            return
        if isinstance(tmpl, dict):
            for k in tmpl:
                walk(spec_tree[k], tmpl[k], f"{prefix}{k}/")
        elif _is_namedtuple(tmpl):
            for f in tmpl._fields:
                walk(getattr(spec_tree, f), getattr(tmpl, f),
                     f"{prefix}{f}/")
        elif isinstance(tmpl, (list, tuple)):
            for i, (a, b) in enumerate(zip(spec_tree, tmpl)):
                walk(a, b, f"{prefix}{i}/")
        else:
            out[prefix[:-1]] = spec_tree
    walk(shardings, template, "")
    return out


def gc_old(ckpt_dir: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` complete checkpoints."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = _complete_steps(ckpt_dir)
    for s in steps[:-keep] if keep else steps:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
