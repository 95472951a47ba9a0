"""Tensors placed on a device mesh by a partition spec.

The single-controller counterpart of a ``jax.Array`` under a
``NamedSharding``: a :class:`Placed` tensor holds one piece per mesh
position, the block of the whole tensor that the position's device owns
under ``spec`` (``repro_torch.sharding.Spec``: one entry per dimension,
a mesh axis name, a tuple of them, or None).  A dimension split over
several mesh axes counts its blocks over them in order, the first the
most significant, as ``NamedSharding`` does; positions that differ only
along axes the spec does not use hold the same block (replicas).

Replicas on one device are one tensor (``forced_devices`` puts a whole
mesh on one device, so a replicated leaf costs its bytes once); on
distinct devices each has its copy.  :func:`place` splits a tensor into
its grid of pieces and :func:`join` concatenates the blocks back, bit for
bit.  The tensor-parallel endpoint keeps its own one-axis split and join
(``serving/sharded.py``); these serve the train state, which shards two
dimensions ("embed" over "data", heads / ffn / vocab over "model") and
its batch over ("pod", "data").  :func:`take` and :func:`put` read and
write a region of a placed tensor (a serve step's rows, a decode step's
written positions), counting the bytes a mesh would move.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.sharding import Spec

Block = Tuple[int, ...]


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def grid_counts(spec: Spec, mesh: Any, ndim: int) -> Tuple[int, ...]:
    """The number of blocks along each of ``ndim`` dimensions."""
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's "
                         f"{ndim} dimensions")
    entries = tuple(spec) + (None,) * (ndim - len(spec))
    return tuple(math.prod(mesh.shape[a] for a in _axes(e))
                 for e in entries)


def block_at(spec: Spec, mesh: Any, coord: Tuple[int, ...],
             ndim: int) -> Block:
    """The block index, dimension by dimension, that mesh position
    ``coord`` (indices in ``mesh.axis_names`` order) owns."""
    at = dict(zip(mesh.axis_names, coord))
    out = []
    for i in range(ndim):
        axes = _axes(spec[i]) if i < len(spec) else ()
        idx = 0
        for a in axes:
            idx = idx * mesh.shape[a] + at[a]
        out.append(idx)
    return tuple(out)


def block_slices(shape: Tuple[int, ...], counts: Tuple[int, ...],
                 block: Block) -> Tuple[slice, ...]:
    """The slices of ``block`` in a tensor of ``shape``."""
    out = []
    for n, k, b in zip(shape, counts, block):
        if n % k:
            raise ValueError(f"a dimension of {n} does not split into "
                             f"{k} blocks (shape {tuple(shape)})")
        w = n // k
        out.append(slice(b * w, (b + 1) * w))
    return tuple(out)


@dataclasses.dataclass(eq=False)
class Placed:
    """A tensor of ``shape`` and ``dtype`` split over ``mesh`` by
    ``spec``; ``pieces`` is an object array of the mesh's shape holding
    each position's block, on the position's device."""

    pieces: np.ndarray
    spec: Spec
    mesh: Any
    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def counts(self) -> Tuple[int, ...]:
        return grid_counts(self.spec, self.mesh, len(self.shape))

    def block_of(self, coord: Tuple[int, ...]) -> Block:
        return block_at(self.spec, self.mesh, coord, len(self.shape))

    def slices(self, block: Block) -> Tuple[slice, ...]:
        return block_slices(self.shape, self.counts, block)

    def blocks(self) -> Iterator[Tuple[Block, torch.Tensor]]:
        """Each block once, with the piece of its first mesh position."""
        seen = set()
        for coord in np.ndindex(self.pieces.shape):
            b = self.block_of(coord)
            if b not in seen:
                seen.add(b)
                yield b, self.pieces[coord]


def _build(shape, dtype, spec, mesh, make) -> Placed:
    """A Placed whose piece at each (block, device) is ``make(block,
    device)``, made once per distinct (block, device)."""
    shape = tuple(int(n) for n in shape)
    counts = grid_counts(spec, mesh, len(shape))
    made: Dict[Tuple[Block, torch.device], torch.Tensor] = {}
    pieces = np.empty(mesh.devices.shape, dtype=object)
    for coord in np.ndindex(mesh.devices.shape):
        dev = mesh.devices[coord]
        b = block_at(spec, mesh, coord, len(shape))
        if (b, dev) not in made:
            made[(b, dev)] = make(block_slices(shape, counts, b), dev)
        pieces[coord] = made[(b, dev)]
    return Placed(pieces, tuple(spec), mesh, shape, dtype)


def place(t: torch.Tensor, spec: Spec, mesh: Any) -> Placed:
    """``t`` split over ``mesh`` by ``spec``: each piece a contiguous
    copy of its block on its device."""
    def make(sl, dev):
        return torch.empty(t[sl].shape, dtype=t.dtype,
                           device=dev).copy_(t[sl])
    return _build(t.shape, t.dtype, spec, mesh, make)


def zeros(shape, dtype: torch.dtype, spec: Spec, mesh: Any) -> Placed:
    """A zero tensor placed by ``spec``, each piece made on its device."""
    def make(sl, dev):
        return torch.zeros([s.stop - s.start for s in sl], dtype=dtype,
                           device=dev)
    return _build(shape, dtype, spec, mesh, make)


def join(p: Placed, device=None) -> torch.Tensor:
    """The whole tensor, a new tensor on ``device`` (default: the first
    position's), its blocks concatenated in order; bit for bit the
    tensor :func:`place` split."""
    device = torch.device(device) if device is not None else \
        p.pieces.flat[0].device
    counts = p.counts
    grid = np.empty(counts, dtype=object)
    for b, piece in p.blocks():
        grid[b] = piece
    for coord in np.ndindex(p.pieces.shape):     # prefer a local copy
        piece = p.pieces[coord]
        if piece.device == device:
            grid[p.block_of(coord)] = piece

    if math.prod(counts) == 1:
        return grid.flat[0].to(device, copy=True)

    def cat(prefix: Block, d: int) -> torch.Tensor:
        if d == len(counts):
            return grid[prefix].to(device)
        parts = [cat(prefix + (i,), d + 1) for i in range(counts[d])]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=d)
    return cat((), 0)


Region = Dict[int, slice]


def _window(shape, region: Optional[Region]) -> List[slice]:
    """``region`` ({dim: slice}, other dimensions whole) as one slice a
    dimension, with concrete bounds."""
    region = region or {}
    return [slice(*region[d].indices(n)[:2]) if d in region else
            slice(0, n) for d, n in enumerate(shape)]


def _overlap(block: Tuple[slice, ...], win: List[slice]):
    """(the block's local slices, the window's local slices) of their
    intersection, or None when they do not meet."""
    inter = [slice(max(a.start, w.start), min(a.stop, w.stop))
             for a, w in zip(block, win)]
    if any(i.start >= i.stop for i in inter):
        return None
    return (tuple(slice(i.start - a.start, i.stop - a.start)
                  for i, a in zip(inter, block)),
            tuple(slice(i.start - w.start, i.stop - w.start)
                  for i, w in zip(inter, win)))


def take(p: Placed, coord: Tuple[int, ...], device,
         region: Optional[Region] = None) -> Tuple[torch.Tensor, int]:
    """The part of ``p`` inside ``region`` ({dim: slice}; default the
    whole tensor), a new tensor on ``device``, bit for bit, and the bytes
    of it that mesh position ``coord`` does not hold (what a mesh would
    move to that position).  The position's own block is read from its
    own piece."""
    win = _window(p.shape, region)
    out = torch.empty([w.stop - w.start for w in win], dtype=p.dtype,
                      device=device)
    own = p.block_of(coord)
    moved = 0
    for b, piece in p.blocks():
        hit = _overlap(p.slices(b), win)
        if hit is None:
            continue
        src = (p.pieces[coord] if b == own else piece)[hit[0]]
        out[hit[1]].copy_(src)
        if b != own:
            moved += src.numel() * src.element_size()
    return out, moved


def put(p: Placed, src: torch.Tensor, coord: Tuple[int, ...],
        region: Optional[Region] = None) -> int:
    """Write ``src``, the part of the tensor inside ``region``, into every
    piece of ``p`` that holds some of it (replicas too), bit for bit;
    returns the bytes written at mesh positions other than ``coord`` (what
    a mesh would move from that position)."""
    win = _window(p.shape, region)
    if tuple(src.shape) != tuple(w.stop - w.start for w in win):
        raise ValueError(f"a {tuple(src.shape)} source for a region of "
                         f"{[w.stop - w.start for w in win]}")
    moved, written = 0, set()
    for c in np.ndindex(p.pieces.shape):
        hit = _overlap(p.slices(p.block_of(c)), win)
        if hit is None:
            continue
        piece = p.pieces[c]
        part = src[hit[1]]
        if id(piece) not in written:
            written.add(id(piece))
            piece[hit[0]].copy_(part)
        if c != tuple(coord):
            moved += part.numel() * part.element_size()
    return moved


def aligned(*leaves: Placed) -> Iterator[Tuple[Block, List[torch.Tensor]]]:
    """Leaves placed alike (one spec, one mesh), piece by piece: each
    distinct piece of the first once, with its block and the pieces of
    every leaf at the same position."""
    seen = set()
    first = leaves[0]
    for coord in np.ndindex(first.pieces.shape):
        t = first.pieces[coord]
        if id(t) not in seen:
            seen.add(id(t))
            yield first.block_of(coord), [l.pieces[coord] for l in leaves]


def replica_coords(mesh: Any, axes: Tuple[str, ...]
                   ) -> List[Tuple[int, ...]]:
    """The mesh position of each index over ``axes`` (in order, the first
    the most significant), every other axis at 0: the data replicas'."""
    sizes = [mesh.shape[a] for a in axes]
    out = []
    for idx in np.ndindex(*sizes):
        at = dict(zip(axes, idx))
        out.append(tuple(at.get(a, 0) for a in mesh.axis_names))
    return out


def replica_devices(mesh: Any, axes: Tuple[str, ...]) -> List[torch.device]:
    """The device of each of :func:`replica_coords`."""
    return [mesh.devices[c] for c in replica_coords(mesh, axes)]
