"""Serving engine: a continuous-batching endpoint over one model.

The port's counterpart of ``repro/serving/engine.py``.  One
:class:`Endpoint` wraps a (config, params) pair and a KV cache pool:
requests claim and release slots independently, and one decode step
advances every active slot.  Latency per request is what feeds the
paper's Eq (1).

The endpoint holds a *reference* to the params it is given: every tier
of a continuum serves the one set of weights (3.3 GB at full width in
bf16), never a copy.

The pool has two layouts:

* **dense** (default): one ``max_len`` cache row per slot.
* **paged** (``paged=True``): ``total_pages`` pages of ``page_size``
  tokens (:class:`~repro_torch.cache.PagePool`) plus one null page that
  pads every page table.  A request claims a page table sized to its
  extent; requests with the same prompt share its pages through the
  :class:`~repro_torch.cache.PrefixRegistry` (copy-on-write past the fork
  point), and an exact-prompt hit skips prefill entirely.  Decode reads
  the pool in place through the page tables (kernel K3 on the card),
  where the reference gathers pages into the dense view and scatters the
  written page back; the token stream equals the dense one.  A leaf
  pages by the reference's rule (``model_zoo.paged_leaves``: its length
  axis has extent ``max_len``); the others (hymba's rolling-window
  stacks and SSM state) stay per slot as "residual" leaves, filled by
  prefill and carried by migration with the row.  Migration payloads
  (:class:`PagedRow`) carry only the used pages and the residual rows.

Prefill is bucketed as in the reference: prompts are grouped by length,
each group runs at a power-of-two batch (the last real row repeated) on
a fresh small dense cache whose real rows are then copied into the pool
(into the claimed pages, when paged).  The dense family also pads each
group to a power-of-two length; a recurrent family (hymba's SSM state,
rwkv6's WKV state) threads its state through every token, and the MoE
family's expert capacity follows each row's length, so neither is ever
length-padded.
Decode masks inactive rows, so a retired row's cache (KV rows and
recurrent state) stays bit for bit as it was while its neighbours
decode.  Greedy argmax happens on the host.

Every leaf of every family's cache has its slot on axis 1 (per-layer
stacks lead, ``models/transformer.py``), so ``leaf[:, s]`` serves every
row operation: reset, extract, insert and the prefill group copy.

With a ``mesh`` whose ``"model"`` axis is wider than 1 the endpoint
serves tensor-parallel (:mod:`repro_torch.serving.sharded`): its params
and cache are lists with one dict a shard, each on its device, and the
dense/sharded choice of model functions is made once, in ``__init__``.
The row operations act on every shard; a row leaves as the full logical
row (kv heads concatenated) and lands split by heads, so its bytes do
not depend on the mesh, and it moves only between endpoints of equal
``tp``.  A sharded endpoint's ``device`` is its first shard's: tokens go
up and the gathered logits come back there.

:func:`make_serve_step` gives the pure prefill and decode functions the
dry run counts, on one device or, single-controller, over a
``(data, model)`` mesh by the ``"serve"`` tables.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.cache import (PagePool, PrefixRegistry, pages_for_tokens,
                               pages_needed, token_extent)
from repro_torch import placement
from repro_torch.device import DeviceLike, resolve
from repro_torch.launch import sharding as launch_sharding
from repro_torch.models import model_zoo
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import POSITION_LEAVES
from repro_torch.serving import sharded
from repro_torch.sharding import Spec


@dataclasses.dataclass
class Request:
    """One inference request (token ids in, token ids out)."""
    rid: int
    tokens: np.ndarray            # (prompt_len,)
    max_new: int = 8
    arrival_s: float = 0.0
    # filled by the engine:
    output: Optional[np.ndarray] = None
    t_first: float = 0.0
    t_done: float = 0.0
    # charged end-to-end latency as the platform accounts it
    latency_s: Optional[float] = None
    # set when a bounded gateway rejects/drops the request (the live 503)
    failed: bool = False


@dataclasses.dataclass
class PagedRow:
    """One extracted paged row, the migration payload: each paged leaf
    narrowed to the ``n_pages`` pages covering the row's filled
    positions (shape (n, n_pages, page, ...)), plus the row's residual
    leaves, the ones the pool does not page (rolling-window stacks,
    recurrent state; shape (n, 1, ...))."""
    n_pages: int
    pos: int
    page_leaves: Dict[str, torch.Tensor]
    resid_leaves: Dict[str, torch.Tensor]

    @property
    def nbytes(self) -> float:
        return float(sum(l.numel() * l.element_size()
                         for leaves in (self.page_leaves, self.resid_leaves)
                         for l in leaves.values()))


def _upload(device: torch.device, *arrays: np.ndarray,
            dtype=torch.int32) -> Tuple[torch.Tensor, ...]:
    """Host integer arrays as tensors on ``device``, in their shapes.  On
    a card they travel packed in one pinned buffer with one copy that
    does not wait for the stream (a pageable copy would)."""
    flat = [np.asarray(a).reshape(-1) for a in arrays]
    if device.type == "cpu":
        host = torch.from_numpy(np.concatenate(flat)).to(dtype)
        dev = host
    else:
        host = torch.empty(sum(f.size for f in flat), dtype=dtype,
                           pin_memory=True)
        np.concatenate(flat, out=host.numpy(), casting="unsafe")
        dev = host.to(device, non_blocking=True)
    out, at = [], 0
    for a, f in zip(arrays, flat):
        out.append(dev[at:at + f.size].view(np.shape(a)))
        at += f.size
    return tuple(out)


class Endpoint:
    """A deployed model ("Knative Service" analogue) on one tier.

    ``slots`` is the max concurrent sequences; requests batch up to
    ``slots`` per decode step.  With ``paged=True`` the KV pool is
    ``total_pages`` pages of ``page_size`` tokens (default: ``slots``
    full rows) and admission is bounded by pages, not slots alone;
    ``prefix_cache`` keeps up to ``prefix_capacity`` prompts resident.
    ``device`` defaults to ``"cuda"`` and must hold ``params`` already (no
    silent copies); ``device="cpu"`` runs the plain attention versions on
    the CPU.  ``mesh`` (a :class:`~repro_torch.launch.mesh.Mesh` over
    devices of that kind) serves tensor-parallel over its ``"model"``
    axis, with the params sharded from the ones given.
    """

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 8,
                 max_len: int = 256, device: DeviceLike = "cuda",
                 paged: bool = False, page_size: int = 16,
                 total_pages: Optional[int] = None,
                 prefix_cache: bool = True, prefix_capacity: int = 64,
                 mesh=None):
        self.device = resolve(device)
        for name, p in params.items():
            if p.device.type != self.device.type:
                raise ValueError(
                    f"param {name!r} lives on {p.device}, endpoint device "
                    f"is {self.device}: move the weights once, before "
                    f"deploying")
        self._tp = int(mesh.shape["model"]) if mesh is not None else 1
        if self._tp > 1 and paged:
            raise ValueError(
                "paged=True is not supported on tensor-parallel endpoints "
                "(page gather/scatter would cross the kv-head sharding)")
        if self._tp > 1:
            devices = sharded.model_devices(mesh)
            if any(d.type != self.device.type for d in devices):
                raise ValueError(f"mesh devices {devices} are not of the "
                                 f"endpoint's kind {self.device.type!r}")
            self.device = devices[0]
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.slot_pos = np.zeros(slots, np.int32)          # next position
        self.slot_free = [True] * slots
        self.peak_active = 0
        self.paged = bool(paged)
        self.page_size = int(page_size)
        self._len_axes = model_zoo.len_axes(cfg, max_len)
        #: the leaves the pool pages (empty for a dense pool); the rest
        #: are per slot
        self._paged: Tuple[str, ...] = ()
        if self.paged:
            if not (0 < page_size <= max_len) or max_len % page_size:
                raise ValueError(
                    f"page_size must divide max_len ({max_len}), "
                    f"got {page_size}")
            self._paged = model_zoo.paged_leaves(cfg, max_len)
            if not self._paged:
                raise ValueError(
                    f"model family {cfg.family!r} has no pageable cache "
                    "leaves (no full-context KV blocks)")
            self.pages_per_row = max_len // page_size
            if total_pages is None:
                total_pages = slots * self.pages_per_row
            if total_pages < self.pages_per_row:
                raise ValueError(
                    f"total_pages={total_pages} cannot hold one full row "
                    f"({self.pages_per_row} pages)")
            self.total_pages = int(total_pages)
            self.pool: Optional[PagePool] = PagePool(self.total_pages,
                                                     self.page_size)
            self.prefix: Optional[PrefixRegistry] = (
                PrefixRegistry(self.pool, prefix_capacity)
                if prefix_cache else None)
            # the reserved always-empty page that pads every table to a
            # fixed (slots, pages_per_row) shape
            self._null_page = self.total_pages
            self._tables: List[Optional[List[int]]] = [None] * slots
            self._table_np = np.full((slots, self.pages_per_row),
                                     self._null_page, np.int32)
            # exact-prompt hits pending their (free) first token
            self._pending_first: Dict[int, Tuple[int, int]] = {}
            # miss claims carrying a registrable prompt
            self._claim_meta: Dict[int, Optional[np.ndarray]] = {}
            self.prefill_hit_tokens = 0
            self.prefill_total_tokens = 0
            row = model_zoo.init_cache(cfg, 1, max_len, self.device)
            self.cache = model_zoo.init_paged_pool(
                cfg, slots, max_len, self.total_pages, self.page_size, row)
        else:
            self.pages_per_row = 0
            self.total_pages = 0
            self.pool = None
            self.prefix = None
            row = model_zoo.init_cache(cfg, 1, max_len, self.device)
        # The model-function indirection: the dense/sharded choice is made
        # here, once, and every pool operation below stays shared.  A
        # cache leaf splits and joins by its spec here (none: one piece).
        self._cache_specs: Dict[str, Spec] = {}
        if self._tp > 1:
            self._prefill_fn, self._decode_fn, pspecs, self._cache_specs = \
                sharded.make_tp_functions(cfg, mesh, row)
            self.params = sharded.shard_params(params, mesh, pspecs)
            self._new_cache = functools.partial(sharded.init_cache, cfg,
                                                mesh)
        else:
            def prefill_fn(params, tokens, lengths, cache):
                return model_zoo.prefill(cfg, params, {"tokens": tokens},
                                         cache, lengths=lengths)

            def decode_fn(params, cache, tokens, t, active=None, **paging):
                return model_zoo.decode(cfg, params, cache, tokens, t,
                                        active, **paging)

            def new_cache(batch, max_len):
                return model_zoo.init_cache(cfg, batch, max_len, self.device)

            self._prefill_fn, self._decode_fn = prefill_fn, decode_fn
            self._new_cache = new_cache
        if not self.paged:
            self.cache = self._new_cache(slots, max_len)
        # Single-row init template of the per-slot leaves, built once:
        # reset_slot restores a row from it instead of materializing a
        # pool-sized init.  The paged leaves keep only their shapes
        # (cache_nbytes_per_row); their pages are scrubbed on allocation.
        self._row_init = {name: leaf.to("meta") if name in self._paged
                          else leaf for name, leaf in row.items()}
        # Length padding is sound only for the dense family: causal
        # masking hides padded positions there, but recurrent state
        # threads through every token, and MoE expert capacity follows
        # the row's length (padding tokens would compete for expert
        # slots).  It must also stay within the rolling window (padding
        # must not wrap over live keys).
        self._pad_len = cfg.family == "dense"
        self._len_cap = max_len
        if cfg.sliding_window is not None:
            self._len_cap = min(self._len_cap, cfg.sliding_window)

    # -- slot management ---------------------------------------------------
    @property
    def active(self) -> int:
        return sum(not f for f in self.slot_free)

    def try_claim(self, tokens: Optional[np.ndarray] = None,
                  max_new: int = 1,
                  reserve_tokens: Optional[int] = None) -> Optional[int]:
        """Claim the lowest free slot; None when the pool is full.

        A paged claim also reserves pages, sized from the request
        (``tokens``/``max_new``), from an explicit token extent
        (``reserve_tokens``, where a migrated row lands) or, with no size,
        a full row; an exact prompt match in the prefix registry shares
        the resident prompt pages and arms a compute-free prefill.  A
        failed paged claim allocates nothing.  A dense pool ignores the
        sizes."""
        slot = next((i for i, free in enumerate(self.slot_free) if free),
                    None)
        if slot is None:
            return None
        if self.paged and not self._claim_pages(slot, tokens, max_new,
                                                reserve_tokens):
            return None
        self.slot_free[slot] = False
        self.peak_active = max(self.peak_active, self.active)
        return slot

    def reset_slot(self, slot: int) -> None:
        """Restore one slot's per-slot cache rows from the single-row
        template (attention rows are self-healing and prefill starts every
        row from a fresh cache, so the serving path never calls it).  A
        paged pool's pages are scrubbed when they are allocated; only its
        residual leaves are per slot."""
        for s, shard in enumerate(self._cache_shards()):
            for name, leaf in shard.items():
                if name not in self._paged:
                    leaf[:, slot] = self._split(
                        name, self._row_init[name])[s][:, 0].to(leaf.device)

    def release(self, slot: int) -> None:
        self.slot_free[slot] = True
        self.slot_pos[slot] = 0
        if self.paged:
            table = self._tables[slot]
            if table is not None:
                self.pool.release(table)
            self._tables[slot] = None
            self._table_np[slot] = self._null_page
            self._pending_first.pop(slot, None)
            self._claim_meta.pop(slot, None)

    # -- the cache's shards ------------------------------------------------
    def _cache_shards(self, cache=None) -> list:
        """``cache`` (default the pool) as its list of shard dicts: the
        list itself when sharded, ``[cache]`` when not."""
        cache = self.cache if cache is None else cache
        return cache if self._tp > 1 else [cache]

    def _split(self, name: str, leaf: torch.Tensor) -> list:
        """A logical leaf (or row) of cache leaf ``name`` as its shards'
        pieces, in shard order."""
        return sharded.split(leaf, self._cache_specs.get(name, ()), self._tp)

    def _join(self, name: str, pieces: list) -> torch.Tensor:
        """The logical leaf (or row) of ``name`` from its shards' pieces,
        a new tensor on the endpoint's device."""
        return sharded.join(pieces, self._cache_specs.get(name, ()),
                            self.device)

    # -- paged bookkeeping (reference engine.py:598-705) -------------------
    @property
    def free_pages(self) -> int:
        return self.pool.free_pages if self.paged else 0

    @property
    def used_pages(self) -> int:
        return self.pool.used_pages if self.paged else 0

    def page_need(self, prompt_len: int, max_new: int) -> int:
        """Pages a fresh request of this size must be able to reserve
        (sharing-blind: an admission bound, never an overclaim)."""
        if not self.paged:
            return 0
        return pages_needed(prompt_len, max_new, self.page_size, self.max_len)

    def pages_for(self, n_tokens: int) -> int:
        """Pages reserving positions ``[0, n_tokens)`` (a full row past
        ``max_len``: the rolling wrap touches every page)."""
        if not self.paged:
            return 0
        if n_tokens > self.max_len:
            return self.pages_per_row
        return max(1, pages_for_tokens(n_tokens, self.page_size))

    def resident_page_demand(self) -> int:
        """Pages referenced by live page tables (a shared page counts once
        per table: a demand signal, not an occupancy count)."""
        return sum(len(t) for t in self._tables if t is not None)

    @property
    def admissible_pages(self) -> int:
        """Pages a new claim could obtain: free pages plus pages pinned
        only by the prefix registry (:meth:`_alloc` evicts those under
        pressure)."""
        pinned: set = set()
        for t in self._tables:
            if t is not None:
                pinned.update(t)
        return self.pool.num_pages - len(pinned)

    @property
    def pool_nbytes(self) -> float:
        """Bytes of the KV page pool (paged) or of the per-slot leaves
        that grow with ``max_len`` (dense): the denominator of resident
        requests per GB, as the reference counts it."""
        names = (self._paged if self.paged else
                 [n for n, axis in self._len_axes.items() if axis is not None])
        shards = self._cache_shards()
        total = 0
        for n in names:       # a replicated leaf's bytes count once
            spec = self._cache_specs.get(n, ())
            held = shards if sharded.shard_axis(spec) is not None \
                else shards[:1]
            total += sum(sh[n].numel() * sh[n].element_size() for sh in held)
        return float(total)

    @property
    def prefill_hit_rate(self) -> float:
        """Share of offered prefill tokens whose KV was already resident
        (exact prefix hits; 0 before any prefill)."""
        if not self.paged or self.prefill_total_tokens == 0:
            return 0.0
        return self.prefill_hit_tokens / self.prefill_total_tokens

    def _alloc(self, n: int) -> Optional[List[int]]:
        """Pool allocation with registry back-pressure: while the free
        list falls short, evict the LRU prefix entry and retry, so no
        request is refused memory that only the registry holds."""
        ids = self.pool.alloc(n)
        while ids is None and self.prefix is not None and len(self.prefix):
            self.prefix.evict_lru()
            ids = self.pool.alloc(n)
        return ids

    def _scrub(self, pids: List[int]) -> None:
        """Reset freshly allocated pages to the init values (k/v 0, pos
        -1: a recycled page must not revive its last owner's positions),
        one indexed fill per leaf over all layers."""
        if not pids:
            return
        idx, = _upload(self.device, np.asarray(pids), dtype=torch.long)
        for name in self._paged:
            self.cache[name].index_fill_(1, idx,
                                         -1 if name.endswith("pos") else 0)

    def _copy_page(self, src: int, dst: int) -> None:
        """The device half of a copy-on-write fork (all layers at once)."""
        for name in self._paged:
            leaf = self.cache[name]
            leaf[:, dst] = leaf[:, src]

    def _set_table(self, slot: int, table: List[int]) -> None:
        self._tables[slot] = table
        self._table_np[slot] = self._null_page
        self._table_np[slot, :len(table)] = table

    def _cow_page(self, slot: int, wp: int) -> None:
        """Copy-on-write fork page ``wp`` of ``slot``'s table."""
        table = self._tables[slot]
        fresh = self._alloc(1)
        if fresh is None:
            raise RuntimeError(
                f"page pool exhausted during copy-on-write (slot {slot})")
        self._copy_page(table[wp], fresh[0])
        self.pool.release([table[wp]])
        table[wp] = fresh[0]
        self._table_np[slot, wp] = fresh[0]

    def _grow_table(self, slot: int) -> None:
        """Append one scrubbed page (a row decoding past its
        reservation)."""
        fresh = self._alloc(1)
        if fresh is None:
            raise RuntimeError(
                f"page pool exhausted growing slot {slot}'s table")
        self._scrub(fresh)
        self._tables[slot].append(fresh[0])
        self._table_np[slot, len(self._tables[slot]) - 1] = fresh[0]

    def _claim_pages(self, slot: int, tokens, max_new: int,
                     reserve_tokens: Optional[int]) -> bool:
        page = self.page_size
        if reserve_tokens is not None or tokens is None:
            n = (self.pages_for(reserve_tokens)
                 if reserve_tokens is not None else self.pages_per_row)
            ids = self._alloc(n)
            if ids is None:
                return False
            self._scrub(ids)
            self._set_table(slot, ids)
            return True
        L = len(tokens)
        extent = token_extent(L, max_new)
        wrap = extent > self.max_len
        n_total = pages_needed(L, max_new, page, self.max_len)
        hit = (None if (wrap or self.prefix is None)
               else self.prefix.lookup(tokens))
        if hit is None:
            ids = self._alloc(n_total)
            if ids is None:
                return False
            self._scrub(ids)
            self._set_table(slot, ids)
            # a wrapping row rewrites every page, so its prompt pages can
            # never be pinned immutable: not registrable
            self._claim_meta[slot] = (np.asarray(tokens, np.int32)
                                      if (self.prefix is not None
                                          and not wrap) else None)
            return True
        # Exact-prompt hit: reference the resident prompt pages; the page
        # the first decode write lands in must be private (COW fork).
        n_pref = len(hit.page_ids)
        cow_partial = extent > L and L % page != 0
        fresh_needed = (n_total - n_pref) + (1 if cow_partial else 0)
        # retain BEFORE allocating: _alloc may evict this very entry
        # under pressure, and our references must keep its pages alive
        self.pool.retain(hit.page_ids)
        fresh = self._alloc(fresh_needed)
        if fresh is None:
            self.pool.release(hit.page_ids)
            return False
        table = list(hit.page_ids)
        fi = 0
        if cow_partial:
            cow = fresh[fi]
            fi += 1
            self._copy_page(table[L // page], cow)
            self.pool.release([table[L // page]])
            table[L // page] = cow
        tail = fresh[fi:]
        if tail:
            self._scrub(tail)
            table += tail
        self._set_table(slot, table)
        self._pending_first[slot] = (hit.first_token, hit.length)
        return True

    # -- row state ---------------------------------------------------------
    def compatible_with(self, other: "Endpoint") -> bool:
        """Row states move between two endpoints iff they serve the same
        model (the same config object) at the same context budget with the
        same pool layout and tensor-parallel width, on the same device:
        every shipped leaf then has the same non-slot dimensions.  Pool
        sizes may differ."""
        return (other.cfg is self.cfg and other.max_len == self.max_len
                and other.paged == self.paged
                and (not self.paged or other.page_size == self.page_size)
                and other._tp == self._tp
                and other.device == self.device)

    def extract_rows(self, slots: List[int]) -> list:
        """Copy the given slots' cache state out of the pool, the unit a
        migration ships to a peer endpoint.  Dense: one dict per slot, each
        leaf with the slot axis narrowed to 1, cloned on the pool's device
        (stablelm-1.6b at ``max_len`` 1024 holds 24 layers x k/v x 1024
        positions x 2048 x 2 B, about 201 MB a row).  Paged: a
        :class:`PagedRow` with only the pages covering the row's filled
        positions, and the row's residual leaves."""
        if not self.paged:
            shards = self._cache_shards()
            return [{name: self._join(name, [sh[name][:, s:s + 1]
                                              for sh in shards])
                     for name in shards[0]} for s in slots]
        out = []
        for s in slots:
            pos = int(self.slot_pos[s])
            n = min(self.pages_for(max(pos, 1)), len(self._tables[s]))
            idx, = _upload(self.device, np.asarray(self._tables[s][:n]),
                           dtype=torch.long)
            out.append(PagedRow(
                n, pos, {name: self.cache[name][:, idx]
                         for name in self._paged},
                {name: leaf[:, s:s + 1].clone()
                 for name, leaf in self.cache.items()
                 if name not in self._paged}))
        return out

    def insert_rows(self, rows: list, slots: List[int],
                    positions: List[int]) -> None:
        """Write extracted row states into *claimed* slots of this pool and
        set their decode positions (decode resumes with no re-prefill).
        Paged rows land in the slot's reserved pages, grown on demand, and
        their residual leaves in the slot's rows."""
        for state, slot, pos in zip(rows, slots, positions):
            if not self.paged:
                for i, shard in enumerate(self._cache_shards()):
                    for name, leaf in shard.items():
                        leaf[:, slot:slot + 1] = self._split(
                            name, state[name])[i].to(leaf.device)
            else:
                while len(self._tables[slot]) < state.n_pages:
                    self._grow_table(slot)
                idx, = _upload(self.device,
                               np.asarray(self._tables[slot][:state.n_pages]),
                               dtype=torch.long)
                for name, leaf in state.page_leaves.items():
                    self.cache[name][:, idx] = leaf.to(self.device)
                for name, leaf in state.resid_leaves.items():
                    self.cache[name][:, slot:slot + 1] = leaf.to(self.device)
            self.slot_pos[slot] = min(pos, self.max_len)

    def cache_nbytes_per_row(self, length: int) -> float:
        """Logical bytes of one slot's live cache state at decode position
        ``length``, what a migration ships over a link: leaves with a
        length axis count only their filled positions, rounded up to
        whole pages when paged; leaves without one (recurrent state, a
        rolling window narrower than ``max_len``) count in full.
        Computed from shapes and dtypes, never from device buffers."""
        if self.paged:
            eff = min(self.pages_for(max(length, 1)) * self.page_size,
                      self.max_len)
        else:
            eff = min(length, self.max_len)
        total = 0
        for name, leaf in self._row_init.items():
            per_row = leaf.numel() * leaf.element_size()
            axis = self._len_axes[name]
            total += (per_row if axis is None
                      else per_row // leaf.shape[axis] * eff)
        return float(total)

    # -- steps -------------------------------------------------------------
    @torch.no_grad()
    def prefill_batch(self, prompts: Dict[int, np.ndarray]) -> Dict[int, int]:
        """Prefill claimed slots' prompts; returns slot -> first generated
        token.  In a paged pool a slot whose claim hit the prefix registry
        skips compute (its prompt pages are resident and the registered
        first token seeds its stream); the rest prefill and register
        their prompts.  A hit leaves the slot's residual leaves as they
        were, as the reference's does (``repro/serving/engine.py:945-961``):
        for hymba the window rows and SSM state are then not the
        prompt's, and its stream leaves the dense one (ROADMAP §3)."""
        if not self.paged:
            return self._prefill_groups(prompts)
        self.prefill_total_tokens += sum(len(t) for t in prompts.values())
        out: Dict[int, int] = {}
        miss: Dict[int, np.ndarray] = {}
        for slot, toks in prompts.items():
            pend = self._pending_first.pop(slot, None)
            if pend is not None:
                first, L = pend
                self.slot_pos[slot] = L
                self.prefill_hit_tokens += L
                out[slot] = first
            else:
                miss[slot] = toks
        if miss:
            out.update(self._prefill_groups(miss))
        return out

    def _prefill_groups(self, prompts: Dict[int, np.ndarray]
                        ) -> Dict[int, int]:
        """Pack prompts into shared prefill calls, grouped by length, each
        at a power-of-two batch (capped at the pool) and, for the dense
        family, a power-of-two length, on a fresh small cache whose real
        rows are copied into the pool."""
        by_len: Dict[int, List[Tuple[int, np.ndarray]]] = {}
        for slot, toks in prompts.items():
            by_len.setdefault(len(toks), []).append((slot, toks))
        out: Dict[int, int] = {}
        for L, group in sorted(by_len.items()):
            G = len(group)
            Bp = min(self.slots, max(1, 1 << (G - 1).bit_length()))
            Lb = L
            if self._pad_len:
                cand = 1 << max(L - 1, 0).bit_length()
                if L <= cand <= self._len_cap:
                    Lb = cand
            # pad the batch to the pow2 bucket by repeating the last row
            tok = np.zeros((Bp, Lb), np.int32)
            for i in range(Bp):
                tok[i, :L] = group[min(i, G - 1)][1]
            lengths = (torch.full((Bp,), L, dtype=torch.int32,
                                  device=self.device)
                       if self._pad_len else None)
            small = self._new_cache(Bp, self.max_len)
            logits, small = self._prefill_fn(
                self.params, torch.as_tensor(tok, device=self.device),
                lengths, small)
            # copy the G real rows into the pool (the repeated rows hold
            # identical values, so they are left out of the copy)
            if self.paged:
                self._adopt_group(group, small, L)
            else:
                idx = torch.as_tensor([slot for slot, _ in group],
                                      device=self.device)
                for shard, rows in zip(self._cache_shards(),
                                       self._cache_shards(small)):
                    for name, leaf in shard.items():
                        leaf[:, idx.to(leaf.device)] = rows[name][:, :G]
            first = logits[:G].argmax(dim=-1).cpu().numpy()
            for i, (slot, _) in enumerate(group):
                self.slot_pos[slot] = L
                out[slot] = int(first[i])
                if self.paged:
                    self._register_prefix(slot, out[slot])
        return out

    def _adopt_group(self, group, small, L: int) -> None:
        """Copy one prefilled length group's rows into their slots: the
        first ``pages_for(L)`` pages of each row into its reserved pages,
        one indexed copy per paged leaf over all layers and rows, and the
        residual leaves into the slots' rows.  Positions in
        ``[L, n*page)`` carry pos >= L (padded bucket) or -1 and stay
        masked until decode overwrites them."""
        n, page = self.pages_for(max(L, 1)), self.page_size
        G = len(group)
        idx, slots = _upload(self.device,
                             np.concatenate([self._tables[slot][:n]
                                             for slot, _ in group]),
                             np.asarray([slot for slot, _ in group]),
                             dtype=torch.long)
        for name, leaf in self.cache.items():
            if name in self._paged:
                rows = small[name][:, :G, :n * page]
                leaf.index_copy_(1, idx, rows.reshape(
                    leaf.shape[0], G * n, page, *leaf.shape[3:]))
            else:
                leaf.index_copy_(1, slots, small[name][:, :G])

    def _register_prefix(self, slot: int, first_token: int) -> None:
        """Publish a just-prefilled prompt to the prefix registry.  The
        registry's pages must stay immutable while the owner decodes on,
        so a partly filled last page is registered as a private copy (the
        full pages are shared as they are: the owner never rewrites
        positions below its prompt length)."""
        meta = self._claim_meta.pop(slot, None)
        if meta is None or self.prefix is None:
            return
        L = len(meta)
        n = self.pages_for(max(L, 1))
        reg_ids = list(self._tables[slot][:n])
        copied = None
        if L % self.page_size != 0:
            cp = self._alloc(1)
            if cp is None:
                return                 # pool too tight to pin: skip
            self._copy_page(reg_ids[-1], cp[0])
            reg_ids[-1] = cp[0]
            copied = cp
        self.prefix.register(meta, reg_ids, first_token)
        if copied is not None:
            # the registry holds its own reference now (or declined to)
            self.pool.release(copied)

    @torch.no_grad()
    def decode_all(self, tokens_by_slot: Dict[int, int]) -> Dict[int, int]:
        """One decode step for every active slot: ``tokens_by_slot`` maps
        slot -> last emitted token; returns slot -> next token.  Slots
        outside it are masked inactive: their cache rows are not written.

        A paged pool first makes every stepping row's write page private
        (copy-on-write fork of a shared page, one page grown for a row
        decoding past its reservation), then uploads the page tables once
        for all layers."""
        tok = np.zeros(self.slots, np.int32)
        act = np.zeros(self.slots, bool)
        t = np.asarray(self.slot_pos, np.int32)
        for s, v in tokens_by_slot.items():
            tok[s] = v
            act[s] = True
        if not self.paged:
            tok_d, t_d = _upload(self.device, tok, t)
            logits, self.cache = self._decode_fn(
                self.params, self.cache, tok_d, t_d, torch.from_numpy(act))
        else:
            for s in tokens_by_slot:
                wp = (int(self.slot_pos[s]) % self.max_len) // self.page_size
                while wp >= len(self._tables[s]):
                    self._grow_table(s)
                if self.pool.is_shared(self._tables[s][wp]):
                    self._cow_page(s, wp)
            tok_d, t_d, tables = _upload(self.device, tok, t, self._table_np)
            logits, self.cache = self._decode_fn(
                self.params, self.cache, tok_d, t_d, torch.from_numpy(act),
                page_tables=tables, paged=self._paged)
        nxt = logits.argmax(dim=-1).cpu().numpy()
        out = {}
        for s in tokens_by_slot:
            self.slot_pos[s] += 1
            out[s] = int(nxt[s])
        return out


# ---------------------------------------------------------------------------
# The serve step the dry run counts
# ---------------------------------------------------------------------------

def make_serve_step(cfg: ModelConfig, mode: str, device: DeviceLike = "cuda",
                    *, mesh=None, serve_mode: str = "serve") -> Callable:
    """The pure prefill or decode function of one configuration (no
    endpoint state): the counterpart of the reference's
    ``make_serve_step`` (``repro/serving/engine.py:1138``), which its dry
    run lowers on a mesh.

    mode="prefill": ``(params, batch, cache) -> (last_logits, cache)``
    mode="decode":  ``(params, cache, tokens, t) -> (logits, cache)``

    The cache is written in place and returned.  Without ``mesh`` the
    step runs ``model_zoo.prefill`` / ``decode`` on ``device`` (default
    the card; raises without one) with its params and cache there.

    With ``mesh`` (a ``launch/mesh.Mesh``) it takes the params, cache and
    inputs placed by :func:`serve_placement` (params by
    ``param_shardings(cfg, mesh, serve_mode)``, the cache by
    ``cache_shardings(..., "serve")``, the inputs by ``batch_shardings``)
    and is single-controller, as the sharded train step and the
    tensor-parallel endpoint are.  For each data replica (an index of the
    mesh's ``("pod", "data")`` axes, at ``"model"`` 0) it joins every
    weight whole onto the replica's device, joins its rows' cache blocks
    (the ``"serve"`` cache splits the positions over ``"model"``), runs
    the family's prefill or decode there (through the kernels on a card)
    and writes the rows' new cache entries back into their blocks: all of
    them after a prefill, a decode step only the position it wrote (and
    the recurrent state, which it rewrites whole).  So the ``"model"``
    axis shards storage, not compute.  A batch the rule leaves
    replicated (long_500k's one row) runs on the first replica alone.
    The logits come back on the first replica's device.

    ``serve_step.traffic`` counts the bytes a mesh would move: the
    weight and cache blocks a replica's position does not hold
    (``weights``, ``cache``), the entries written back to other
    positions (``writeback``, replicas included) and the logits gathered
    to the first replica (``logits``).
    ``launch/serve_cost.serve_step_counts`` gives the same counts in
    closed form."""
    if mode not in ("prefill", "decode"):
        raise ValueError(f"unknown serve mode {mode!r}; the modes are "
                         f"'prefill' and 'decode'")
    if serve_mode not in ("serve", "serve_replicated"):
        raise ValueError(f"unknown serve_mode {serve_mode!r}")
    if mesh is not None:
        return _mesh_serve_step(cfg, mode, mesh, serve_mode)
    dev = resolve(device)
    if mode == "prefill":
        def serve_step(params, batch, cache):
            return model_zoo.prefill(
                cfg, params, {k: v.to(dev) for k, v in batch.items()}, cache)
    else:
        def serve_step(params, cache, tokens, t):
            return model_zoo.decode(cfg, params, cache, tokens.to(dev),
                                    t.to(dev))
    return serve_step


def serve_placement(cfg: ModelConfig, mesh, params, cache, inputs,
                    serve_mode: str = "serve"):
    """(params, cache, inputs) placed on ``mesh`` as a serve step over it
    takes them: the params by ``param_shardings(cfg, mesh, serve_mode)``,
    the cache by ``cache_shardings(cfg, cache, mesh, "serve")`` and the
    inputs (a prefill's batch, or a decode step's ``{"tokens", "t"}``)
    by ``batch_shardings``."""
    psh = launch_sharding.param_shardings(cfg, mesh, serve_mode)
    csh = launch_sharding.cache_shardings(cfg, cache, mesh, "serve")
    bsh = launch_sharding.batch_shardings(inputs, mesh)

    def tree(d, specs):
        return {k: placement.place(v, specs[k], mesh) for k, v in d.items()}
    return tree(params, psh), tree(cache, csh), tree(inputs, bsh)


def _mesh_serve_step(cfg: ModelConfig, mode: str, mesh,
                     serve_mode: str) -> Callable:
    """The serve step over ``mesh`` (see :func:`make_serve_step`)."""
    homes = placement.replica_coords(
        mesh, tuple(a for a in ("pod", "data") if a in mesh.axis_names))
    want = launch_sharding.param_shardings(cfg, mesh, serve_mode)
    traffic = {"weights": 0, "cache": 0, "writeback": 0, "logits": 0}

    def check(tree, what: str) -> None:
        for k, p in tree.items():
            if not isinstance(p, placement.Placed) or p.mesh is not mesh:
                raise ValueError(f"{what} {k}: the serve step over a mesh "
                                 f"takes tensors placed on that mesh")
            if what == "param" and p.spec != want[k]:
                raise ValueError(f"param {k} is placed by {p.spec}; the "
                                 f"{serve_mode!r} layout is {want[k]}")

    def run(params, inputs, cache):
        check(params, "param")
        check(inputs, "input")
        check(cache, "cache leaf")
        lead = inputs["tokens"]
        t = (placement.join(inputs["t"], "cpu").tolist()
             if mode == "decode" else None)
        done, outs = set(), []
        for coord in homes:
            blk = lead.block_of(coord)
            if blk[0] in done:          # the rows of a replica already run
                continue
            done.add(blk[0])
            rows = lead.slices(blk)[0]
            dev = mesh.devices[coord]
            w = {}
            for k, p in params.items():
                w[k], n = placement.take(p, coord, dev)
                traffic["weights"] += n
            x = {k: placement.take(p, coord, dev, {0: rows})[0]
                 for k, p in inputs.items()}
            c = {}
            for k, p in cache.items():
                c[k], n = placement.take(p, coord, dev, {1: rows})
                traffic["cache"] += n
            if mode == "prefill":
                logits, c = model_zoo.prefill(cfg, w, x, c)
            else:
                logits, c = model_zoo.decode(cfg, w, c, x["tokens"],
                                             x["t"])
            del w
            for k, p in cache.items():
                if mode == "prefill" or \
                        k.rpartition("/")[2] not in POSITION_LEAVES:
                    traffic["writeback"] += placement.put(p, c[k], coord,
                                                          {1: rows})
                    continue
                W = p.shape[2]
                for i in range(rows.start, rows.stop):
                    s = t[i] % W
                    j = i - rows.start
                    traffic["writeback"] += placement.put(
                        p, c[k][:, j:j + 1, s:s + 1], coord,
                        {1: slice(i, i + 1), 2: slice(s, s + 1)})
            del c
            outs.append((coord, logits))
        home = mesh.devices[homes[0]]
        for _, lg in outs[1:]:
            traffic["logits"] += lg.numel() * lg.element_size()
        logits = torch.cat([lg.to(home) for _, lg in outs]) \
            if len(outs) > 1 else outs[0][1]
        return logits, cache

    if mode == "prefill":
        def serve_step(params, batch, cache):
            return run(params, batch, cache)
    else:
        def serve_step(params, cache, tokens, t):
            return run(params, {"tokens": tokens, "t": t}, cache)
    serve_step.traffic = traffic
    return serve_step
