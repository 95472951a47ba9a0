"""Serving engine: a continuous-batching endpoint over one model.

The port's counterpart of ``repro/serving/engine.py`` (the dense pool;
the paged pool is not ported yet).  One :class:`Endpoint` wraps a
(config, params) pair and a KV cache pool of ``slots`` rows of
``max_len`` tokens: requests claim and release slots independently, and
one decode step advances every active slot.  Latency per request is what
feeds the paper's Eq (1).

The endpoint holds a *reference* to the params it is given: every tier
of a continuum serves the one set of weights (3.3 GB at full width in
bf16), never a copy.

Prefill is bucketed as in the reference: prompts are grouped by length,
each group runs at a power-of-two batch (the last real row repeated) and
a power-of-two length, on a fresh small cache
whose real rows are then copied into the pool.  Decode masks inactive
rows, so a retired row's cache stays bit-for-bit as it was while its
neighbours decode.  Greedy argmax happens on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve
from repro_torch.models import model_zoo
from repro_torch.models.common import ModelConfig

#: cache leaves are all (L, B, W, ...): slot axis 1, length axis 2
_LEN_AXIS = 2


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


class Endpoint:
    """A deployed model ("Knative Service" analogue) on one tier.

    ``slots`` is the max concurrent sequences; requests batch up to
    ``slots`` per decode step.  ``device`` defaults to ``"cuda"`` and must
    hold ``params`` already (no silent copies); ``device="cpu"`` runs the
    plain attention versions on the CPU.
    """

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 8,
                 max_len: int = 256, device: DeviceLike = "cuda"):
        self.device = resolve(device)
        for name, p in params.items():
            if p.device.type != self.device.type:
                raise ValueError(
                    f"param {name!r} lives on {p.device}, endpoint device "
                    f"is {self.device}: move the weights once, before "
                    f"deploying")
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.slot_pos = np.zeros(slots, np.int32)          # next position
        self.slot_free = [True] * slots
        self.cache = model_zoo.init_cache(cfg, slots, max_len, self.device)
        # Single-row init template, built once: reset_slot restores a row
        # from it instead of materializing a pool-sized init.
        self._row_init = model_zoo.init_cache(cfg, 1, max_len, self.device)
        # Length padding is sound for the dense family (causal masking
        # hides padded positions; the model zoo serves no other family
        # yet) and must stay within the rolling window.
        self._len_cap = max_len
        if cfg.sliding_window is not None:
            self._len_cap = min(self._len_cap, cfg.sliding_window)

    # -- slot management ---------------------------------------------------
    @property
    def active(self) -> int:
        return sum(not f for f in self.slot_free)

    def try_claim(self, tokens: Optional[np.ndarray] = None,
                  max_new: int = 1) -> Optional[int]:
        """Claim the lowest free slot; None when the pool is full.
        (``tokens``/``max_new`` size paged claims in the reference; a
        dense pool ignores them.)"""
        del tokens, max_new
        for i, free in enumerate(self.slot_free):
            if free:
                self.slot_free[i] = False
                return i
        return None

    def reset_slot(self, slot: int) -> None:
        """Restore one slot's cache rows from the single-row template
        (what a recurrent family needs between requests; attention rows
        are self-healing, so the dense main path never calls it)."""
        for name, leaf in self.cache.items():
            leaf[:, slot] = self._row_init[name][:, 0]

    def release(self, slot: int) -> None:
        self.slot_free[slot] = True
        self.slot_pos[slot] = 0

    # -- row state ---------------------------------------------------------
    def extract_rows(self, slots: List[int]) -> List[Dict[str, torch.Tensor]]:
        """Copy the given slots' cache rows out of the pool: one dict per
        slot, each leaf with the slot axis narrowed to size 1 — the unit
        of state a migration ships to a peer endpoint."""
        return [{name: leaf[:, s:s + 1].clone()
                 for name, leaf in self.cache.items()} for s in slots]

    def insert_rows(self, rows: List[Dict[str, torch.Tensor]],
                    slots: List[int], positions: List[int]) -> None:
        """Write extracted row states into *claimed* slots of this pool and
        set their decode positions (decode resumes with no re-prefill)."""
        for state, slot, pos in zip(rows, slots, positions):
            for name, leaf in self.cache.items():
                leaf[:, slot:slot + 1] = state[name].to(leaf.device)
            self.slot_pos[slot] = min(pos, self.max_len)

    def cache_nbytes_per_row(self, length: int) -> float:
        """Logical bytes of one slot's live cache state at decode position
        ``length`` — what a migration ships over a link: leaves with a
        sequence axis count only their filled positions.  Computed from
        shapes and dtypes, never from device buffers."""
        eff = min(length, self.max_len)
        total = 0.0
        for leaf in self._row_init.values():
            per_row = float(np.prod(leaf.shape) * leaf.element_size())
            total += per_row * eff / leaf.shape[_LEN_AXIS]
        return total

    # -- steps -------------------------------------------------------------
    @torch.no_grad()
    def prefill_batch(self, prompts: Dict[int, np.ndarray]) -> Dict[int, int]:
        """Pack claimed slots' prompts into shared prefill calls, grouped
        by length, each at a power-of-two batch (capped at the pool) and a
        power-of-two length.  Returns slot -> first generated token."""
        by_len: Dict[int, List[Tuple[int, np.ndarray]]] = {}
        for slot, toks in prompts.items():
            by_len.setdefault(len(toks), []).append((slot, toks))
        out: Dict[int, int] = {}
        for L, group in sorted(by_len.items()):
            G = len(group)
            Bp = min(self.slots, max(1, 1 << (G - 1).bit_length()))
            cand = 1 << max(L - 1, 0).bit_length()
            Lb = cand if L <= cand <= self._len_cap else L
            # pad the batch to the pow2 bucket by repeating the last row
            tok = np.zeros((Bp, Lb), np.int32)
            for i in range(Bp):
                tok[i, :L] = group[min(i, G - 1)][1]
            lengths = torch.full((Bp,), L, dtype=torch.int32,
                                 device=self.device)
            small = model_zoo.init_cache(self.cfg, Bp, self.max_len,
                                         self.device)
            logits, small = model_zoo.prefill(
                self.cfg, self.params,
                {"tokens": torch.as_tensor(tok, device=self.device)},
                small, lengths=lengths)
            # copy the G real rows into their slots (the repeated rows
            # hold identical values, so they are left out of the copy)
            idx = torch.as_tensor([slot for slot, _ in group],
                                  device=self.device)
            for name, leaf in self.cache.items():
                leaf[:, idx] = small[name][:, :G]
            first = logits[:G].argmax(dim=-1).cpu().numpy()
            for i, (slot, _) in enumerate(group):
                self.slot_pos[slot] = L
                out[slot] = int(first[i])
        return out

    @torch.no_grad()
    def decode_all(self, tokens_by_slot: Dict[int, int]) -> Dict[int, int]:
        """One decode step for every active slot: ``tokens_by_slot`` maps
        slot -> last emitted token; returns slot -> next token.  Slots
        outside it are masked inactive: their cache rows are not written."""
        tok = np.zeros(self.slots, np.int32)
        act = np.zeros(self.slots, bool)
        t = np.asarray(self.slot_pos, np.int32)
        for s, v in tokens_by_slot.items():
            tok[s] = v
            act[s] = True
        logits, self.cache = model_zoo.decode(
            self.cfg, self.params, self.cache,
            torch.as_tensor(tok, device=self.device),
            torch.as_tensor(t, device=self.device), torch.from_numpy(act))
        nxt = logits.argmax(dim=-1).cpu().numpy()
        out = {}
        for s in tokens_by_slot:
            self.slot_pos[s] += 1
            out[s] = int(nxt[s])
        return out
