"""The one traffic generator: a mix's parameters in, request sizes out.

Every seed gets the same work: the sizes are drawn once from the mix's
``base_seed``, and the run's seed only changes their order and the
prompts' token ids.  So two seeds differ in which request comes when,
not in how much there is to do.

A mix is a closed loop: ``clients`` clients, each sending its next
request when its last one is done; client ``c`` starts at
``c * stagger_s / clients`` into the pre-roll, and its request sizes
come from its own list, shuffled by the seed.

Lengths are drawn log-uniform (``"loguniform"``) or uniform over the
closed range the mix gives.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class Planned:
    """One request as the loop plans it: its index and its sizes."""
    index: int
    prompt_len: int
    max_new: int


def draw_len(rng: np.random.Generator, lo: int, hi: int, dist: str,
             n: int) -> np.ndarray:
    if dist == "loguniform":
        x = np.exp(rng.uniform(math.log(lo), math.log(hi + 1), n))
        return np.clip(np.floor(x).astype(np.int64), lo, hi)
    if dist == "uniform":
        return rng.integers(lo, hi + 1, n)
    raise ValueError(f"unknown length distribution {dist!r}")


def _sizes(rng, mix: dict, n: int) -> Tuple[np.ndarray, np.ndarray]:
    pl = draw_len(rng, *mix["prompt_len"], mix.get("prompt_dist", "uniform"), n)
    mn = draw_len(rng, *mix["max_new"], mix.get("max_new_dist", "uniform"), n)
    return pl, mn


def closed_sizes(mix: dict, seed: int, per_client: int = 256
                 ) -> List[List[Tuple[int, int]]]:
    """Each client's (prompt_len, max_new) list, in its seed's order."""
    base = np.random.default_rng(int(mix["base_seed"]))
    order = np.random.default_rng([int(seed) % 2 ** 63, 2])
    out = []
    for _ in range(int(mix["clients"])):
        pl, mn = _sizes(base, mix, per_client)
        perm = order.permutation(per_client)
        out.append(list(zip(pl[perm].tolist(), mn[perm].tolist())))
    starts = order.permutation(int(mix["clients"]))
    return [out[i] for i in starts]


def client_start(mix: dict, c: int) -> float:
    return float(mix["stagger_s"]) * c / int(mix["clients"])


def prompt_tokens(seed: int, index: int, length: int, vocab: int) -> np.ndarray:
    """Request ``index``'s prompt: token ids uniform over the vocabulary,
    from the run's seed."""
    rng = np.random.default_rng([int(seed) % 2 ** 63, 3, int(index)])
    return rng.integers(0, vocab, length).astype(np.int32)
