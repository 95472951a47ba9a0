"""Deterministic synthetic data stream: the counterpart of
``repro/training/data.py``.

A stateless, seekable token stream: batch ``i`` is a pure function of
``(seed, i)``, so a restart after preemption reproduces the exact stream
from the step index alone.  The reference draws with threefry
(``jax.random.fold_in``, ``categorical``); the port draws from
``np.random.default_rng([seed, i])``, so the two streams have the same
shapes and structure but different tokens (tests that compare the two
packages feed both the reference's batches).

Each row is a Zipf(``zipf_a``) unigram sample with copy structure: every
span of ``span`` tokens is drawn once and repeated, so a model that
learns to copy gets a big loss drop.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    batch: int = 8
    seq_len: int = 128
    zipf_a: float = 1.2          # unigram skew
    span: int = 16               # repeated-span structure


def _zipf_logits(vocab: int, a: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = 1.0 / ranks ** a
    return np.log(p / p.sum()).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _zipf_cdf(vocab: int, a: float) -> np.ndarray:
    """The categorical distribution of :func:`_zipf_logits`'s float32
    logits, as a float64 CDF."""
    p = np.exp(_zipf_logits(vocab, a).astype(np.float64))
    cdf = np.cumsum(p / p.sum())
    cdf[-1] = 1.0
    return cdf


def make_batch(cfg: ModelConfig, dcfg: DataConfig,
               index: int) -> Dict[str, torch.Tensor]:
    """Batch ``index`` of the stream, as CPU tensors: ``tokens`` and
    ``labels`` (B, S) int32 (labels are the next tokens), and for a
    vision frontend ``patches`` (B, num_patches, d_model) standard
    normals in ``compute_dtype``, from the same generator."""
    rng = np.random.default_rng([dcfg.seed, index])
    B, S = dcfg.batch, dcfg.seq_len
    n_span = (S + 2 * dcfg.span - 1) // (2 * dcfg.span)
    u = rng.random((B, n_span, dcfg.span))
    spans = np.searchsorted(_zipf_cdf(cfg.vocab_size, dcfg.zipf_a), u,
                            side="right").clip(max=cfg.vocab_size - 1)
    doubled = np.concatenate([spans, spans], axis=-1).reshape(B, -1)
    doubled = doubled[:, :S + 1].astype(np.int32)
    batch = {"tokens": torch.from_numpy(doubled[:, :S].copy()),
             "labels": torch.from_numpy(doubled[:, 1:S + 1].copy())}
    if cfg.frontend == "vision":
        patches = rng.standard_normal((B, cfg.num_patches, cfg.d_model),
                                      dtype=np.float32)
        batch["patches"] = torch.from_numpy(patches).to(cfg.compute_dtype)
    return batch


def stream(cfg: ModelConfig, dcfg: DataConfig,
           start: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
    """Seekable infinite stream; ``start`` resumes mid-run after restart."""
    i = start
    while True:
        yield make_batch(cfg, dcfg, i)
        i += 1
