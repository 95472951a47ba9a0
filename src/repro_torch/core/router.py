"""Traffic splitting across the tiers of the continuum.

The port's counterpart of ``repro/core/router.py``:

  * ``route_bernoulli`` — the paper-faithful per-request coin flip;
  * ``route_batch`` — expectation-matched 2-tier split: per function,
    ``floor(B_f * p_f)`` requests plus a Bernoulli remainder cross;
    ``route_batch_dense`` is its O(B^2) form (the same split);
  * ``route_tiers`` — its N-tier generalization over a per-function tier
    distribution;
  * ``hedged_mask`` — which waiting requests get a straggler backup;
  * ``split_counts`` — per-function edge / cloud counts of a mask.

The functions take their uniform draws as arguments (``extra_u`` for the
per-function Bernoulli remainders, ``noise`` for the within-function
ranking), so the caller draws from an explicit generator and a test can
feed the reference's own ``jax.random`` draws to get the same split.
"""

from __future__ import annotations

import torch


def _rank_within_function(fn_ids: torch.Tensor,
                          noise: torch.Tensor) -> torch.Tensor:
    """(B,) rank of each request among the requests of its function,
    ordered by ``noise`` (the reference's lexsort + segmented cummax)."""
    B = fn_ids.shape[0]
    by_noise = torch.sort(noise, stable=True).indices
    order = by_noise[torch.sort(fn_ids[by_noise], stable=True).indices]
    sorted_fn = fn_ids[order]
    pos = torch.arange(B, dtype=torch.int64)
    first = torch.ones(B, dtype=torch.bool)
    first[1:] = sorted_fn[1:] != sorted_fn[:-1]
    seg_start = torch.cummax(torch.where(first, pos, torch.zeros_like(pos)),
                             dim=0).values
    rank = torch.zeros(B, dtype=torch.int64)
    rank[order] = pos - seg_start
    return rank


def route_bernoulli(pct: torch.Tensor, fn_ids: torch.Tensor,
                    u: torch.Tensor) -> torch.Tensor:
    """Per-request i.i.d. routing (paper-faithful) -> (B,) bool, True =
    cloud.  pct: (F,) percentage to offload; u: (B,) uniforms in [0, 1)."""
    fn_ids = torch.as_tensor(fn_ids, dtype=torch.int64)
    p = torch.clamp(torch.as_tensor(pct, dtype=torch.float32)[fn_ids]
                    / 100.0, 0.0, 1.0)
    return torch.as_tensor(u, dtype=torch.float32) < p


def route_batch(pct: torch.Tensor, fn_ids: torch.Tensor, num_functions: int,
                extra_u: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Expectation-matched 2-tier split -> (B,) bool, True = cloud.

    pct: (F,) percentage to offload; extra_u: (F,) and noise: (B,)
    uniforms in [0, 1)."""
    fn_ids = torch.as_tensor(fn_ids, dtype=torch.int64)
    p = torch.clamp(torch.as_tensor(pct, dtype=torch.float32) / 100.0,
                    0.0, 1.0)
    per_fn = torch.zeros(num_functions, dtype=torch.float32).index_add_(
        0, fn_ids, torch.ones(fn_ids.shape[0], dtype=torch.float32))
    want = per_fn * p
    base = torch.floor(want)
    extra = (torch.as_tensor(extra_u, dtype=torch.float32)
             < want - base).to(torch.float32)
    n_cloud = base + extra
    rank = _rank_within_function(fn_ids, torch.as_tensor(noise))
    return rank < n_cloud[fn_ids]


def route_batch_dense(pct: torch.Tensor, fn_ids: torch.Tensor,
                      num_functions: int, extra_u: torch.Tensor,
                      noise: torch.Tensor) -> torch.Tensor:
    """:func:`route_batch` through a (B, B) same-function rank matrix, as
    the reference's O(B^2) form computes it (the controller benchmark
    times it against the sort).  The same draws give the same mask
    wherever ``noise`` has no ties."""
    fn_ids = torch.as_tensor(fn_ids, dtype=torch.int64)
    p = torch.clamp(torch.as_tensor(pct, dtype=torch.float32) / 100.0,
                    0.0, 1.0)
    onehot = torch.nn.functional.one_hot(fn_ids, num_functions).to(
        torch.float32)                                    # (B, F)
    want = onehot.sum(dim=0) * p
    base = torch.floor(want)
    extra = (torch.as_tensor(extra_u, dtype=torch.float32)
             < want - base).to(torch.float32)
    n_cloud = base + extra
    noise = torch.as_tensor(noise, dtype=torch.float32)
    same = onehot @ onehot.t()                            # 1 if same fn
    rank = (same * (noise[None, :] < noise[:, None])).sum(dim=1)
    return rank < n_cloud[fn_ids]


def split_counts(mask: torch.Tensor, fn_ids: torch.Tensor,
                 num_functions: int):
    """(F,) int32 edge and cloud request counts of a (B,) routing mask."""
    fn_ids = torch.as_tensor(fn_ids, dtype=torch.int64)
    total = torch.bincount(fn_ids, minlength=num_functions)
    cloud = torch.zeros(num_functions, dtype=torch.int64).index_add_(
        0, fn_ids, torch.as_tensor(mask, dtype=torch.int64))
    return (total - cloud).to(torch.int32), cloud.to(torch.int32)


def route_tiers(dist: torch.Tensor, fn_ids: torch.Tensor,
                extra_u: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Expectation-matched categorical assignment over N tiers.

    Per function, the number of requests sent to tier >= j is
    ``floor(B_f * T_j)`` plus a Bernoulli remainder (``T_j`` the tail
    share of the distribution); within a function, requests ranked lowest
    by ``noise`` go deepest.

    dist: (F, N) percentages (rows sum to 100, tier 0 = ingress);
    fn_ids: (B,); extra_u: (F, N) and noise: (B,) uniforms in [0, 1).
    Returns (B,) int32 tier indices.
    """
    fn_ids = torch.as_tensor(fn_ids, dtype=torch.int64)
    dist = torch.as_tensor(dist, dtype=torch.float32)
    F = dist.shape[0]
    p = torch.clamp(dist / 100.0, 0.0, 1.0)
    tail = torch.flip(torch.cumsum(torch.flip(p, [1]), dim=1), [1])
    per_fn = torch.zeros(F, dtype=torch.float32).index_add_(
        0, fn_ids, torch.ones(fn_ids.shape[0], dtype=torch.float32))
    want = per_fn[:, None] * tail
    base = torch.floor(want)
    extra = (torch.as_tensor(extra_u, dtype=torch.float32)
             < want - base).to(torch.float32)
    n = base + extra
    n[:, 0] = per_fn                                  # all reach tier 0
    # independent Bernoullis can break monotonicity; clip to a staircase
    n = torch.cummin(n, dim=1).values
    rank = _rank_within_function(fn_ids, torch.as_tensor(noise))
    return (rank[:, None] < n[fn_ids, 1:]).sum(dim=1).to(torch.int32)


def hedged_mask(ages: torch.Tensor, p99: torch.Tensor,
                fn_ids: torch.Tensor) -> torch.Tensor:
    """Mark the waiting requests whose age already exceeds their
    function's tail estimate for duplication on another tier (a hedged,
    or backup, request).  ages: (B,) seconds; p99: (F,); fn_ids: (B,).
    Returns (B,) bool, True = issue a hedge.  Deterministic: it draws
    nothing."""
    return ages > p99[torch.as_tensor(fn_ids, dtype=torch.int64)]
