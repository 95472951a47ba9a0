"""The controller's remaining entry points against the JAX reference, on
the CPU: ``offload.scan_controller`` and ``offload_update_from_sketch``,
and ``router.route_bernoulli``, ``route_batch_dense`` and
``split_counts``.

Inputs are made with numpy from a seed.  The scans are bitwise the
reference's (its ``lax.scan`` trajectory, and its jitted sketch step as
``benchmarks/controller_micro.py`` runs it); the routers are fed the
reference's own ``jax.random`` draws and give the same masks, and the
counts are exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import offload as j_offload
from repro.core import quantile as j_quantile
from repro.core import router as j_router
from repro_torch.core import offload as t_offload
from repro_torch.core import quantile as t_quantile
from repro_torch.core import router as t_router


def bits_equal(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _trace(seed, T=64, F=6, W=32):
    """A (T, F, W) latency trace whose tail grows, then shrinks, so R_t
    rises and falls, and a (T, F, W) mask with some empty windows."""
    rng = np.random.default_rng(seed)
    lat = rng.lognormal(-2.0, 0.5, (T, F, W)).astype(np.float32)
    tail = np.concatenate([np.linspace(1.0, 8.0, T // 2),
                           np.linspace(8.0, 1.0, T - T // 2)])
    slow = rng.uniform(size=(T, F, W)) < 0.15
    lat = np.where(slow, lat * tail[:, None, None], lat).astype(np.float32)
    n = rng.integers(0, W + 1, (T, F))
    valid = np.arange(W)[None, None, :] < n[..., None]
    return lat, valid


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("masked", [False, True])
def test_scan_controller_bitwise(seed, masked):
    lat, valid = _trace(seed)
    cfg_j, cfg_t = j_offload.OffloadConfig(), t_offload.OffloadConfig()
    if masked:
        want = j_offload.scan_controller(cfg_j, jnp.asarray(lat),
                                         jnp.asarray(valid))
        got = t_offload.scan_controller(cfg_t, torch.from_numpy(lat),
                                        torch.from_numpy(valid))
    else:
        want = j_offload.scan_controller(cfg_j, jnp.asarray(lat))
        got = t_offload.scan_controller(cfg_t, torch.from_numpy(lat))
    assert got.shape == (64, 6)
    bits_equal(got, want)
    assert float(np.asarray(want).max()) > 50.0     # the controller fired


@pytest.mark.parametrize("masked", [False, True])
def test_scan_controller_net_aware_bitwise(masked):
    lat, valid = _trace(7)
    kw = dict(net_aware=True, link_bytes_per_s=30e6, req_bytes=1e6,
              demand_rps=45.0)
    mask = (valid,) if masked else ()
    want = j_offload.scan_controller(j_offload.OffloadConfig(**kw),
                                     jnp.asarray(lat),
                                     *map(jnp.asarray, mask))
    got = t_offload.scan_controller(t_offload.OffloadConfig(**kw),
                                    torch.from_numpy(lat),
                                    *map(torch.from_numpy, mask))
    bits_equal(got, want)
    assert float(np.asarray(want).max()) > 0.0


@functools.partial(jax.jit, static_argnums=2)
def _j_from_sketch(state, hist, cfg):
    return j_offload.offload_update_from_sketch(state, hist, cfg)


@jax.jit
def _j_update(hist, lat, valid):
    return j_quantile.update(hist, lat, valid, decay=0.8)


@pytest.mark.parametrize("F", [1, 16, 64])
def test_offload_update_from_sketch_bitwise(F):
    """The default sketch (64 buckets), fed through both packages'
    ``update``; 24 controller steps, the tail growing then shrinking."""
    rng = np.random.default_rng(F)
    cfg_j, cfg_t = j_offload.OffloadConfig(), t_offload.OffloadConfig()
    hj = j_quantile.Histogram.init(F)
    ht = t_quantile.Histogram.init(F)
    sj = j_offload.OffloadState.init(F, cfg_j)
    st = t_offload.OffloadState.init(F, cfg_t)
    for t in range(24):
        lat = rng.gamma(2.0, 0.05, (F, 128)).astype(np.float32)
        lat *= np.where(rng.uniform(size=(F, 128)) < 0.1,
                        1.0 + 10.0 * min(t, 24 - t) / 12, 1.0)
        lat = lat.astype(np.float32)
        valid = rng.uniform(size=(F, 128)) < 0.9
        hj = _j_update(hj, jnp.asarray(lat), jnp.asarray(valid))
        ht = t_quantile.update(ht, torch.from_numpy(lat),
                               torch.from_numpy(valid), decay=0.8)
        bits_equal(ht.counts, hj.counts)
        sj, Rj = _j_from_sketch(sj, hj, cfg_j)
        st, Rt = t_offload.offload_update_from_sketch(st, ht, cfg_t)
        bits_equal(Rt, Rj)
        bits_equal(st.ratios, sj.ratios)
    assert float(np.asarray(Rj).max()) > 0.0


def _draws(seed, B, F):
    """The reference's route_batch draws: (F,) for the remainders, (B,)
    noise from ``fold_in(key, 1)``; and the (B,) uniforms of its
    ``route_bernoulli`` under the same key."""
    key = jax.random.PRNGKey(seed)
    extra = np.array(jax.random.uniform(key, (F,)))
    noise = np.array(jax.random.uniform(jax.random.fold_in(key, 1), (B,)))
    u = np.array(jax.random.uniform(key, (B,)))
    return key, extra, noise, u


@pytest.mark.parametrize("seed,B,F", [(0, 1, 1), (1, 33, 3), (2, 256, 16),
                                      (3, 1000, 7)])
def test_route_bernoulli_exact(seed, B, F):
    rng = np.random.default_rng(seed)
    fn_ids = rng.integers(0, F, B).astype(np.int32)
    pct = rng.uniform(-10.0, 110.0, F).astype(np.float32)
    key, _, _, u = _draws(seed, B, F)
    want = np.asarray(j_router.route_bernoulli(key, jnp.asarray(pct),
                                               jnp.asarray(fn_ids)))
    got = t_router.route_bernoulli(torch.from_numpy(pct),
                                   torch.from_numpy(fn_ids),
                                   torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,B,F", [(0, 1, 1), (1, 33, 3), (2, 256, 16),
                                      (3, 500, 7)])
def test_route_batch_dense_exact_and_equals_route_batch(seed, B, F):
    rng = np.random.default_rng(seed)
    fn_ids = rng.integers(0, F, B).astype(np.int32)
    pct = rng.uniform(0.0, 100.0, F).astype(np.float32)
    pct[0] = 100.0
    key, extra, noise, _ = _draws(seed, B, F)
    want = np.asarray(j_router.route_batch_dense(
        key, jnp.asarray(pct), jnp.asarray(fn_ids), F))
    args = (torch.from_numpy(pct), torch.from_numpy(fn_ids), F,
            torch.from_numpy(extra), torch.from_numpy(noise))
    got = t_router.route_batch_dense(*args).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(noise)) == B          # no ties: the forms agree
    np.testing.assert_array_equal(t_router.route_batch(*args).numpy(), got)


@pytest.mark.parametrize("seed,B,F", [(0, 1, 1), (1, 64, 5), (2, 300, 17)])
def test_split_counts_exact(seed, B, F):
    rng = np.random.default_rng(seed)
    fn_ids = rng.integers(0, F, B).astype(np.int32)
    mask = rng.uniform(size=B) < 0.4
    edge_j, cloud_j = j_router.split_counts(jnp.asarray(mask),
                                            jnp.asarray(fn_ids), F)
    edge_t, cloud_t = t_router.split_counts(torch.from_numpy(mask),
                                            torch.from_numpy(fn_ids), F)
    for got, want in ((edge_t, edge_j), (cloud_t, cloud_j)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(edge_t.sum() + cloud_t.sum()) == B
