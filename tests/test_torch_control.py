"""The port's control plane (Eqs (1)-(4), routing, policies) against the
JAX reference, on the CPU.

Same inputs, made with numpy from a seed, go through ``repro.core`` and
``repro_torch.core``.  ControlLoop R_t trajectories are bitwise equal
(the port reproduces the FMAs and constant folding of the reference's
jitted rows kernel), ``"auto+net"`` caps included; eager Eq (1)/(3)
agree to float32 rounding; routing decisions fed the reference's own
``jax.random`` draws must be identical.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
import hypothesis
import hypothesis.strategies as st

from repro.core import offload as j_offload
from repro.core import policy as j_policy
from repro.core import router as j_router
from repro.core.topology import LinkSpec as JLinkSpec
from repro_torch.core import offload as t_offload
from repro_torch.core import policy as t_policy
from repro_torch.core import router as t_router
from repro_torch.core.topology import LinkSpec as TLinkSpec

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# float32 rounding: R_t lives in [0, 100], one float32 ulp there is ~8e-6
R_TOL = dict(rtol=1e-5, atol=5e-5)


def _windows(rng, F, W, fill):
    """(F, W) latency windows: lognormal latencies, a random valid prefix
    per row (some rows empty), some rows bimodal so Eq (1) fires."""
    lat = rng.lognormal(-2.0, 0.5, (F, W)).astype(np.float32)
    slow = rng.uniform(size=F) < 0.5
    lat[slow, ::3] *= rng.uniform(2.0, 6.0)
    n = rng.integers(0, W + 1, F) if fill is None else np.full(F, fill)
    valid = np.arange(W)[None, :] < n[:, None]
    return np.where(valid, lat, 0.0).astype(np.float32), valid


@pytest.mark.parametrize("seed", range(4))
def test_eq1_eq3_match_reference(seed):
    rng = np.random.default_rng(seed)
    lat, valid = _windows(rng, 9, 32, None)
    lat[0, :4] = 0.0                             # p50 == 0 corner
    valid[0, :4] = True
    valid[0, 4:] = False
    want = np.asarray(j_offload.latency_ratio(lat, valid))
    got = t_offload.latency_ratio(torch.from_numpy(lat),
                                  torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    p95 = rng.uniform(0, 2, 16).astype(np.float32)
    p50 = rng.uniform(0, 1, 16).astype(np.float32)
    p50[:3] = [0.0, np.nan, np.inf]
    np.testing.assert_allclose(
        t_offload.tail_ratio(torch.from_numpy(p95),
                             torch.from_numpy(p50)).numpy(),
        np.asarray(j_offload.tail_ratio(p95, p50)), rtol=1e-6)
    r = rng.uniform(0.5, 3.5, 64).astype(np.float32)
    cfg_j, cfg_t = j_offload.OffloadConfig(), t_offload.OffloadConfig()
    np.testing.assert_allclose(
        t_offload.target_percentage(torch.from_numpy(r), cfg_t).numpy(),
        np.asarray(j_offload.target_percentage(r, cfg_j)), **R_TOL)


@pytest.mark.parametrize("num_tiers,F,T,seed", [
    (2, 1, 14, 0), (2, 3, 14, 0), (3, 2, 14, 0),
    (3, 3, 200, 0), (3, 3, 200, 1), (3, 3, 200, 2)])
def test_control_loop_trajectories_match_reference(num_tiers, F, T, seed):
    """step_tiers R_t trajectories fed the same windows, queue ages and
    arrivals are bitwise the reference's, plus the 2-tier ``step`` on the
    ingress boundary."""
    rng = np.random.default_rng(7 + num_tiers + F + 100 * seed)
    W = 16
    B = num_tiers - 1
    ref = j_policy.ControlLoop("auto", F, window=W, num_tiers=num_tiers)
    port = t_policy.ControlLoop("auto", F, window=W, num_tiers=num_tiers)
    for t in range(T):
        lats, vals = zip(*[_windows(rng, F, W, None) for _ in range(B)])
        ages = [[sorted(rng.uniform(0, 1, int(rng.integers(0, 6))).tolist())
                 for _ in range(F)] for _ in range(B)]
        arrivals = [rng.integers(0, 9, F) for _ in range(B)]
        want = ref.step_tiers(list(lats), list(vals), queue_ages=ages,
                              arrivals=arrivals)
        got = port.step_tiers(list(lats), list(vals), queue_ages=ages,
                              arrivals=arrivals)
        np.testing.assert_array_equal(got, want, err_msg=f"step {t}")
    np.testing.assert_array_equal(port.dist(), ref.dist())
    lat, val = _windows(rng, F, W, W)
    np.testing.assert_array_equal(port.step(lat, val), ref.step(lat, val))


def _net_policies(mod, spec, links, req_bytes):
    return [mod.Policy.parse(spec, link_bytes_per_s=bw, req_bytes=req_bytes)
            for bw in links]


@pytest.mark.parametrize("num_tiers,F", [(2, 1), (2, 3), (3, 1), (3, 3)])
def test_net_aware_trajectories_match_reference(num_tiers, F):
    """``"auto+net"`` per-boundary caps (each boundary against its own
    link) bind on a share of the steps; R_t stays bitwise the
    reference's, and a mid-run ``set_link_capacity`` re-caps both."""
    rng = np.random.default_rng(11 * num_tiers + F)
    W, T = 16, 120
    B = num_tiers - 1
    links = [50e6, 100e6][:B]
    ref = j_policy.ControlLoop(
        "auto+net", F, window=W, num_tiers=num_tiers,
        boundary_policies=_net_policies(j_policy, "auto+net", links, 6.0e6))
    port = t_policy.ControlLoop(
        "auto+net", F, window=W, num_tiers=num_tiers,
        boundary_policies=_net_policies(t_policy, "auto+net", links, 6.0e6))
    capped = 0
    for t in range(T):
        if t == T // 2:
            for pol in (ref.policies[0], port.policies[0]):
                assert pol.set_link_capacity(5e6)
        lats, vals = zip(*[_windows(rng, F, W, None) for _ in range(B)])
        ages = [[sorted(rng.uniform(0, 1, int(rng.integers(0, 6))).tolist())
                 for _ in range(F)] for _ in range(B)]
        arrivals = [rng.integers(0, 40, F) for _ in range(B)]
        want = ref.step_tiers(list(lats), list(vals), queue_ages=ages,
                              arrivals=arrivals)
        got = port.step_tiers(list(lats), list(vals), queue_ages=ages,
                              arrivals=arrivals)
        np.testing.assert_array_equal(got, want, err_msg=f"step {t}")
        caps = np.stack([np.clip(100.0 * pol.cfg.link_bytes_per_s
                                 / np.maximum(np.maximum(a, 1e-3) * 6.0e6,
                                              1e-9), 0, 100)
                         for pol, a in zip(port.policies, arrivals)])
        capped += int(np.sum(np.isclose(got, caps, rtol=1e-5) & (caps < 100)))
    assert capped > 10                   # the cap bound on many rows
    assert port.policies[0].cfg == dataclasses.replace(
        port.policies[0].cfg, link_bytes_per_s=5e6)
    assert not t_policy.AutoOffload().set_link_capacity(1e6)


def test_offload_update_rows_match_reference_kernel():
    """One step of the port's ``offload_update`` against the reference's
    jitted rows kernel on random states (ring heads, fill levels, R) at
    several row counts: Eqs (1)-(4) and the cap, bitwise."""
    rng = np.random.default_rng(3)
    cfg_j = j_offload.OffloadConfig()
    cfg_t = t_offload.OffloadConfig(net_aware=True, link_bytes_per_s=50e6,
                                    req_bytes=6.0e6)
    for P in (1, 2, 8, 16):
        for _ in range(25):
            ratios = (1 + 3 * rng.random((P, 11))).astype(np.float32)
            head = rng.integers(0, 11, P).astype(np.int32)
            filled = rng.integers(0, 12, P).astype(np.int32)
            R = (100 * rng.random(P)).astype(np.float32)
            R[0] = 1.5e-38                # R * c_in is subnormal: flushed
            lat = rng.lognormal(0, 1, (P, 64)).astype(np.float32)
            val = rng.random((P, 64)) < rng.random((P, 1))
            rps = rng.integers(0, 40, P).astype(np.float32) + 1e-3
            st_j = j_offload.OffloadState(*map(np.asarray,
                                               (ratios, head, filled, R)))
            _, want = j_offload.offload_update_rows_jit(
                st_j, lat, val, np.ones(P, bool),
                np.full(P, np.float32(100.0 * 50e6)),
                np.full(P, np.float32(6.0e6)), np.ones(P, bool), rps,
                cfg=cfg_j)
            st_t = t_offload.OffloadState(*map(torch.from_numpy,
                                               (ratios, head, filled, R)))
            _, got = t_offload.offload_update(
                st_t, torch.from_numpy(lat), torch.from_numpy(val), cfg_t,
                demand_rps=torch.from_numpy(rps))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_static_split_loop_matches_reference():
    ref = j_policy.ControlLoop(37.5, 2, window=8)
    port = t_policy.ControlLoop(37.5, 2, window=8)
    lat, val = _windows(np.random.default_rng(0), 2, 8, 8)
    np.testing.assert_array_equal(port.step(lat, val), ref.step(lat, val))
    np.testing.assert_array_equal(port.dist(), ref.dist())


# the reference's routers run jitted (as Policy.route*/route_tiers call
# them); shapes come from a small set so each compiles once
_route_tiers_j = jax.jit(j_router.route_tiers)
_route_batch_j = jax.jit(j_router.route_batch, static_argnums=(3,))


@hypothesis.settings(max_examples=25, deadline=None, database=None)
@hypothesis.given(seed=st.integers(0, 2**31 - 1), F=st.sampled_from([1, 3]),
                  N=st.sampled_from([2, 3]), B=st.sampled_from([5, 32]))
def test_route_tiers_fed_reference_noise_is_identical(seed, F, N, B):
    rng = np.random.default_rng(seed)
    raw = rng.uniform(0, 1, (F, N)) * (rng.uniform(size=(F, N)) < 0.8)
    raw[:, 0] += 1e-3
    dist = (100.0 * raw / raw.sum(1, keepdims=True)).astype(np.float32)
    fn_ids = rng.integers(0, F, B).astype(np.int32)
    key = jax.random.PRNGKey(seed)
    extra_u = np.array(jax.random.uniform(key, (F, N)))
    noise = np.array(jax.random.uniform(jax.random.fold_in(key, 1), (B,)))
    want = np.asarray(_route_tiers_j(key, dist, fn_ids))
    got = t_router.route_tiers(torch.from_numpy(dist),
                               torch.from_numpy(fn_ids),
                               torch.from_numpy(extra_u),
                               torch.from_numpy(noise)).numpy()
    np.testing.assert_array_equal(got, want)


@hypothesis.settings(max_examples=25, deadline=None, database=None)
@hypothesis.given(seed=st.integers(0, 2**31 - 1), F=st.sampled_from([1, 4]),
                  B=st.sampled_from([6, 32]))
def test_route_batch_fed_reference_noise_is_identical(seed, F, B):
    rng = np.random.default_rng(seed)
    pct = (100.0 * rng.uniform(size=F)).astype(np.float32)
    pct[0] = 50.0
    fn_ids = rng.integers(0, F, B).astype(np.int32)
    key = jax.random.PRNGKey(seed)
    extra_u = np.array(jax.random.uniform(key, (F,)))
    noise = np.array(jax.random.uniform(jax.random.fold_in(key, 1), (B,)))
    want = np.asarray(_route_batch_j(key, pct, fn_ids, F))
    got = t_router.route_batch(torch.from_numpy(pct),
                               torch.from_numpy(fn_ids), F,
                               torch.from_numpy(extra_u),
                               torch.from_numpy(noise)).numpy()
    np.testing.assert_array_equal(got, want)


def test_tier_distribution_matches_reference():
    rng = np.random.default_rng(3)
    for N in (1, 2, 3, 5):
        R_all = (100 * rng.uniform(size=(max(N - 1, 1), 4))).astype(
            np.float32)
        want = j_policy.Policy().tier_distribution(R_all, N)
        got = t_policy.Policy().tier_distribution(R_all, N)
        np.testing.assert_array_equal(got, want)


def test_mix_queue_ages_matches_reference():
    rng = np.random.default_rng(4)
    for n_ages in (0, 1, 5, 40):
        lat, val = _windows(rng, 3, 16, None)
        ages = sorted(rng.uniform(0, 2, n_ages).tolist())
        lj, vj, lt, vt = lat.copy(), val.copy(), lat.copy(), val.copy()
        j_policy.ControlLoop.mix_queue_ages(lj, vj, 1, ages, 16)
        t_policy.ControlLoop.mix_queue_ages(lt, vt, 1, ages, 16)
        np.testing.assert_array_equal(lt, lj)
        np.testing.assert_array_equal(vt, vj)


def test_link_latency_matches_reference():
    for rtt, bw, n in ((0.0, 100e6, 0), (0.04, 100e6, 4096),
                       (0.005, 50e6, 1e6)):
        assert TLinkSpec(rtt, bw).latency_s(n) == JLinkSpec(rtt, bw).latency_s(n)


@pytest.mark.parametrize("spec", [0, 25, 100.0, "0", "50", "100",
                                  " 75.5 ", "auto", "AUTO"])
def test_policy_parse_supported(spec):
    ref = j_policy.Policy.parse(spec)
    port = t_policy.Policy.parse(spec)
    assert type(port).__name__ == type(ref).__name__
    assert port.spec == ref.spec
    np.testing.assert_array_equal(port.initial_R(3), ref.initial_R(3))


@pytest.mark.parametrize("spec", ["auto+net", "auto+migrate",
                                  "auto+migrate+net", "AUTO+NET",
                                  "auto+net+migrate"])
def test_policy_parse_modifiers_match_reference(spec):
    kw = dict(link_bytes_per_s=50e6, req_bytes=6.0e6)
    ref = j_policy.Policy.parse(spec, **kw)
    port = t_policy.Policy.parse(spec, **kw)
    assert type(port).__name__ == type(ref).__name__
    assert port.spec == ref.spec
    assert port.migrate_threshold == ref.migrate_threshold
    for f in ("net_aware", "link_bytes_per_s", "req_bytes", "c_decay",
              "c_t", "c_soft", "c_hard", "c_in"):
        assert getattr(port.cfg, f) == getattr(ref.cfg, f), f
    np.testing.assert_array_equal(port.initial_R(3), ref.initial_R(3))


@pytest.mark.parametrize("spec", ["auto+hedge", "auto+net+hedge"])
def test_policy_parse_unported_modifiers_raise(spec):
    """``+hedge`` used to be the modifier left unported; it now parses as
    the reference does (none raises any more)."""
    kw = dict(link_bytes_per_s=50e6, req_bytes=6.0e6)
    ref = j_policy.Policy.parse(spec, **kw)
    port = t_policy.Policy.parse(spec, **kw)
    assert type(port).__name__ == type(ref).__name__ == "HedgedOffload"
    assert port.spec == ref.spec
    assert port.hedge_quantile == ref.hedge_quantile
    assert port.migrate_threshold is ref.migrate_threshold is None
    for f in ("net_aware", "link_bytes_per_s", "req_bytes"):
        assert getattr(port.cfg, f) == getattr(ref.cfg, f), f


def test_sketch_front_end_raises():
    """The sketch front end is ported: what it raises now is the
    reference's dispatch (``tests/test_torch_sketch.py`` holds its
    trajectories)."""
    sk = t_policy.ControlLoop("auto", 1, eq1="sketch")
    assert sk.eq1 == "sketch" and sk._P == 1
    with pytest.raises(ValueError, match="step_stream"):
        sk.step(np.ones((1, 8), np.float32), np.ones((1, 8), bool))
    with pytest.raises(ValueError, match="eq1"):
        t_policy.ControlLoop("auto", 1, eq1="exact")
    with pytest.raises(ValueError, match="auto-family"):
        t_policy.ControlLoop(50.0, 1, eq1="sketch")


@pytest.mark.parametrize("spec", ["bogus", "auto+fast", "101", -1])
def test_policy_parse_rejects_like_reference(spec):
    with pytest.raises(ValueError):
        j_policy.Policy.parse(spec)
    with pytest.raises(ValueError):
        t_policy.Policy.parse(spec)
