"""The streaming-sketch Eq-(1) front end (``eq1="sketch"``) in the port,
against the reference, on the CPU.

The reference computes the sketch inside jitted XLA:CPU programs; the
port reproduces their rounding (XLA's ``log``/``exp`` polynomials, its
fused multiply-adds, its summation orders), so everything here is held
with ``np.array_equal`` (bit patterns for floats): ``_xla_log`` /
``_xla_exp`` on a million seeded values, bucket indices (one ulp either
side of every bucket edge), ``update``, ``ingest`` (repeated rows,
masked padding), ``quantile``, ``quantile_fast`` and
``latency_ratio_from_sketch`` against the jitted reference, the stacked
stream step against ``offload_update_rows_stream_jit``, ``step_stream``
trajectories of 1-, 2- and 3-tier loops, the dispatch errors,
``platform.simulate(eq1="sketch")`` field for field and a live
``controller_update`` under ``eq1="sketch"``.

Two shapes of the ``B % 8 != 0`` branch are not reproduced (XLA sums a
one-row B-wide prefix product with a vectorized reduction, and Eigen's
dot at B = 10 from 64 rows in an order not modelled); they stand as
strict xfails below and in ``ROADMAP.md`` §3.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import platform as j_platform
from repro.core import offload as j_offload
from repro.core import policy as j_policy
from repro.core import quantile as j_quantile
from repro.core import simulator as j_sim
from repro.core import topology as j_topo
from repro_torch import platform as t_platform
from repro_torch.core import offload as t_offload
from repro_torch.core import policy as t_policy
from repro_torch.core import quantile as t_quantile
from repro_torch.core import simulator as t_sim
from repro_torch.core import topology as t_topo
from repro_torch.core.xla_cpu import _xla_exp, _xla_log
from test_torch_chain import (_sequential_reference,  # noqa: F401
                              deterministic_clock)  # noqa: F401
from test_torch_sim import assert_same_result
from torch_live import Pair, two_tier


def bits_equal(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _hists(F, B):
    """The same empty histogram in both packages."""
    hj = j_quantile.Histogram.init(F, B)
    ht = t_quantile.Histogram.init(F, B)
    bits_equal(ht.log_lo, hj.log_lo)
    bits_equal(ht.log_hi, hj.log_hi)
    return hj, ht


def _counts(rng, F, B, fill=0.4):
    """Decayed-looking counts: sparse, fractional, some empty rows."""
    c = rng.gamma(0.3, 3.0, (F, B)) * (rng.uniform(size=(F, B)) < fill)
    c[rng.uniform(size=F) < 0.1] = 0.0
    return c.astype(np.float32)


def _with_counts(hj, ht, c):
    return (j_quantile.Histogram(jnp.asarray(c), hj.log_lo, hj.log_hi),
            t_quantile.Histogram(torch.from_numpy(c.copy()), ht.log_lo,
                                 ht.log_hi))


@functools.partial(jax.jit, static_argnums=1)
def _j_quantile(hist, q):
    return j_quantile.quantile(hist, q)


@functools.partial(jax.jit, static_argnums=1)
def _j_quantile_fast(hist, qs):
    return j_quantile.quantile_fast(hist, qs)


@functools.partial(jax.jit, static_argnums=3)
def _j_update(hist, lat, valid, decay):
    return j_quantile.update(hist, lat, valid, decay=decay)


# ---- XLA's log and exp -------------------------------------------------------

def test_xla_log_exp_match_jax_on_a_million_values():
    rng = np.random.default_rng(0)
    x = np.exp(rng.uniform(-69.0, 69.0, 1_000_000)).astype(np.float32)
    x[:6] = [0.0, -1.0, np.inf, np.nan, 1e-40, 1.0]
    want = np.asarray(jax.jit(jnp.log)(x))
    got = _xla_log(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    y = rng.uniform(-10.0, 8.0, 1_000_000).astype(np.float32)
    y[:5] = [0.0, -100.0, 100.0, np.nan, -np.inf]
    np.testing.assert_array_equal(_xla_exp(torch.from_numpy(y)).numpy(),
                                  np.asarray(jax.jit(jnp.exp)(y)))


# ---- the histogram -----------------------------------------------------------

@pytest.mark.parametrize("B", [64, 60])
def test_bucket_index_matches_reference(B):
    """Seeded streams, and every bucket edge with the floats one ulp
    either side of it (where the reference's own log decides)."""
    hj, ht = _hists(1, B)
    lo, hi = float(np.log(1e-4)), float(np.log(1e3))
    edges = np.exp(lo + (hi - lo) * np.arange(B + 1) / B).astype(np.float32)
    near = np.concatenate([edges, np.nextafter(edges, np.float32(0)),
                           np.nextafter(edges, np.float32(np.inf))])
    rng = np.random.default_rng(B)
    x = np.concatenate([near, rng.lognormal(-2.0, 3.0, 20_000),
                        [0.0, -1.0, 1e-40, 1e9, np.inf, np.nan]]
                       ).astype(np.float32)
    want = np.asarray(j_quantile._bucket_index(hj, jnp.asarray(x)))
    got = t_quantile._bucket_index(ht, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) == B


@pytest.mark.parametrize("F,B", [(4, 64), (1024, 64), (7, 60)])
def test_update_matches_reference(F, B):
    rng = np.random.default_rng(F)
    hj, ht = _with_counts(*_hists(F, B), _counts(rng, F, B))
    lat = rng.lognormal(-2.0, 1.5, (F, 32)).astype(np.float32)
    valid = rng.uniform(size=(F, 32)) < 0.7
    bits_equal(t_quantile.update(ht, lat, valid, decay=0.7).counts,
               _j_update(hj, lat, valid, 0.7).counts)


@pytest.mark.parametrize("F,B", [(4, 64), (1024, 64), (8, 60)])
def test_ingest_repeated_rows_and_padding_match_reference(F, B):
    """Rows repeat many times in one batch (decayed counts are not
    integers, so the order of the adds shows), and the padded tail is
    masked out."""
    rng = np.random.default_rng(F + B)
    hj, ht = _with_counts(*_hists(F, B), _counts(rng, F, B, fill=0.9))
    S = 512
    rows = rng.choice(rng.integers(0, F, 3), S).astype(np.int32)
    vals = rng.lognormal(-2.0, 1.0, S).astype(np.float32)
    valid = np.arange(S) < 450
    for decay in (0.9, 0.37):
        want = j_quantile.ingest(hj, rows, vals, valid, decay=decay).counts
        got = t_quantile.ingest(ht, torch.from_numpy(rows),
                                torch.from_numpy(vals),
                                torch.from_numpy(valid), decay=decay).counts
        bits_equal(got, want)
    c = _counts(rng, F, B)
    c[0, 0] = 1e-38                              # decays to a subnormal
    hj, ht = _with_counts(hj, ht, c)
    bits_equal(t_quantile.ingest(ht, rows[:0], vals[:0]).counts,
               j_quantile.ingest(hj, rows[:0], vals[:0]).counts)


@pytest.mark.parametrize("F,B", [(4, 64), (1024, 64), (7, 60), (64, 40)])
def test_quantile_matches_reference(F, B):
    rng = np.random.default_rng(3 * F + B)
    hists = _hists(F, B)
    for _ in range(3):
        hj, ht = _with_counts(*hists, _counts(rng, F, B))
        p50, p95 = _j_quantile(hj, 0.5), _j_quantile(hj, 0.95)
        bits_equal(t_quantile.quantile(ht, 0.99), _j_quantile(hj, 0.99))
        bits_equal(t_quantile.quantiles(ht, (0.5, 0.95)),
                   jnp.stack([p50, p95]))


@pytest.mark.parametrize("F,B", [(1, 64), (4, 64), (1024, 64), (8, 128),
                                 (8, 60), (256, 60)])
def test_quantile_fast_matches_reference(F, B):
    """Both branches, through the jitted ``latency_ratio_from_sketch``
    (the controller's Eq (1)); the two-level select (B % 8 == 0) also
    against the jitted ``quantile_fast`` alone.  (XLA compiles the
    one-product branch differently alone: there the controller's program
    is the contract.)"""
    rng = np.random.default_rng(5 * F + B)
    hists = _hists(F, B)
    ratio = jax.jit(j_offload.latency_ratio_from_sketch)
    for _ in range(3):
        hj, ht = _with_counts(*hists, _counts(rng, F, B))
        if B % 8 == 0:
            bits_equal(t_quantile.quantile_fast(ht, (0.95, 0.5)),
                       _j_quantile_fast(hj, (0.95, 0.5)))
        bits_equal(t_offload.latency_ratio_from_sketch(ht), ratio(hj))


# ---- the stacked stream step -------------------------------------------------

def _stream_ticks(P, B, ticks, seed):
    """``ticks`` stream steps through both packages from one state:
    repeated rows, padding, frozen rows, net caps on half the rows, a
    regime shift half way.  Every state, histogram and R_t bitwise."""
    rng = np.random.default_rng(seed)
    cfg_j, cfg_t = j_offload.OffloadConfig(), t_offload.OffloadConfig()
    sj = j_offload.OffloadState.init_rows(P, cfg_j)
    st = t_offload.OffloadState.init(P, cfg_t)
    hj, ht = _hists(P, B)
    for t in range(ticks):
        S = int(rng.choice([8, 64, 256]))
        n = int(rng.integers(0, S + 1))
        rows = np.zeros(S, np.int32)
        vals = np.zeros(S, np.float32)
        rows[:n] = rng.choice(rng.integers(0, P, max(1, min(P // 3, 16))),
                              n)
        scale = 0.02 if t < ticks // 2 else 1.0
        vals[:n] = (rng.gamma(2.0, scale, n)
                    * np.where(rng.uniform(size=n) < 0.2, 30.0, 1.0))
        valid = np.arange(S) < n
        active = rng.uniform(size=P) < 0.8
        link = np.where(rng.uniform(size=P) < 0.5, np.float32(5e9),
                        np.float32(0)).astype(np.float32)
        req = np.full(P, 6e6, np.float32)
        rps = (rng.integers(0, 40, P) + 1e-3).astype(np.float32)
        sj, hj, Rj = j_offload.offload_update_rows_stream_jit(
            sj, hj, rows, vals, valid, jnp.float32(0.9), active, link, req,
            link > 0, rps, cfg=cfg_j)
        st, ht, Rt = t_offload.offload_update_rows_stream(
            st, ht, *(torch.from_numpy(a) for a in (rows, vals, valid)),
            torch.tensor(0.9, dtype=torch.float32),
            *(torch.from_numpy(a) for a in (active, link, req, link > 0,
                                            rps)), cfg_t)
        bits_equal(ht.counts, hj.counts)
        bits_equal(st.ratios, sj.ratios)
        bits_equal(Rt, Rj)
        np.testing.assert_array_equal(st.head.numpy(), np.asarray(sj.head))
        np.testing.assert_array_equal(st.filled.numpy(),
                                      np.asarray(sj.filled))
    assert float(np.asarray(Rj).max()) > 0


@pytest.mark.parametrize("P,B", [(1, 64), (2, 64), (8, 64), (256, 64),
                                 (4096, 64), (8, 128), (2, 60), (256, 60)])
def test_stream_rows_match_reference_kernel(P, B):
    _stream_ticks(P, B, 24 if P < 4096 else 10, seed=P + B)


@pytest.mark.xfail(strict=True, reason=(
    "B % 8 != 0 at one row: XLA sums the B-wide prefix product of a "
    "single row with a vectorized reduction whose order the port does not "
    "model (ROADMAP.md section 3, seed 61, B = 60, P = 1)"))
def test_stream_rows_one_row_odd_buckets():
    _stream_ticks(1, 60, 24, seed=61)


@pytest.mark.xfail(strict=True, reason=(
    "B = 10 from 64 rows: Eigen's dot sums the 10-wide prefix product in "
    "an order the port does not model (ROADMAP.md section 3, seed 74, "
    "B = 10, P = 64)"))
def test_stream_rows_ten_buckets_many_rows():
    _stream_ticks(64, 10, 24, seed=74)


# ---- the control loop --------------------------------------------------------

def _loops(spec, F, num_tiers, W=64, links=None):
    kw = dict(window=W, num_tiers=num_tiers, eq1="sketch")
    out = []
    for mod in (j_policy, t_policy):
        bp = None
        if links is not None:
            bp = [mod.Policy.parse(spec, link_bytes_per_s=bw,
                                   req_bytes=6.0e6) for bw in links]
        out.append(mod.ControlLoop(spec, F, boundary_policies=bp, **kw))
    return out


@pytest.mark.parametrize("num_tiers,F", [(1, 3), (2, 1), (2, 5), (3, 2),
                                         (3, 4)])
def test_step_stream_trajectories_match_reference(num_tiers, F):
    """40 ticks: calm then a heavy bimodal tail, an idle boundary for a
    stretch, queue ages, demand; R_t, the stacked state and the
    histograms bitwise the reference's every tick."""
    rng = np.random.default_rng(10 * num_tiers + F)
    ref, port = _loops("auto", F, num_tiers)
    B = ref.num_boundaries
    assert ref.vectorized and port._P == ref._P
    for t in range(40):
        samples = []
        for b in range(B):
            if b == B - 1 and B > 1 and 10 <= t < 25:
                samples.append(None)            # this boundary idles
                continue
            n = int(rng.integers(0, 40))
            vals = rng.gamma(2.0, 0.02 if t < 20 else 2.0, n)
            if t >= 20:
                vals[::4] *= 50.0
            samples.append((rng.integers(0, F, n),
                            vals.astype(np.float32)))
        ages = [[sorted(rng.uniform(0, 3, int(rng.integers(0, 9))).tolist())
                 for _ in range(F)] for _ in range(B)]
        arrivals = [rng.integers(0, 30, F) for _ in range(B)]
        want = ref.step_stream(samples, queue_ages=ages, arrivals=arrivals)
        got = port.step_stream(samples, queue_ages=ages, arrivals=arrivals)
        bits_equal(got, want)
        bits_equal(port._vstate.ratios, ref._vstate.ratios)
        bits_equal(port._hist.counts, ref._hist.counts)
        np.testing.assert_array_equal(port._seen, ref._seen)
    assert (got > 0).any()
    np.testing.assert_array_equal(port.dist(), ref.dist())


@pytest.mark.parametrize("num_tiers,F", [(2, 3), (3, 2)])
def test_step_stream_net_aware_recap_matches_reference(num_tiers, F):
    """``"auto+net"`` with each boundary on its own link; the cap binds,
    and a mid-run ``set_link_capacity`` re-caps both packages alike."""
    rng = np.random.default_rng(num_tiers + 7 * F)
    links = [50e6, 100e6][:num_tiers - 1]
    ref, port = _loops("auto+net", F, num_tiers, links=links)
    capped = 0
    for t in range(36):
        if t == 18:
            for pol in (ref.policies[0], port.policies[0]):
                assert pol.set_link_capacity(5e6)
        samples = []
        for b in range(ref.num_boundaries):
            vals = rng.gamma(2.0, 0.5, 30)
            vals[::3] *= 40.0
            samples.append((rng.integers(0, F, 30), vals.astype(np.float32)))
        arrivals = [rng.integers(0, 60, F) for _ in range(ref.num_boundaries)]
        want = ref.step_stream(samples, arrivals=arrivals)
        got = port.step_stream(samples, arrivals=arrivals)
        bits_equal(got, want)
        capped += int((got < 100.0).any() and (got > 0).any())
    assert capped > 5
    assert port.policies[0].cfg.link_bytes_per_s == 5e6


def test_dispatch_errors_match_reference():
    for mod in (j_policy, t_policy):
        win = mod.ControlLoop("auto", 2, window=8)
        sk = mod.ControlLoop("auto", 2, window=8, eq1="sketch")
        with pytest.raises(ValueError, match="step_stream"):
            win.step_stream([None])
        with pytest.raises(ValueError, match="sketch"):
            sk.step(np.ones((2, 8), np.float32), np.ones((2, 8), bool))
        with pytest.raises(ValueError, match="sketch"):
            sk.step_tiers([np.ones((2, 8), np.float32)],
                          [np.ones((2, 8), bool)])
        with pytest.raises(ValueError, match="sample sets"):
            sk.step_stream([None, None])
        with pytest.raises(ValueError, match="eq1"):
            mod.ControlLoop("auto", 2, window=8, eq1="exact")
        with pytest.raises(ValueError, match="auto-family"):
            mod.ControlLoop(50.0, 2, window=8, eq1="sketch")
        with pytest.raises(ValueError, match="auto-family"):
            mod.ControlLoop("auto", 2, window=8, eq1="sketch",
                            boundary_policies=["auto", 50.0],
                            num_tiers=3)


@pytest.mark.parametrize("F", [1, 3])
def test_window_path_unchanged_per_boundary_or_stacked(F):
    """The port steps the window front end one boundary at a time; its
    R_t equals the reference's default loop, which stacks the rows at
    F = 3 and stays per boundary at F = 1."""
    W = 16
    rng = np.random.default_rng(4 + F)
    ref = j_policy.ControlLoop("auto", F, window=W, num_tiers=3)
    port = t_policy.ControlLoop("auto", F, window=W, num_tiers=3)
    assert ref.vectorized == (F > 1)
    for t in range(30):
        lats = [rng.lognormal(-2.0, 0.8, (F, W)).astype(np.float32)
                for _ in range(2)]
        vals = [rng.uniform(size=(F, W)) < 0.6 for _ in range(2)]
        if t % 7 == 3:
            vals[1][:] = False                   # a frozen boundary
        arrivals = rng.integers(0, 9, F)
        bits_equal(port.step_tiers(lats, vals, arrivals=arrivals),
                   ref.step_tiers(lats, vals, arrivals=arrivals))
    assert len(port.states) == 2 and port.states[0].R.shape == (F,)


# ---- simulator and live runtime ----------------------------------------------

@pytest.mark.parametrize("policy,kind", [("auto", "pair"),
                                         ("auto+net", "dec"),
                                         ("auto+migrate", "dec")])
def test_simulate_sketch_matches_reference(policy, kind):
    topo = {"pair": None, "dec": "dec"}[kind]
    cfg_j = j_sim.SimConfig(duration_s=200.0)
    cfg_t = t_sim.SimConfig(duration_s=200.0)
    ref = j_platform.Continuum.simulate(
        "matmult", policy, cfg_j, eq1="sketch",
        topology=topo and j_topo.Topology.device_edge_cloud())
    port = t_platform.Continuum.simulate(
        "matmult", policy, cfg_t, eq1="sketch",
        topology=topo and t_topo.Topology.device_edge_cloud())
    assert_same_result(port, ref)
    assert max(port.offload_pct) > 0.0
    assert port.successes + port.failures == port.submitted > 0


def test_simulate_sketch_spec_passes_through():
    spec_j = j_quantile.SketchSpec(num_buckets=128, decay=0.8)
    spec_t = t_quantile.SketchSpec(num_buckets=128, decay=0.8)
    cfg = dict(duration_s=120.0)
    ref = j_platform.Continuum.simulate("io", "auto", j_sim.SimConfig(**cfg),
                                        eq1="sketch", sketch=spec_j)
    port = t_platform.Continuum.simulate("io", "auto",
                                         t_sim.SimConfig(**cfg),
                                         eq1="sketch", sketch=spec_t)
    assert_same_result(port, ref)
    sim = t_sim.ContinuumSimulator("io", "auto", eq1="sketch",
                                   sketch=spec_t)
    assert sim.control._hist.counts.shape == (1, 128)


def test_live_controller_update_sketch_matches_reference(deterministic_clock):
    """``controller_update`` under ``eq1="sketch"`` on the live runtime:
    each scrape drains the tiers' fresh samples into the histograms;
    R_t, every output and record equal the reference's."""
    pair = Pair(lambda m: two_tier(m, edge=1, cloud=4),
                lambda m: "auto", eq1="sketch", max_steps_per_tick=3,
                max_waves_per_tick=1)
    for cc in pair.ccs:
        for _ in range(6):
            cc.edge.metrics.record_latency("fn", 0.01)
    rid = 0
    prompt = np.arange(6, dtype=np.int32)
    for _ in range(5):
        for _ in range(3):
            pair.submit(rid, prompt + rid, 3 + rid % 3)
            rid += 1
        pair.tick()
        bits_equal(pair.port.control.R_all, pair.ref.control.R_all)
        bits_equal(pair.port.control._hist.counts,
                   pair.ref.control._hist.counts)
    pair.drain()
    pair.check()
    assert pair.port.control.eq1 == "sketch"
    assert pair.port.control._seen.all()
