"""The port's continuum simulator against the reference's, on the CPU.

``repro_torch.core.simulator`` is a copy of the reference's event loop
over the port's own controller, traces and fault schedules.  Both draw
from ``np.random.default_rng(cfg.seed)`` in the same order, and the
port's Eqs (1)-(4) round as the reference's jitted rows kernel does, so
every ``SimResult`` field is compared exactly (``np.array_equal``; NaN
where no request completed in a metric interval): the integer counters,
the per-tier counts and every time series.
"""

import numpy as np
import pytest

from repro import platform as j_platform
from repro.core import simulator as j_sim
from repro.core import topology as j_topo
from repro.workloads import faults as j_faults
from repro.workloads import trace as j_trace
from repro_torch import platform as t_platform
from repro_torch.core import simulator as t_sim
from repro_torch.core import topology as t_topo
from repro_torch.workloads import faults as t_faults
from repro_torch.workloads import trace as t_trace
from test_torch_tier_cost import reference_hardware

SERIES = ("times", "latency_avg", "cpu_util", "mem_mb", "net_MBps",
          "offload_pct", "net_links_MBps")
COUNTS = ("policy", "workload", "successes", "failures", "tier_counts",
          "spilled", "migrations_fired", "migrations_completed",
          "migrations_aborted", "submitted", "replayed", "faults_applied")


def assert_same_result(got, want):
    for f in COUNTS:
        assert getattr(got, f) == getattr(want, f), f
    for f in SERIES:
        a, b = getattr(got, f), getattr(want, f)
        assert a.shape == b.shape, f
        assert np.array_equal(a, b, equal_nan=True), f
    assert got.summary() == pytest.approx(want.summary(), nan_ok=True)


def _topology(mod, kind):
    if kind == "pair":
        return None
    if kind == "dec":
        return mod.Topology.device_edge_cloud()
    # a paged edge: admission needs a slot AND the pages of the request's
    # (prompt_len, max_new) extent
    return mod.Topology(
        (mod.TierSpec("edge", slots=4, max_len=256, page_size=16,
                      pool_pages=24, queue_depth_per_slot=6),
         mod.TierSpec("cloud", slots=64, queue_depth_per_slot=None)),
        (mod.LinkSpec(rtt_s=0.04, bandwidth_Bps=100e6),), waterfall=True)


def _trace(mod, seed=1, duration_s=90.0):
    tr = mod.Trace.bursty(base_rps=2.0, burst_rps=24.0,
                          duration_s=duration_s, mean_on_s=10.0,
                          mean_off_s=20.0, seed=seed)
    rng = np.random.default_rng(seed)
    tr.prompt_len[:] = rng.choice([16, 64, 100, 200], len(tr))
    tr.max_new[:] = rng.integers(1, 48, len(tr))
    return tr


def _pair(workload, policy, kind, dur=300.0, trace=False, faults=None,
          seed=0):
    ref = j_sim.ContinuumSimulator(
        workload, policy, j_sim.SimConfig(duration_s=dur, seed=seed),
        topology=_topology(j_topo, kind),
        trace=_trace(j_trace) if trace else None,
        faults=faults(j_faults) if faults else None).run()
    port = t_sim.ContinuumSimulator(
        workload, policy, t_sim.SimConfig(duration_s=dur, seed=seed),
        topology=_topology(t_topo, kind),
        trace=_trace(t_trace) if trace else None,
        faults=faults(t_faults) if faults else None).run()
    return ref, port


@pytest.mark.parametrize("kind", ["pair", "dec"])
@pytest.mark.parametrize("policy", [0.0, 50.0, "auto", "auto+net",
                                    "auto+migrate", "auto+hedge"])
def test_sim_result_matches_reference(policy, kind):
    ref, port = _pair("matmult", policy, kind)
    assert_same_result(port, ref)
    assert port.successes + port.failures == port.submitted > 0


@pytest.mark.parametrize("kind", ["pair", "dec", "paged"])
@pytest.mark.parametrize("policy", ["auto", "auto+net"])
def test_sim_result_with_trace_matches_reference(policy, kind):
    ref, port = _pair("io", policy, kind, trace=True)
    assert_same_result(port, ref)
    assert port.submitted == len(_trace(t_trace))


_FAULTS = {
    "brownout": lambda m: m.edge_brownout(60.0, 150.0, link=0),
    "outage": lambda m: m.tier_outage(80.0, 140.0, tier=1),
    "partition": lambda m: m.cloud_partition(100.0, 160.0, link=1),
    "merged": lambda m: m.merge_schedules(m.edge_brownout(40.0, 90.0),
                                          m.tier_outage(120.0, 170.0, 0)),
}


@pytest.mark.parametrize("fault", sorted(_FAULTS))
@pytest.mark.parametrize("policy", ["auto+net", "auto+migrate"])
def test_sim_result_under_faults_matches_reference(fault, policy):
    ref, port = _pair("mixed", policy, "dec", dur=240.0,
                      faults=_FAULTS[fault])
    assert_same_result(port, ref)
    assert port.faults_applied == len(_FAULTS[fault](t_faults)) >= 2
    assert port.successes + port.failures == port.submitted


def test_sim_paged_tier_gates_on_pages():
    """The paged ledger binds: a paged edge serves fewer than a dense
    one of the same slots on the same trace, in both packages alike."""
    ref, port = _pair("io", "0", "paged", trace=True)
    assert_same_result(port, ref)
    dense = t_sim.ContinuumSimulator(
        "io", "0", t_sim.SimConfig(),
        topology=t_topo.Topology(
            (t_topo.TierSpec("edge", slots=4, max_len=256,
                             queue_depth_per_slot=6),
             t_topo.TierSpec("cloud", slots=64, queue_depth_per_slot=None)),
            (t_topo.LinkSpec(rtt_s=0.04, bandwidth_Bps=100e6),),
            waterfall=True),
        trace=_trace(t_trace)).run()
    assert port.tier_counts["edge"] < dense.tier_counts["edge"]
    assert port.spilled > dense.spilled


def test_continuum_sweep_and_simulate_match_reference():
    cfg_j = j_sim.SimConfig(duration_s=200.0, seed=3)
    cfg_t = t_sim.SimConfig(duration_s=200.0, seed=3)
    pols = (0.0, 25.0, 100.0, "auto", "auto+net")
    want = j_platform.Continuum.sweep("image_proc", pols, cfg_j,
                                      topology=j_topo.Topology
                                      .device_edge_cloud())
    got = t_platform.Continuum.sweep("image_proc", pols, cfg_t,
                                     topology=t_topo.Topology
                                     .device_edge_cloud())
    assert list(got) == list(want)
    for k in want:
        assert_same_result(got[k], want[k])
    assert_same_result(
        t_platform.Continuum.simulate("io", "auto", cfg_t),
        j_platform.Continuum.simulate("io", "auto", cfg_j))
    got = t_sim.run_policy_sweep("matmult", (50.0, "auto"), cfg_t)
    want = j_sim.run_policy_sweep("matmult", (50.0, "auto"), cfg_j)
    for k in want:
        assert_same_result(got[k], want[k])


def test_sim_replays_the_sim_controller_inputs():
    """``ContinuumSimulator.control`` is the loop a live run's recorded
    controller inputs replay through: fed the simulator's own recorded
    inputs, a fresh loop retraces its R_t exactly (the replay phase 5f of
    chip_smoke.py runs)."""
    sim = t_sim.ContinuumSimulator("matmult", "auto+net",
                                   t_sim.SimConfig(duration_s=200.0),
                                   topology=t_topo.Topology
                                   .device_edge_cloud())
    rec = []
    step = sim.control.step_tiers

    def recording(lats, vals, queue_ages=None, arrivals=None):
        R = step(lats, vals, queue_ages=queue_ages, arrivals=arrivals)
        rec.append(([l.copy() for l in lats], [v.copy() for v in vals],
                    queue_ages, arrivals, R.copy()))
        return R
    sim.control.step_tiers = recording
    sim.run()
    fresh = t_sim.ContinuumSimulator("matmult", "auto+net",
                                     t_sim.SimConfig(window=64),
                                     topology=t_topo.Topology
                                     .device_edge_cloud()).control
    for lats, vals, ages, arrivals, R in rec:
        np.testing.assert_array_equal(
            fresh.step_tiers(lats, vals, queue_ages=ages,
                             arrivals=arrivals), R)
    assert np.asarray([r[-1] for r in rec]).max() > 0


def test_sim_refuses_what_is_not_ported():
    # the sketch front end is ported; a static split cannot drive it
    assert t_sim.ContinuumSimulator("io", "auto",
                                    eq1="sketch").control.eq1 == "sketch"
    with pytest.raises(ValueError):
        t_sim.ContinuumSimulator("io", 50.0, eq1="sketch")
    # hedging is ported: the simulator takes "auto+hedge" as the
    # reference does (its boundaries run the auto controller)
    assert type(t_sim.ContinuumSimulator("io", "auto+hedge").control
                .policy).__name__ == "HedgedOffload"
    # the cost-modeled chain is ported: under the reference's hardware
    # constants it resolves as the reference's does, and simulates alike
    want = j_topo.Topology.device_edge_cloud(cost_model=True)
    got = t_topo.Topology.device_edge_cloud(cost_model=True,
                                            hw=reference_hardware())
    for a, b in zip(got.tiers, want.tiers):
        assert (a.slots, a.decode_step_ms, a.service_rate_mult) == (
            b.slots, b.decode_step_ms, b.service_rate_mult), a.name
    assert_same_result(
        t_sim.ContinuumSimulator("io", "auto", t_sim.SimConfig(
            duration_s=120.0), topology=got).run(),
        j_sim.ContinuumSimulator("io", "auto", j_sim.SimConfig(
            duration_s=120.0), topology=want).run())
    with pytest.raises(ValueError):
        t_sim.ContinuumSimulator("nope", "auto")
    with pytest.raises(TypeError):
        t_sim.ContinuumSimulator("io", "auto", trace=[1.0, 2.0])
