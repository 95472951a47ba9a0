"""Live fault injection in the port, against the reference, on the CPU
at smoke width.

Fault events reach the live runtime through ``faults=`` (applied at the
top of each tick on the logical clock) or ``apply_fault``.  Each case
runs through both packages (``tests/torch_live.py``), every output,
failure, latency, per-tick record, counter and link byte equal:

* the serving cases of ``tests/test_fault_tolerance.py``: an edge crash
  with residents (they replay at the cloud), a restore that
  re-registers through the replication path, a deep-tier crash whose
  survivors stay local;
* a partition that aborts a migration in flight (the row resumes at its
  source with the unmigrated ids), a request with nowhere to go (503);
* a link fault re-capping a net-aware boundary;
* the 3-tier chain under ``"auto+net+hedge+migrate"`` from a bursty trace
  with a brownout and an edge outage, conservation and both accounting
  identities after every tick;
* a restore of a tier that is already up (and a crash of one already
  down): a no-op in the port's live runtime and simulator alike, where
  the reference's live runtime redeploys the tier and loses its
  resident row.
"""

import numpy as np
import pytest

from test_torch_chain import (_bursty, _chain,  # noqa: F401
                              _sequential_reference, deterministic_clock)
from repro.workloads.faults import KINDS
from repro.workloads.trace import Trace as JTrace
from repro_torch.workloads.trace import Trace as TTrace
from torch_live import PACKAGES, Pair, migrate_split, models, two_tier

PROMPT = np.arange(6, dtype=np.int32)


def _crash_pair(**kw):
    return Pair(lambda m: two_tier(m, edge=2, cloud=8), lambda m: "auto",
                **kw)


def test_serving_edge_crash_replays_residents(deterministic_clock):
    pair = _crash_pair(max_steps_per_tick=2)
    rng = np.random.default_rng(0)
    for rid in range(6):
        pair.submit(rid, rng.integers(0, 64, 5), 8)
    pair.tick()
    assert pair.port.in_flight > 0
    pair.fault(0.0, "crash_tier", 0)
    assert pair.port.tier_up == [False, True]
    assert pair.port.tiers[0].endpoints == {}
    assert pair.port.metrics.counter("replayed") > 0
    pair.drain()
    pair.check()
    assert all(r.output is not None and not r.failed
               for r in pair.reqs[1].values())


def test_serving_restore_reregisters_through_replication(
        deterministic_clock):
    pair = _crash_pair()
    old = pair.port.replicators[0]
    assert old.writes >= 1
    pair.fault(0.0, "crash_tier", 0)
    fresh = pair.port.replicators[0]
    assert fresh is not old and fresh.writes == 0
    pair.fault(0.0, "restore_tier", 0)
    assert pair.port.tier_up[0] and fresh.writes == 1
    assert fresh.get("fn") is not None
    ep = pair.port.tiers[0].endpoints["fn"]
    assert ep.params is pair.port.cloud.endpoints["fn"].params
    assert pair.port.tiers[0].replicas("fn") == pair.ref.tiers[0].replicas(
        "fn")
    pair.submit(0, PROMPT, 3)
    pair.drain()
    pair.check()
    assert pair.served() == {"edge": 1, "cloud": 0}


def test_serving_deep_tier_crash_survivors_stay_local(deterministic_clock):
    pair = _crash_pair()
    pair.fault(0.0, "crash_tier", 1)
    rng = np.random.default_rng(1)
    for rid in range(4):
        pair.submit(rid, rng.integers(0, 64, 5), 2)
    pair.drain()
    assert all(r.output is not None and not r.failed
               for r in pair.reqs[1].values())
    pair.fault(0.0, "restore_tier", 1)
    assert "fn" in pair.port.tiers[1].endpoints
    pair.check()


def test_partition_aborts_migration_in_flight(deterministic_clock):
    """A row in flight over a slow link when the link partitions aborts
    back to its source at once and finishes there, unchanged."""
    pair = Pair(lambda m: two_tier(m, rtt=0.6),
                lambda m: migrate_split(m, 100.0), max_steps_per_tick=1)
    pair.resident(0, PROMPT, 8)
    pair.resident(1, PROMPT, 2)
    assert pair.tick()["migrations_fired"] == 1
    assert pair.port.migrations_open == 1
    pair.fault(0.0, "partition_link", 0)
    rec = pair.tick()
    assert rec["migrations_aborted"] == 1 and pair.port.migrations_open == 0
    pair.drain()
    pair.check()
    c = pair.port.metrics.counter
    assert c("migrations_aborted") == 1 and c("migrations_completed") == 0
    solo = Pair(lambda m: two_tier(m), lambda m: 0.0)
    solo.submit(0, PROMPT, 8)
    solo.tick()
    np.testing.assert_array_equal(pair.reqs[1][0].output,
                                  solo.reqs[1][0].output)


def test_nothing_reachable_fails_the_request(deterministic_clock):
    pair = _crash_pair()
    pair.fault(0.0, "crash_tier", 0)
    pair.fault(0.0, "partition_link", 0)
    pair.submit(0, PROMPT, 3)
    rec = pair.tick()
    pair.check()
    assert pair.reqs[1][0].failed and rec["edge"] == rec["cloud"] == 0


def test_link_fault_recaps_net_aware_boundary():
    """A brownout re-caps the boundary whose link it hits (and only that
    one), a partition caps it to ~0, a restore brings the spec back."""
    pair = Pair(lambda m: _chain(m["topo"], m["asc"], False),
                lambda m: "auto+net", req_bytes=4.0e3)

    def caps(cc):
        return [p.cfg.link_bytes_per_s for p in cc.control.policies]
    pair.fault(0.0, "degrade_link", 1, bw_mult=0.1, rtt_mult=3.0)
    assert caps(pair.port) == caps(pair.ref) == [50e6, 100e6 * 0.1]
    pair.fault(0.0, "partition_link", 0)
    assert caps(pair.port) == caps(pair.ref) == [1e-6, 100e6 * 0.1]
    assert not pair.port.link_state[0].up
    pair.fault(0.0, "restore_link", 0)
    pair.fault(0.0, "restore_link", 1)
    assert caps(pair.port) == caps(pair.ref) == [50e6, 100e6]
    assert pair.port.metrics.counter("faults_applied") == 4


def test_faults_validated_against_topology():
    for m in PACKAGES:
        bad = m["faults"].FaultSchedule(
            [m["faults"].FaultEvent(1.0, "crash_tier", 3)])
        with pytest.raises(ValueError, match="tier"):
            m["platform"].Continuum.from_topology(
                two_tier(m), faults=bad,
                **({} if m is PACKAGES[0] else {"device": "cpu"}))


# traces whose edge holds residents when it crashes (parity holds for the
# others too, but their crash replays nothing)
@pytest.mark.parametrize("seed", [3, 6])
def test_chain_live_controls_under_faults(deterministic_clock, seed):
    """The 3-tier chain (device dense, edge and cloud paged) under
    ``"auto+net+hedge+migrate"``: a bursty trace, a brownout of link 0,
    the edge crashed for two ticks while it holds residents, short
    latencies recorded at the ingress so that hedges fire.  Held per
    request, per tick and per counter; conservation after drain."""
    paged = dict(page_size=8, pool_pages=16)

    def topo(m):
        t = _chain(m["topo"], m["asc"], True)
        return m["topo"].Topology(
            (t.tiers[0], t.tiers[1],
             m["topo"].TierSpec("cloud", slots=6, max_len=32,
                                extra_latency_s=0.02, **paged)),
            t.links, waterfall=True)

    def faults(m):
        f = m["faults"]
        return f.merge_schedules(f.edge_brownout(1.0, 4.0, link=0),
                                 f.tier_outage(3.0, 5.0, tier=1))

    pair = Pair(topo, lambda m: "auto+net+hedge+migrate",
                req_bytes=4.0e3, trace_vocab=64, max_steps_per_tick=4)
    for k, cc in enumerate(pair.ccs):
        cc.trace = _bursty(PACKAGES[k]["platform"], seed)
        cc.faults = faults(PACKAGES[k]).validate(3)
    for tick in range(10):
        if tick in (2, 3, 6):
            # a window of short samples: the ingress p99 drops below the
            # age of every request left waiting from an earlier tick
            for cc in pair.ccs:
                for _ in range(64):
                    cc.edge.metrics.record_latency("fn", 0.001)
        pair.tick()
    pair.drain()
    for k in range(2):
        pair.reqs[k].update({r.rid: r for r in pair.ccs[k].trace_requests})
    pair.check()
    c = pair.port.metrics.counter
    reqs = pair.port.trace_requests
    served = sum(pair.served().values())
    assert served + sum(r.failed for r in reqs) == len(reqs)
    assert pair.port.queued == 0 and pair.port.in_flight == 0
    assert c("faults_applied") == 4 and c("replayed") >= 1
    assert c("hedges_fired") > 0
    assert all(r.output.shape == (r.max_new,) for r in reqs if not r.failed)


def _restore_scenario(k, drop=()):
    """The case ``tests/test_parity_fuzz.py::test_conservation_under_faults_fuzz``
    draws at seed 5632, through package ``k`` (0: the reference, 1: the
    port): one tier of 2 slots, ``"auto+migrate"``, one decode step a
    tick, a Poisson trace of 21 requests, and two crash / restore pairs
    on the tier (crash, crash, restore, restore).  The draws are the
    fuzz test's, in its order.  ``drop`` leaves out the events at those
    indices.  Returns (the continuum's trace requests, the schedule)."""
    m = PACKAGES[k]
    rng = np.random.default_rng(5632 + 77_000)
    assert int(rng.integers(1, 4)) == 1                  # one tier
    slots = int(rng.integers(1, 3))
    topo = m["topo"].Topology(
        (m["topo"].TierSpec("t0", slots=slots, max_len=32,
                            queue_depth_per_slot=None),), (),
        waterfall=bool(rng.uniform() < 0.5))
    policy = ("auto+migrate" if int(rng.integers(0, 8)) == 6 else None)
    trace = (JTrace, TTrace)[k].poisson(
        rps=float(rng.uniform(1.0, 4.0)), duration_s=8.0, fn_names=("fn",),
        seed=5632, prompt_len=5, max_new=int(rng.integers(1, 5)))
    events = []
    for _ in range(int(rng.integers(1, 4))):
        kind = KINDS[int(rng.integers(0, len(KINDS)))]
        if kind in ("degrade_link", "partition_link", "restore_link"):
            continue                            # no link on one tier
        assert int(rng.integers(0, 1)) == 0     # crash_tier, tier 0
        t0 = float(rng.uniform(0.0, 4.0))
        t1 = float(rng.uniform(t0 + 0.5, 6.4))
        events += [(t0, "crash_tier"), (t1, "restore_tier")]
    events.sort()
    f = m["faults"]
    faults = f.FaultSchedule([f.FaultEvent(t, kind, 0)
                              for i, (t, kind) in enumerate(events)
                              if i not in drop])
    steps = None if rng.uniform() < 0.5 else int(rng.integers(1, 4))
    cfg_j, pj, cfg_t, pt = models()
    cc = m["platform"].Continuum.from_topology(
        topo, policy=policy, seed=5632, trace=trace, faults=faults,
        max_steps_per_tick=steps, **({} if k == 0 else {"device": "cpu"}))
    assert (slots, policy, steps) == (2, "auto+migrate", 1)
    cc.deploy(m["spec"](name="fn", arch="stablelm-1.6b",
                        autoscaling=m["asc"]()),
              *((cfg_j, pj), (cfg_t, pt))[k])
    for _ in range(12):
        cc.tick()
    cc.drain()
    return cc, events


def _outcome(cc):
    return [(r.rid, r.failed, None if r.output is None
             else np.asarray(r.output).tolist()) for r in cc.trace_requests]


def test_restore_of_a_live_tier_loses_nothing():
    """A restore of a tier that is up is a no-op in the port, live as in
    the simulator; the reference's live runtime redeploys the tier, frees
    its resident row's slot in the new pool and loses request 16."""
    port, events = _restore_scenario(1)
    ref, _ = _restore_scenario(0)
    assert [(round(t, 2), kind) for t, kind in events] == [
        (1.39, "crash_tier"), (2.77, "crash_tier"),
        (4.23, "restore_tier"), (5.80, "restore_tier")]
    reqs = port.trace_requests
    assert len(reqs) == len(ref.trace_requests) == 21
    for r in reqs:                              # served XOR failed, once
        assert (r.output is not None) != r.failed, r.rid
    assert port.metrics.counter("faults_applied") == 4
    lost = [r.rid for r in ref.trace_requests
            if r.output is None and not r.failed]
    assert lost == [16]                         # the reference's defect
    # the second crash (of a tier that is down) and the second restore
    # (of a tier that is up) change nothing, live or simulated
    for drop in ((1,), (3,), (1, 3)):
        assert _outcome(_restore_scenario(1, drop)[0]) == _outcome(port)
    m = PACKAGES[1]
    topo = m["topo"].Topology((m["topo"].TierSpec("t0", slots=2,
                                                  max_len=32),), ())
    sims = []
    for drop in ((), (3,)):
        f = m["faults"]
        sched = f.FaultSchedule([f.FaultEvent(t, kind, 0)
                                 for i, (t, kind) in enumerate(events)
                                 if i not in drop])
        r = m["platform"].Continuum.simulate(
            "matmult", "auto+migrate", topology=topo, faults=sched)
        sims.append((r.successes, r.failures, r.tier_counts))
    assert sims[0] == sims[1]
