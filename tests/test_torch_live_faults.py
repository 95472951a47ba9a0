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
  identities after every tick.
"""

import numpy as np
import pytest

from test_torch_chain import (_bursty, _chain,  # noqa: F401
                              _sequential_reference, deterministic_clock)
from torch_live import PACKAGES, Pair, migrate_split, two_tier

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
