"""The live controls on the recurrent families, in the port, against the
reference, on the CPU at smoke width.

``test_torch_hedge``, ``test_torch_live_faults`` and
``test_torch_scheduler`` drive stablelm; here the same continuum cases
run rwkv6-7b (WKV state alone, no KV cache) and hymba-1.5b (window KV,
global KV and SSM state) through both packages (``tests/torch_live.py``):
a migration mid-decode beside a second resident, a landing that crosses
a tick over a slow link, a hedge on every request over three ticks, and
an edge crash with residents and its restore.  Every output, failure,
latency, per-tick record, counter and link byte is held equal, and each
migrated stream also equals the port's unmigrated one.
"""

import numpy as np
import pytest

from test_torch_chain import (_sequential_reference,  # noqa: F401
                              deterministic_clock)  # noqa: F401
from test_torch_migration import _solo
from torch_live import Pair, always_hedge, migrate_split, two_tier

PROMPT = np.arange(6, dtype=np.int32)
ARCHS = ["rwkv6-7b", "hymba-1.5b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_migration_mid_decode_beside_a_resident(arch, deterministic_clock):
    """Two rows resident at the edge; R_t crosses the threshold after
    three steps, the longer one moves to the cloud, both finish with the
    ids of their unmigrated runs."""
    pair = Pair(lambda m: two_tier(m, rtt=0.02),
                lambda m: migrate_split(m, 100.0, thr=None), arch=arch,
                max_steps_per_tick=3)
    keep = PROMPT + 5
    pair.resident(0, PROMPT, 12)
    pair.resident(1, keep, 9)
    assert pair.tick()["inflight"] == 2
    for cc in pair.ccs:
        cc.policy.migrate_threshold = 50.0
    assert pair.tick()["migrations_fired"] >= 1
    pair.drain()
    pair.check()
    c = pair.port.metrics.counter
    assert c("migrations_completed") >= 1 and c("migrations_aborted") == 0
    assert pair.served()["cloud"] >= 1
    assert list(pair.reqs[1][0].output) == _solo(12, arch=arch)
    assert list(pair.reqs[1][1].output) == _solo(9, arch=arch, tokens=keep)


@pytest.mark.parametrize("arch", ARCHS)
def test_cross_tick_landing_over_slow_link(arch, deterministic_clock):
    pair = Pair(lambda m: two_tier(m, rtt=0.6),
                lambda m: migrate_split(m, 100.0), arch=arch,
                max_steps_per_tick=1)
    pair.resident(0, PROMPT, 8)
    pair.resident(1, PROMPT, 2)          # too near done to migrate
    rec = pair.tick()
    assert rec["migrations_fired"] == 1
    assert pair.port.migrations_open == 1 and rec["inflight"] >= 1
    ticks = 1 + pair.drain()
    pair.check()
    assert ticks >= 2 and pair.port.migrations_open == 0
    assert pair.port.metrics.counter("migrations_completed") == 1
    assert list(pair.reqs[1][0].output) == _solo(8, arch=arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_hedge_every_request_over_three_ticks(arch, deterministic_clock):
    pair = Pair(lambda m: two_tier(m), lambda m: always_hedge(m),
                arch=arch)
    rid = 0
    for _ in range(3):
        for _ in range(3):
            pair.submit(rid, PROMPT + rid, 1 + rid % 3)
            rid += 1
        pair.tick()                      # identities checked in tick()
        assert pair.port.hedges_open == 0
    pair.check()
    assert pair.port.metrics.counter("hedges_fired") > 0
    assert sum(len(t.metrics.latency_values("fn"))
               for t in pair.port.tiers) == rid
    assert sum(pair.served().values()) == rid


@pytest.mark.parametrize("arch", ARCHS)
def test_edge_crash_with_residents_and_restore(arch, deterministic_clock):
    """Residents of the crashed edge replay at the cloud; the restored
    edge re-registers through the replication path and serves again."""
    pair = Pair(lambda m: two_tier(m, edge=2, cloud=8), lambda m: "auto",
                arch=arch, max_steps_per_tick=2)
    rng = np.random.default_rng(0)
    for rid in range(4):
        pair.submit(rid, rng.integers(0, 64, 5), 6)
    pair.tick()
    assert pair.port.in_flight > 0
    pair.fault(0.0, "crash_tier", 0)
    assert pair.port.tier_up == [False, True]
    assert pair.port.metrics.counter("replayed") > 0
    pair.drain()
    pair.fault(0.0, "restore_tier", 0)
    assert pair.port.tier_up == [True, True]
    assert pair.port.replicators[0].writes == 1
    pair.submit(10, PROMPT, 3)
    pair.drain()
    pair.check()
    assert all(r.output is not None and not r.failed
               for r in pair.reqs[1].values())
