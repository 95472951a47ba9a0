"""Straggler hedging and the continuous loop's cancellation in the port,
against the reference, on the CPU at smoke width.

* ``HedgedOffload``'s tail estimate (numpy's percentile on both sides)
  and ``router.hedged_mask``, bitwise on random windows;
* the tier primitives of ``tests/test_async_serving.py`` (admit, step,
  retire, ``cancel`` freeing its slot the same step, an eviction that
  leaves its neighbour's stream unchanged), run on both packages' tiers;
* the continuum cases: a short request overtaking a long one, a hedge
  loser evicted the step its sibling completes, the accounting identity
  ``hedges_fired == won + cancelled + open`` after every tick, and a race
  that survives a tick boundary; then the real ``"auto+hedge"`` policy
  with latencies seeded so that it fires.  Each through both packages
  (``tests/torch_live.py``), every output, latency, per-tick record and
  counter equal.
"""

import numpy as np
import pytest
import torch

from repro.core import policy as j_policy
from repro.core import router as j_router
from repro.core.replication import AutoscalingPolicy as JAutoscaling
from repro.serving import tiers as j_tiers
from repro_torch.core import policy as t_policy
from repro_torch.core import router as t_router
from repro_torch.core.replication import AutoscalingPolicy as TAutoscaling
from repro_torch.serving import tiers as t_tiers
from test_torch_chain import (_sequential_reference,  # noqa: F401
                              deterministic_clock)  # noqa: F401
from torch_live import Pair, always_hedge, models, two_tier

PROMPT = np.arange(6, dtype=np.int32)


@pytest.mark.parametrize("spec", ["auto+hedge", "auto+net+hedge",
                                  "auto+hedge+migrate"])
@pytest.mark.parametrize("seed", [0, 1])
def test_hedge_decisions_match_reference(spec, seed):
    rng = np.random.default_rng(seed)
    F, W, B = 3, 16, 40
    lat = rng.gamma(2.0, 0.05, (F, W)).astype(np.float32)
    valid = rng.random((F, W)) < 0.7
    valid[2] = False                       # never observed: never hedge
    ages = rng.gamma(2.0, 0.08, B).astype(np.float32)
    fn_ids = rng.integers(0, F, B).astype(np.int32)
    ref = j_policy.Policy.parse(spec)
    port = t_policy.Policy.parse(spec)
    assert type(port).__name__ == type(ref).__name__ == "HedgedOffload"
    assert port.spec == ref.spec
    assert port.hedge_quantile == ref.hedge_quantile
    np.testing.assert_array_equal(port._tail_estimate(lat, valid),
                                  ref._tail_estimate(lat, valid))
    want = ref.hedge(None, ages, fn_ids, lat, valid)
    got = port.hedge(ages, fn_ids, lat, valid)
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got[fn_ids == 2].any()
    assert port.hedge(ages[:0], fn_ids[:0], lat, valid).shape == (0,)
    p99 = ref._tail_estimate(lat, valid)
    np.testing.assert_array_equal(
        t_router.hedged_mask(torch.from_numpy(ages), torch.from_numpy(p99),
                             torch.from_numpy(fn_ids)).numpy(),
        np.asarray(j_router.hedged_mask(None, ages, p99, fn_ids)))
    # a policy that does not hedge marks nothing (and draws nothing)
    assert not t_policy.Policy.parse("auto").hedge(ages, fn_ids, lat,
                                                   valid).any()


# ---- tier-level primitives --------------------------------------------------

def _tiers(slots):
    cfg_j, pj, cfg_t, pt = models()
    ref = j_tiers.Tier("t", j_tiers.TierConfig(slots=slots, max_len=64))
    ref.deploy("fn", cfg_j, pj, JAutoscaling())
    port = t_tiers.Tier("t", t_tiers.TierConfig(slots=slots, max_len=64),
                        "cpu")
    port.deploy("fn", cfg_t, pt, TAutoscaling())
    return ((ref, j_tiers), (port, t_tiers))


def _queued(tiers, rid, max_new):
    return tiers._Queued("fn", tiers.Request(rid=rid, tokens=PROMPT.copy(),
                                             max_new=max_new), t_submit=0.0)


def test_tier_admit_step_retire():
    outs = []
    for tier, mod in _tiers(4):
        short, long = _queued(mod, 0, 2), _queued(mod, 1, 5)
        in_flight, finished = tier.admit("fn", [short, long])
        assert len(in_flight) == 2 and not finished
        done = tier.step("fn")
        assert [r.item.req.rid for r in done] == [0]
        assert tier.inflight_count("fn") == 1
        assert tier.endpoints["fn"].active == 1
        tier.finish("fn", done[0])
        for _ in range(3):
            done = tier.step("fn")
        assert [r.item.req.rid for r in done] == [1]
        tier.finish("fn", done[0])
        outs.append((list(short.req.output), list(long.req.output)))
    assert outs[1] == outs[0]


def test_tier_cancel_frees_slot_same_step():
    outs = []
    for tier, mod in _tiers(2):
        tier.admit("fn", [_queued(mod, 0, 8), _queued(mod, 1, 8)])
        assert tier.free_slots("fn") == 0
        loser = next(iter(tier.inflight["fn"]))
        rec = tier.cancel("fn", loser)
        assert tier.free_slots("fn") == 1
        assert rec.item.req.output is None           # no result, no sample
        in_flight, _ = tier.admit("fn", [_queued(mod, 2, 3)])
        assert in_flight[0].slot == loser            # same slot, same step
        assert not tier.step("fn") and tier.inflight_count("fn") == 2
        outs.append(sorted((r.item.req.rid, r.toks)
                           for r in tier.inflight["fn"].values()))
    assert outs[1] == outs[0]
    assert len(outs[1][0][1]) == 2


def test_cancelled_slot_does_not_corrupt_neighbors():
    for tier, mod in _tiers(2)[1:]:
        def run(with_neighbor):
            keep = _queued(mod, 0, 6)
            tier.admit("fn", [keep] + ([_queued(mod, 1, 6)]
                                       if with_neighbor else []))
            other = next((s for s, r in tier.inflight["fn"].items()
                          if r.item.req.rid == 1), None)
            done = []
            for step in range(6):
                if with_neighbor and step == 2:
                    tier.cancel("fn", other)
                done += tier.step("fn")
            [rec] = done
            tier.finish("fn", rec)
            return list(keep.req.output)
        assert run(True) == run(False)


# ---- continuum level --------------------------------------------------------

def test_short_requests_overtake_long_in_flight(deterministic_clock):
    pair = Pair(lambda m: two_tier(m), lambda m: 0.0)
    pair.submit(0, PROMPT, 16)
    for i in range(4):
        pair.submit(1 + i, PROMPT, 2)
    rec = pair.tick()
    pair.check()
    assert rec["edge"] == 5 and rec["inflight"] == 0
    reqs = pair.reqs[1]
    assert all(reqs[i].t_done < reqs[0].t_done for i in range(1, 5))
    assert rec["steps"] <= 16 and rec["waves"] >= 2


def test_hedge_loser_evicted_when_sibling_completes(deterministic_clock):
    """The cloud is busy with a long request until its step 5, so the
    twin is admitted late and is mid-decode when the primary retires:
    the twin is cancelled, records nothing, and the tick ends early."""
    pair = Pair(lambda m: two_tier(m, edge=2, cloud=1),
                lambda m: always_hedge(m), fns=("blk", "fn"))
    pair.push(9, PROMPT, 6, tier=1, fn="blk")
    assert pair.submit(1, PROMPT, 8)
    rec = pair.tick()
    pair.check()
    c = pair.port.metrics.counters
    assert rec["hedged"] == 1 and c["hedges_fired"] == 1
    assert c["hedges_cancelled"] == 1 and c.get("hedges_won", 0) == 0
    assert pair.port.hedges_open == 0
    assert 7 <= rec["steps"] < 12 and rec["inflight"] == 0
    assert pair.port.tiers[1].endpoints["fn"].active == 0
    assert pair.reqs[1][1].output.shape == (8,)
    assert len(pair.port.tiers[0].metrics.latency_values("fn")) == 1
    assert len(pair.port.tiers[1].metrics.latency_values("fn")) == 0
    assert len(pair.port.tiers[1].metrics.latency_values("blk")) == 1


def test_hedge_accounting_identity(deterministic_clock):
    pair = Pair(lambda m: two_tier(m), lambda m: always_hedge(m))
    rid = 0
    for _ in range(4):
        for _ in range(3):
            pair.submit(rid, PROMPT, 1 + rid % 3)
            rid += 1
        pair.tick()                          # identities checked in tick()
        assert pair.port.hedges_open == 0
    pair.check()
    assert sum(len(t.metrics.latency_values("fn"))
               for t in pair.port.tiers) == rid
    assert sum(pair.served().values()) == rid


def test_hedge_race_survives_tick_boundary(deterministic_clock):
    """The edge admits nothing, so the twin decodes on the cloud across
    the tick boundary while its primary waits; the race settles next
    tick and the request is served once."""
    edge = lambda m: dict(autoscaling=m["asc"](min_scale=0,  # noqa: E731
                                               max_scale=0))
    pair = Pair(lambda m: two_tier(m, edge_kw=edge(m)),
                lambda m: always_hedge(m), max_steps_per_tick=2)
    assert pair.submit(1, PROMPT, 6)
    rec = pair.tick()
    assert rec["inflight"] == 1 and pair.port.hedges_open == 1
    ticks = 1 + pair.drain()
    pair.check()
    assert pair.port.hedges_open == 0 and ticks >= 2
    assert pair.port.metrics.counters["hedges_won"] == 1
    assert pair.reqs[1][1].output.shape == (6,)
    assert sum(pair.served().values()) == 1


def test_auto_hedge_policy_live_matches_reference(deterministic_clock):
    """``"auto+hedge"`` itself: short latencies recorded at the ingress
    make its p99 small, so the requests that wait a tick in the bounded
    edge's backlog hedge onto the cloud."""
    pair = Pair(lambda m: two_tier(m, edge=1, cloud=4),
                lambda m: "auto+hedge", max_steps_per_tick=3,
                max_waves_per_tick=1)
    for cc in pair.ccs:
        for _ in range(8):
            cc.edge.metrics.record_latency("fn", 0.01)
    rid = 0
    for rnd in range(4):
        for _ in range(3):
            pair.submit(rid, PROMPT + rid, 4 + rid % 3)
            rid += 1
        pair.tick()
    pair.drain()
    pair.check()
    c = pair.port.metrics.counter
    assert c("hedges_fired") > 0
    assert c("hedges_fired") == c("hedges_won") + c("hedges_cancelled")
    assert all(r.output.shape == (r.max_new,) for r in pair.reqs[1].values())
