"""The per-tick caps and the ``scheduler="wave"`` baseline in the port,
against the reference, on the CPU at smoke width.

* ``max_steps_per_tick``: slot-resident work carries across ticks, and a
  paced tick still admits beside it;
* ``max_waves_per_tick``: leftovers requeue to their own tier's gateway,
  sorted by submit time with their stamps kept (monotone backlog age),
  and a full bounded backlog 503s them and says so;
* ``scheduler="wave"``: ``Tier.serve_batch`` / ``serve_one``, waves run
  to completion, hedge pairs resolved by latency, the migrate warning;
* the 3-tier chain from a bursty trace under ``"auto"`` with both caps,
  and under the wave scheduler.

Each continuum case runs through both packages (``tests/torch_live.py``):
every output, failure, latency, per-tick record and counter equal.
"""

import numpy as np
import pytest

from repro.core.replication import AutoscalingPolicy as JAutoscaling
from repro.serving import tiers as j_tiers
from repro_torch.core.replication import AutoscalingPolicy as TAutoscaling
from repro_torch.serving import tiers as t_tiers
from test_torch_chain import (_bursty, _chain,  # noqa: F401
                              _sequential_reference, deterministic_clock)
from torch_live import PACKAGES, Pair, always_hedge, models, two_tier

PROMPT = np.arange(6, dtype=np.int32)


def test_max_steps_keeps_requests_in_flight_across_ticks(
        deterministic_clock):
    pair = Pair(lambda m: two_tier(m), lambda m: 0.0, max_steps_per_tick=3)
    pair.submit(0, PROMPT, 12)
    rec = pair.tick()
    assert rec["inflight"] == 1 and rec["steps"] == 3
    pair.submit(1, PROMPT, 2)
    rec = pair.tick()
    assert pair.reqs[1][1].output is not None
    assert pair.reqs[1][0].output is None and rec["inflight"] == 1
    pair.drain()
    pair.check()
    assert pair.reqs[1][0].output.shape == (12,)
    assert sum(pair.served().values()) == 2


def test_paced_tick_still_admits_alongside_inflight(deterministic_clock):
    pair = Pair(lambda m: two_tier(m), lambda m: 0.0, max_steps_per_tick=1)
    pair.submit(0, PROMPT, 12)
    pair.tick()
    pair.submit(1, PROMPT, 2)
    rec = pair.tick()
    assert rec["waves"] == 1 and rec["inflight"] == 2
    rec = pair.tick()
    assert pair.reqs[1][1].output is not None and rec["inflight"] == 1
    pair.drain()
    pair.check()


def _one_replica(m):
    return m["asc"](min_scale=1, max_scale=1, target_concurrency=1.0)


def test_requeue_preserves_submit_and_tick_stamps(deterministic_clock):
    pair = Pair(lambda m: two_tier(m), lambda m: 0.0, max_waves_per_tick=1,
                fns=())
    for k, cc in enumerate(pair.ccs):
        m = PACKAGES[k]
        cfg, params = models()[2 * k:2 * k + 2]
        cc.deploy(m["spec"](name="fn", arch="stablelm-1.6b",
                            autoscaling=_one_replica(m)), cfg, params)
    for i in range(4):
        assert pair.submit(i, PROMPT, 1)
    stamps = {it.req.rid: (it.t_submit, it.tick_no)
              for it in pair.port.gateways[0].items}
    pair.tick()
    left = list(pair.port.gateways[0].items)
    assert len(left) == 3
    assert all((it.t_submit, it.tick_no) == stamps[it.req.rid]
               for it in left)
    assert [it.t_submit for it in left] == sorted(it.t_submit for it in left)
    now = deterministic_clock["port"].now
    ages1 = pair.port.gateways[0].backlog_ages(now, pair.port._tick_no,
                                               pair.port._fn_ids, 1)
    pair.tick()
    now = deterministic_clock["port"].now
    ages2 = pair.port.gateways[0].backlog_ages(now, pair.port._tick_no,
                                               pair.port._fn_ids, 1)
    assert len(ages1[0]) == 3 and len(ages2[0]) == 2
    assert min(ages2[0]) > min(ages1[0]) > 0.0
    pair.drain()
    pair.check()


def test_requeued_items_survive_to_completion(deterministic_clock):
    pair = Pair(lambda m: two_tier(m), lambda m: 0.0, max_waves_per_tick=1)
    for i in range(5):
        assert pair.submit(i, PROMPT + i, 2)
    for _ in range(8):
        if pair.port.queued == 0 and pair.port.in_flight == 0:
            break
        pair.tick()
    pair.check()
    assert all(r.output is not None for r in pair.reqs[1].values())
    assert sum(pair.served().values()) == 5


def test_full_backlog_rejects_requeued_leftovers(deterministic_clock):
    """A bounded edge backlog (1 slot x depth 2) and one admission round a
    tick: leftovers past the bound are 503'd at requeue, counted in the
    tick's ``rejected`` and flagged ``failed``."""
    edge = dict(queue_depth_per_slot=2)
    pair = Pair(lambda m: two_tier(m, edge=1, edge_kw=edge), lambda m: 0.0,
                max_waves_per_tick=1)
    accepted = [pair.submit(i, PROMPT + i, 3) for i in range(2)]
    assert accepted == [True, True]
    for i in range(2, 5):
        for k, cc in enumerate(pair.ccs):
            tiers = PACKAGES[k]["tiers"]
            req = pair._request(k, i, PROMPT + i, 3)
            cc.gateways[0].push(tiers._Queued("fn", req, 0.0), force=True)
    rec = pair.tick()
    assert rec["rejected"] == 2 and rec["backlog"]["edge"] == 2
    pair.drain()
    pair.check()
    failed = [r.rid for r in pair.reqs[1].values() if r.failed]
    assert len(failed) == 2
    assert pair.port.metrics.counter("rejected") == 2


# ---- the wave scheduler -----------------------------------------------------

def test_serve_batch_and_serve_one_match_reference(deterministic_clock):
    cfg_j, pj, cfg_t, pt = models()
    outs = []
    for mod, asc, cfg, params, extra in (
            (j_tiers, JAutoscaling, cfg_j, pj, ()),
            (t_tiers, TAutoscaling, cfg_t, pt, ("cpu",))):
        tier = mod.Tier("t", mod.TierConfig(slots=3, max_len=64), *extra)
        tier.deploy("fn", cfg, params, asc())
        reqs = [mod.Request(rid=i, tokens=PROMPT + i, max_new=2 + i)
                for i in range(3)]
        res = tier.serve_batch("fn", [(r, 100.0) for r in reqs],
                               record=[True, False, True])
        one = mod.Request(rid=9, tokens=PROMPT, max_new=4)
        out, lat = tier.serve_one("fn", one)
        assert tier.endpoints["fn"].active == 0
        outs.append(([(list(o), l) for o, l in res], list(out), lat,
                     tier.metrics.latency_values("fn").tolist()))
    assert outs[1] == outs[0]
    assert len(outs[1][3]) == 3                    # the masked one is not


def test_serve_batch_releases_slots_on_failure():
    cfg_j, pj, cfg_t, pt = models()
    tier = t_tiers.Tier("t", t_tiers.TierConfig(slots=2, max_len=64), "cpu")
    tier.deploy("fn", cfg_t, pt, TAutoscaling())
    ep = tier.endpoints["fn"]

    def broken(tokens_by_slot):
        raise RuntimeError("decode failed")
    ep.decode_all = broken
    reqs = [t_tiers.Request(rid=i, tokens=PROMPT, max_new=3)
            for i in range(2)]
    with pytest.raises(RuntimeError, match="decode failed"):
        tier.serve_batch("fn", [(r, 0.0) for r in reqs])
    assert ep.active == 0
    with pytest.raises(RuntimeError, match="exceeds free slots"):
        tier.serve_batch("fn", [(t_tiers.Request(rid=i, tokens=PROMPT),
                                 0.0) for i in range(3)])
    assert ep.active == 0


@pytest.mark.parametrize("policy", ["0", "50"])
def test_wave_scheduler_matches_reference(deterministic_clock, policy):
    pair = Pair(lambda m: _chain(m["topo"], m["asc"], True),
                lambda m: policy, scheduler="wave", max_waves_per_tick=3)
    rng = np.random.default_rng(int(policy))
    rid = 0
    for rnd in range(4):
        for _ in range(3 + 2 * rnd):
            pair.submit(rid, rng.integers(0, 64, int(rng.integers(3, 13))),
                        int(rng.integers(1, 6)))
            rid += 1
        rec = pair.tick()
        assert rec["steps"] == 0 and rec["inflight"] == 0
    pair.drain()
    pair.check()
    assert sum(r["rejected"] for r in pair.port.log) > 0


def test_wave_scheduler_resolves_hedges_by_latency(deterministic_clock):
    """Both arms of a wave-mode hedge run to completion; the faster one
    wins and only its latency is recorded."""
    pair = Pair(lambda m: two_tier(m, edge=1, cloud=4, rtt=0.01),
                lambda m: always_hedge(m), scheduler="wave",
                max_waves_per_tick=2)
    for i in range(4):
        pair.submit(i, PROMPT + i, 2 + i)
    pair.tick()
    pair.tick()
    pair.drain()
    pair.check()
    c = pair.port.metrics.counter
    assert c("hedges_fired") == 4
    assert c("hedges_won") + c("hedges_cancelled") == 4
    assert pair.port.hedges_open == 0
    assert sum(len(t.metrics.latency_values("fn"))
               for t in pair.port.tiers) == 4


def test_scheduler_argument_checked_like_reference():
    for k, m in enumerate(PACKAGES):
        extra = {} if k == 0 else {"device": "cpu"}
        with pytest.raises(ValueError, match="scheduler"):
            m["platform"].Continuum.from_topology(two_tier(m),
                                                  scheduler="batch", **extra)
        with pytest.warns(UserWarning, match="continuous scheduler"):
            cc = m["platform"].Continuum.from_topology(
                two_tier(m), policy="auto+migrate", scheduler="wave",
                **extra)
        assert cc.scheduler == "wave"


@pytest.mark.parametrize("scheduler", ["continuous", "wave"])
def test_chain_trace_with_caps_matches_reference(deterministic_clock,
                                                 scheduler):
    caps = (dict(max_steps_per_tick=3, max_waves_per_tick=2)
            if scheduler == "continuous" else dict(max_waves_per_tick=2))
    pair = Pair(lambda m: _chain(m["topo"], m["asc"], True),
                lambda m: "auto", trace_vocab=64, scheduler=scheduler,
                **caps)
    for k, cc in enumerate(pair.ccs):
        cc.trace = _bursty(PACKAGES[k]["platform"], 4)
    for _ in range(10):
        pair.tick()
    pair.drain()
    for k in range(2):
        pair.reqs[k].update({r.rid: r for r in pair.ccs[k].trace_requests})
    pair.check()
    reqs = pair.port.trace_requests
    assert sum(pair.served().values()) + sum(r.failed for r in reqs) == len(
        reqs)
    assert max(rec["R"] for rec in pair.port.log) > 0
