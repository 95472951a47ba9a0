"""Live mid-stream migration in the port, against the reference, on the
CPU at smoke width.

A policy with a ``migrate_threshold`` makes a tier cancel slot-resident
rows, ship their cache state over the link (live cache bytes + token
tail on the request's clock) and resume them at the next tier with no
re-prefill.  Held here:

* inside the port, migrated == unmigrated token ids, bitwise, for a
  stablelm dense row, a stablelm paged row, a hymba row (window KV,
  global KV and SSM state) and an rwkv6 row (WKV state alone), each
  also equal to the reference's unmigrated stream;
* the port's row bytes (``cache_nbytes_per_row``) and its compatibility
  gate against the reference's;
* the continuum cases of ``tests/test_migration.py`` run through both
  packages (``tests/torch_live.py``): every output, failure, latency,
  per-tick record, counter and link byte equal, for a dense, a paged
  and a hymba migration, the link's cost on the request's clock, an
  abort on a full destination, a landing that crosses a tick, and a
  hedged primary that migrates.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.serving.engine import Endpoint as JEndpoint
from repro_torch.serving.engine import Endpoint as TEndpoint
from test_torch_chain import (_sequential_reference,  # noqa: F401
                              deterministic_clock)  # noqa: F401
from torch_live import Pair, always_hedge, migrate_split, models, two_tier

PROMPT = np.arange(6, dtype=np.int32)


def _solo_stream(ep, prompt, steps, prefill):
    s = ep.try_claim()
    tok = prefill(ep, s, prompt)
    out = [tok]
    for _ in range(steps):
        tok = ep.decode_all({s: tok})[s]
        out.append(tok)
    return out


def _port_prefill(ep, s, prompt):
    return ep.prefill_batch({s: prompt})[s]


@pytest.mark.parametrize("arch,paged", [("stablelm-1.6b", False),
                                        ("stablelm-1.6b", True),
                                        ("hymba-1.5b", False),
                                        ("rwkv6-7b", False)])
def test_migrated_row_stream_equals_unmigrated(arch, paged):
    """Decode 4 steps on one endpoint, move the row into a different pool
    (with a busy neighbour), decode on: the ids equal an unmigrated solo
    run bitwise, and that run equals the reference's."""
    cfg_j, pj, cfg_t, pt = models(arch)
    kw = dict(paged=True, page_size=8) if paged else {}
    solo = _solo_stream(TEndpoint(cfg_t, pt, slots=2, max_len=64,
                                  device="cpu", **kw), PROMPT, 9,
                        _port_prefill)
    want = _solo_stream(JEndpoint(cfg_j, pj, slots=2, max_len=64, **kw),
                        PROMPT, 9, lambda ep, s, p: ep.prefill_one(s, p))
    assert solo == want

    src = TEndpoint(cfg_t, pt, slots=2, max_len=64, device="cpu", **kw)
    dst = TEndpoint(cfg_t, pt, slots=4, max_len=64, device="cpu", **kw)
    assert src.compatible_with(dst)
    s = src.try_claim(tokens=PROMPT, max_new=10)
    tok = src.prefill_batch({s: PROMPT})[s]
    got = [tok]
    for _ in range(4):
        tok = src.decode_all({s: tok})[s]
        got.append(tok)
    [state] = src.extract_rows([s])
    pos = int(src.slot_pos[s])
    src.release(s)
    other_toks = np.arange(3, dtype=np.int32) + 7
    other = dst.try_claim(tokens=other_toks, max_new=4)
    dst.prefill_batch({other: other_toks})
    d = dst.try_claim(reserve_tokens=pos + 5 if paged else None)
    dst.insert_rows([state], [d], [pos])
    for _ in range(5):
        tok = dst.decode_all({d: tok})[d]
        got.append(tok)
    assert got == solo
    if paged:
        # only the filled pages travel
        assert state.n_pages == -(-pos // 8)
        assert state.nbytes == dst.cache_nbytes_per_row(pos)


@pytest.mark.parametrize("arch,paged", [("stablelm-1.6b", False),
                                        ("stablelm-1.6b", True),
                                        ("hymba-1.5b", False),
                                        ("rwkv6-7b", False)])
def test_row_bytes_and_compatibility_match_reference(arch, paged):
    cfg_j, pj, cfg_t, pt = models(arch)
    kw = dict(paged=True, page_size=8) if paged else {}
    ej = [JEndpoint(cfg_j, pj, slots=2, max_len=64, **kw),
          JEndpoint(cfg_j, pj, slots=8, max_len=64, **kw),
          JEndpoint(cfg_j, pj, slots=2, max_len=128, **kw)]
    et = [TEndpoint(cfg_t, pt, slots=2, max_len=64, device="cpu", **kw),
          TEndpoint(cfg_t, pt, slots=8, max_len=64, device="cpu", **kw),
          TEndpoint(cfg_t, pt, slots=2, max_len=128, device="cpu", **kw)]
    for L in (0, 1, 7, 8, 30, 64, 100):
        assert et[0].cache_nbytes_per_row(L) == ej[0].cache_nbytes_per_row(L)
    for a in range(3):
        for b in range(3):
            assert (et[a].compatible_with(et[b])
                    == ej[a].compatible_with(ej[b])), (a, b)
    assert et[0].compatible_with(et[1]) and not et[0].compatible_with(et[2])
    # another config object, and another device, are refused too
    other = TEndpoint(dataclasses.replace(cfg_t), pt, slots=2, max_len=64,
                      device="cpu", **kw)
    assert not et[0].compatible_with(other)
    elsewhere = TEndpoint(cfg_t, pt, slots=2, max_len=64, device="cpu", **kw)
    elsewhere.device = torch.device("cuda", 0)
    assert not et[0].compatible_with(elsewhere)


def test_stablelm_paged_pool_refuses_a_dense_row():
    cfg_j, pj, cfg_t, pt = models()
    dense = TEndpoint(cfg_t, pt, slots=2, max_len=64, device="cpu")
    paged = TEndpoint(cfg_t, pt, slots=2, max_len=64, device="cpu",
                      paged=True, page_size=8)
    paged16 = TEndpoint(cfg_t, pt, slots=2, max_len=64, device="cpu",
                        paged=True, page_size=16)
    assert not dense.compatible_with(paged)
    assert not paged.compatible_with(paged16)


def _solo(max_new, arch="stablelm-1.6b", tokens=PROMPT):
    """The unmigrated stream: the port's endpoint serving the request
    alone."""
    cfg_j, pj, cfg_t, pt = models(arch)
    ep = TEndpoint(cfg_t, pt, slots=2, max_len=64, device="cpu")
    return _solo_stream(ep, tokens, max_new - 1, _port_prefill)


def test_migration_mid_decode_matches_reference(deterministic_clock):
    """Resident 3 steps at the edge, then R_t crosses the threshold: the
    row moves to the cloud and finishes there, with the ids of the
    unmigrated run."""
    pair = Pair(lambda m: two_tier(m),
                lambda m: migrate_split(m, 100.0, thr=None),
                max_steps_per_tick=3)
    pair.resident(0, PROMPT, 12)
    rec = pair.tick()
    assert rec["inflight"] == 1 and pair.reqs[1][0].output is None
    for cc in pair.ccs:
        cc.policy.migrate_threshold = 50.0
    rec = pair.tick()
    assert rec["migrations_fired"] == 1
    pair.drain()
    pair.check()
    c = pair.port.metrics.counter
    assert c("migrations_completed") == 1 and c("migrations_aborted") == 0
    assert pair.served() == {"edge": 0, "cloud": 1}
    ep = pair.port.tiers[0].endpoints["fn"]
    assert pair.port.link_bytes[0] == ep.cache_nbytes_per_row(9) + 4.0 * (
        6 + 4)
    assert list(pair.reqs[1][0].output) == _solo(12)


def test_migration_latency_includes_link_cost(deterministic_clock):
    pair = Pair(lambda m: two_tier(m, rtt=0.4),
                lambda m: migrate_split(m, 100.0))
    pair.resident(0, PROMPT, 6)
    t0 = deterministic_clock["port"].now
    pair.tick()
    pair.drain()
    pair.check()
    req = pair.reqs[1][0]
    assert req.t_done - t0 >= 0.4
    assert pair.port.metrics.counter("migrations_completed") == 1
    assert list(req.output) == _solo(6)


def test_migration_aborted_on_full_destination(deterministic_clock):
    """The cloud's only slot is busy at landing: the migration aborts, the
    row resumes at the edge and finishes there, unchanged."""
    pair = Pair(lambda m: two_tier(m, cloud=1),
                lambda m: migrate_split(m, 100.0), max_steps_per_tick=4)
    pair.resident(9, PROMPT, 40, tier=1)
    pair.resident(0, PROMPT, 10)
    rec = pair.tick()
    assert rec["migrations_fired"] == 1
    pair.drain()
    pair.check()
    c = pair.port.metrics.counter
    assert c("migrations_aborted") >= 1 and c("migrations_completed") == 0
    assert list(pair.reqs[1][0].output) == _solo(10)
    assert sum(r["tiers"]["edge"] for r in pair.port.log) == 1


def test_cross_tick_landing_over_slow_link(deterministic_clock):
    pair = Pair(lambda m: two_tier(m, rtt=0.6),
                lambda m: migrate_split(m, 100.0), max_steps_per_tick=1)
    pair.resident(0, PROMPT, 8)
    pair.resident(1, PROMPT, 2)          # too near done to migrate
    rec = pair.tick()
    assert rec["migrations_fired"] == 1
    assert pair.port.migrations_open == 1 and rec["inflight"] >= 1
    ticks = 1 + pair.drain()
    pair.check()
    assert ticks >= 2 and pair.port.migrations_open == 0
    assert pair.port.metrics.counter("migrations_completed") == 1
    assert list(pair.reqs[1][0].output) == _solo(8)


def test_paged_migration_matches_reference(deterministic_clock):
    """Paged edge -> paged cloud (page 8): the row ships only its filled
    pages, the bytes round up to whole pages, and the ids equal the
    unmigrated run's."""
    paged = dict(page_size=8, pool_pages=16)
    pair = Pair(lambda m: two_tier(m, edge_kw=paged, cloud_kw=paged,
                                   rtt=0.05),
                lambda m: migrate_split(m, 100.0, thr=None),
                max_steps_per_tick=3)
    toks = np.arange(11, dtype=np.int32) + 3
    pair.resident(0, toks, 12)
    pair.tick()
    for cc in pair.ccs:
        cc.policy.migrate_threshold = 50.0
    assert pair.tick()["migrations_fired"] == 1
    pair.drain()
    pair.check()
    assert pair.port.metrics.counter("migrations_completed") == 1
    ep = pair.port.tiers[0].endpoints["fn"]
    pos = 11 + 3                         # prompt + 3 decode steps
    assert pair.port.link_bytes[0] == ep.cache_nbytes_per_row(pos) + 4.0 * (
        11 + 4)
    assert ep.cache_nbytes_per_row(pos) == ep.cache_nbytes_per_row(16)
    assert list(pair.reqs[1][0].output) == _solo(12, tokens=toks)
    # both pools drain balanced: no page table holds a page any more
    assert all(ep.active == 0 and ep.admissible_pages == ep.total_pages
               for t in pair.port.tiers for ep in t.endpoints.values())


def test_hymba_migration_matches_reference(deterministic_clock):
    """A hymba row (window KV, global KV, SSM h and conv state) moves
    mid-decode and decodes on to the unmigrated ids."""
    pair = Pair(lambda m: two_tier(m, rtt=0.02),
                lambda m: migrate_split(m, 100.0, thr=None),
                arch="hymba-1.5b", max_steps_per_tick=3)
    pair.resident(0, PROMPT, 10)
    pair.tick()
    for cc in pair.ccs:
        cc.policy.migrate_threshold = 50.0
    assert pair.tick()["migrations_fired"] == 1
    pair.drain()
    pair.check()
    assert pair.port.metrics.counter("migrations_completed") == 1
    assert list(pair.reqs[1][0].output) == _solo(10, arch="hymba-1.5b")


def test_migrated_primary_keeps_hedge_pair(deterministic_clock):
    """Every request hedges, primaries stay at the edge, R_t = 60 drives
    migration: a migrated primary keeps its pair, the race resolves once,
    both accounting identities hold after every tick, one arm records."""
    pair = Pair(lambda m: two_tier(m),
                lambda m: always_hedge(m, 60.0, thr=50.0, stay=True),
                max_steps_per_tick=2)
    assert pair.submit(0, PROMPT, 10)
    for _ in range(12):
        pair.tick()
        if pair.port.queued == 0 and pair.port.in_flight == 0:
            break
    pair.check()
    c = pair.port.metrics.counter
    assert c("hedges_fired") == 1 and c("migrations_fired") >= 1
    assert pair.reqs[1][0].output.shape == (10,)
    assert sum(pair.served().values()) == 1
    assert sum(len(t.metrics.latency_values("fn"))
               for t in pair.port.tiers) == 1


def test_hedge_twins_never_migrate(deterministic_clock):
    pair = Pair(lambda m: two_tier(m),
                lambda m: always_hedge(m, 60.0, thr=50.0, stay=True),
                max_steps_per_tick=2)
    assert pair.submit(0, PROMPT, 10)
    pair.tick()
    pair.tick()
    assert pair.port.metrics.counter("migrations_fired") <= 1
    pair.drain()
    pair.check()
    assert pair.reqs[1][0].output is not None
