"""The port's paged KV path against the JAX reference, on the CPU.

Held against the reference (``repro.cache``, the paged ``Endpoint``, the
paged ``Continuum``) on the same numpy inputs and parameters:

* the port's copies of the page formulas, the page pool and the prefix
  registry (free lists, refcounts, LRU order);
* the paged endpoint under a random admit / decode / retire schedule
  with prompt reuse (token ids at every step, page tables, free pages,
  prefill hit rate), and inside the port paged == dense;
* copy-on-write forks, page-granular migration, admission in pages and
  registry back-pressure, ``TierSpec`` page validation;
* the continuum over paged tiers (static splits: per-tier counts and
  outputs; ``"auto"``: outputs and conservation).

The smoke model is float32, so greedy ids agree exactly, prefix hits
included.
"""

import dataclasses
import functools

import hypothesis
import hypothesis.strategies as st
import jax
import numpy as np
import pytest
import torch

from repro import cache as j_cache
from repro import configs as j_configs
from repro import platform as j_platform
from repro.core import topology as j_topo
from repro.core.replication import FunctionSpec as JFunctionSpec
from repro.models import model_zoo as j_zoo
from repro.serving.engine import Endpoint as JEndpoint
from repro_torch import bridge
from repro_torch import cache as t_cache
from repro_torch import configs as t_configs
from repro_torch import platform as t_platform
from repro_torch.core import topology as t_topo
from repro_torch.kernels import ops as t_ops
from repro_torch.models import model_zoo as t_zoo
from repro_torch.serving.engine import Endpoint as TEndpoint

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ARCH = "stablelm-1.6b"


@functools.lru_cache(maxsize=1)
def _models():
    cfg_j = j_configs.get_smoke_config(ARCH)
    cfg_t = t_configs.get_smoke_config(ARCH)
    pj = j_zoo.init(jax.random.PRNGKey(0), cfg_j)
    pt = bridge.params_from_numpy({k: np.asarray(v) for k, v in pj.items()},
                                  cfg_t, "cpu")
    return cfg_j, pj, cfg_t, pt


def _blocking(fn):
    return lambda *a, **kw: jax.block_until_ready(fn(*a, **kw))


@pytest.fixture(autouse=True, scope="module")
def _sequential_reference():
    """Make every jitted program of a reference endpoint finish before it
    returns.  The reference's paged ``decode_all`` dispatches its page
    write-back asynchronously over ``jnp.asarray`` views of ``slot_pos``
    and the page table, which the CPU backend may share with the numpy
    arrays, then bumps ``slot_pos`` on the host while the write-back may
    still be reading it (``repro/serving/engine.py:1106-1133``).  Its
    token stream then depends on thread timing.  Blocking gives the
    reference the sequential semantics the port is held to; the
    reference's code is unchanged."""
    init = JEndpoint.__init__

    def __init__(self, *args, **kwargs):
        init(self, *args, **kwargs)
        for name, fn in list(vars(self).items()):
            if callable(fn) and hasattr(fn, "lower"):
                setattr(self, name, _blocking(fn))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JEndpoint, "__init__", __init__)
        yield


def _pair(**kw):
    """A reference and a port endpoint over the same weights."""
    cfg_j, pj, cfg_t, pt = _models()
    return JEndpoint(cfg_j, pj, **kw), TEndpoint(cfg_t, pt, device="cpu",
                                                 **kw)


def _same_state(ref, port):
    assert port._tables == ref._tables
    np.testing.assert_array_equal(port._table_np, ref._table_np)
    assert port.free_pages == ref.free_pages
    assert port.prefill_hit_rate == ref.prefill_hit_rate
    assert port.admissible_pages == ref.admissible_pages
    assert port.resident_page_demand() == ref.resident_page_demand()
    np.testing.assert_array_equal(port.slot_pos, ref.slot_pos)


def _null_page_intact(ep):
    """Every table id lies in [0, P] (the kernel does not check it on the
    device) and the null page P is still all pos -1."""
    assert ep._table_np.min() >= 0
    assert ep._table_np.max() <= ep._null_page
    assert bool((ep.cache["pos"][:, ep._null_page] == -1).all())


# --------------------------------------------------------------------------
# the cache copies
# --------------------------------------------------------------------------


def test_page_formulas_match_reference():
    for page in (1, 4, 8, 16):
        for max_len in (16, 32, 64):
            if max_len % page:
                continue
            for L in range(0, 70):
                for mn in (-1, 0, 1, 2, 7, 33):
                    assert (t_cache.pages_needed(L, mn, page, max_len)
                            == j_cache.pages_needed(L, mn, page, max_len))
                    assert (t_cache.token_extent(L, mn)
                            == j_cache.token_extent(L, mn))
        for n in range(-3, 70):
            assert (t_cache.pages_for_tokens(n, page)
                    == j_cache.pages_for_tokens(n, page))
    for mod in (t_cache, j_cache):
        with pytest.raises(ValueError):
            mod.pages_needed(5, 1, 0, 64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_and_registry_match_reference(seed):
    """One random alloc / retain / release / register / lookup / evict
    sequence through both packages: equal results, free lists, refcounts
    and LRU order after every operation."""
    rng = np.random.default_rng(seed)
    pools = (t_cache.PagePool(12, 8), j_cache.PagePool(12, 8))
    regs = (t_cache.PrefixRegistry(pools[0], capacity=3),
            j_cache.PrefixRegistry(pools[1], capacity=3))
    prompts = [rng.integers(0, 50, int(n)).astype(np.int32)
               for n in rng.integers(1, 20, 6)]
    held = []                                  # page lists we hold refs on
    for _ in range(300):
        op = rng.integers(0, 6)
        if op == 0:
            n = int(rng.integers(0, 5))
            got = [p.alloc(n) for p in pools]
            assert got[0] == got[1]
            if got[0] is not None:
                held.append(got[0])
        elif op == 1 and held:
            ids = held[int(rng.integers(0, len(held)))]
            for p in pools:
                p.retain(ids)
            held.append(list(ids))
        elif op == 2 and held:
            ids = held.pop(int(rng.integers(0, len(held))))
            for p in pools:
                p.release(ids)
        elif op == 3 and held:
            toks = prompts[int(rng.integers(0, len(prompts)))]
            ids = held[int(rng.integers(0, len(held)))]
            first = int(rng.integers(0, 50))
            got = [r.register(toks, ids, first) for r in regs]
            assert (got[0] is None) == (got[1] is None)
            if got[0] is not None:
                assert (got[0].page_ids, got[0].length, got[0].first_token) \
                    == (got[1].page_ids, got[1].length, got[1].first_token)
        elif op == 4:
            toks = prompts[int(rng.integers(0, len(prompts)))]
            got = [r.lookup(toks) for r in regs]
            assert (got[0] is None) == (got[1] is None)
            if got[0] is not None:
                assert got[0].page_ids == got[1].page_ids
        elif op == 5:
            assert regs[0].evict_lru() == regs[1].evict_lru()
        assert pools[0]._free == pools[1]._free
        assert pools[0]._ref == pools[1]._ref
        assert list(regs[0]._entries) == list(regs[1]._entries)
        assert (regs[0].hits, regs[0].misses) == (regs[1].hits,
                                                  regs[1].misses)
        assert pools[0].check_balanced()
    regs[0].flush()
    regs[1].flush()
    assert pools[0]._free == pools[1]._free


# --------------------------------------------------------------------------
# the paged endpoint
# --------------------------------------------------------------------------


def _prompt_pool(rng, n=3):
    """A few fixed prompts reused across requests (drives prefix hits)."""
    return [rng.integers(0, 64, int(L)).astype(np.int32)
            for L in rng.integers(3, 14, n)]


@hypothesis.settings(max_examples=3, deadline=None, database=None)
@hypothesis.given(seed=st.integers(0, 10_000))
def test_paged_endpoint_stream_matches_reference(seed):
    """The random admit / decode / retire schedule of
    test_parity_fuzz.py::test_paged_vs_dense_engine_stream_fuzz, with
    prompt reuse, through the reference's paged endpoint, the port's
    paged endpoint and the port's dense endpoint: equal token ids at every
    step, equal page tables, free pages and prefill hit rate."""
    cfg_t, pt = _models()[2:]
    rng = np.random.default_rng(seed)
    slots, max_len, page = 3, 32, 8
    ref, port = _pair(slots=slots, max_len=max_len, paged=True,
                      page_size=page)
    dense = TEndpoint(cfg_t, pt, slots=slots, max_len=max_len, device="cpu")
    pool = _prompt_pool(rng)
    active = {}                       # slot -> [remaining, last_token]
    t_ops.reset_launches()
    for _ in range(24):
        if len(active) < slots and rng.uniform() < 0.5:
            toks = (pool[int(rng.integers(0, len(pool)))]
                    if rng.uniform() < 0.5 else
                    rng.integers(0, 64,
                                 int(rng.integers(1, 16))).astype(np.int32))
            need = int(rng.integers(1, 7))
            sr = ref.try_claim(tokens=toks, max_new=need)
            sp = port.try_claim(tokens=toks, max_new=need)
            sd = dense.try_claim(tokens=toks, max_new=need)
            assert sr == sp == sd and sr is not None
            fr = ref.prefill_batch({sr: toks})[sr]
            assert port.prefill_batch({sp: toks})[sp] == fr
            assert dense.prefill_batch({sd: toks})[sd] == fr
            active[sr] = [need - 1, fr]
        retire = [s for s, (rem, _) in active.items() if rem <= 0]
        for s in retire:
            for ep in (ref, port, dense):
                ep.release(s)
            del active[s]
        if active and rng.uniform() < 0.9:
            cur = {s: tok for s, (_, tok) in active.items()}
            nr = ref.decode_all(dict(cur))
            assert port.decode_all(dict(cur)) == nr
            assert dense.decode_all(dict(cur)) == nr
            for s in active:
                active[s] = [active[s][0] - 1, nr[s]]
        _same_state(ref, port)
        _null_page_intact(port)
    for s in active:
        ref.release(s)
        port.release(s)
    assert port.pool.check_balanced()
    assert port.pool._free == ref.pool._free
    assert list(port.prefix._entries) == list(ref.prefix._entries)
    assert t_ops.launches["paged_decode_attention"] == 0     # on the CPU
    assert t_ops.launches["paged_decode_attention_plain"] > 0


def test_paged_equals_dense_with_wrap_and_tight_pool():
    """Inside the port, no prefix cache: a paged endpoint with a pool of
    two full rows emits the dense endpoint's tokens while rows decode past
    max_len (the rolling wrap touches every page) and short rows pack
    where a dense row would not fit."""
    cfg_t, pt = _models()[2:]
    rng = np.random.default_rng(3)
    max_len, page = 32, 8
    dense = TEndpoint(cfg_t, pt, slots=4, max_len=max_len, device="cpu")
    paged = TEndpoint(cfg_t, pt, slots=4, max_len=max_len, device="cpu",
                      paged=True, page_size=page, total_pages=8,
                      prefix_cache=False)
    reqs = [(rng.integers(0, 64, L).astype(np.int32), mn)
            for L, mn in ((20, 30), (5, 4), (3, 3), (9, 6))]
    cur, left = {}, {}
    for toks, mn in reqs:
        sp = paged.try_claim(tokens=toks, max_new=mn)
        sd = dense.try_claim(tokens=toks, max_new=mn)
        assert sp == sd
        f = paged.prefill_batch({sp: toks})[sp]
        assert dense.prefill_batch({sd: toks})[sd] == f
        cur[sp], left[sp] = f, mn - 1
    assert paged.free_pages == 8 - 4 - 1 - 1 - 2
    while cur:
        nd = dense.decode_all(dict(cur))
        assert paged.decode_all(dict(cur)) == nd
        _null_page_intact(paged)
        for s in list(cur):
            left[s] -= 1
            cur[s] = nd[s]
            if left[s] <= 0:
                paged.release(s)
                dense.release(s)
                del cur[s], left[s]
    assert paged.pool.check_balanced() and paged.free_pages == 8


def test_cow_keeps_shared_prefix_frozen():
    """Two requests share a prompt's pages; one decodes past the fork
    point.  The other's pages stay bit-frozen (the write landed in a
    copy-on-write fork), and both streams match the reference's."""
    ref, port = _pair(slots=2, max_len=32, paged=True, page_size=8)
    toks = np.random.default_rng(11).integers(0, 64, 12).astype(np.int32)
    firsts = []
    for ep in (ref, port):
        s0 = ep.try_claim(tokens=toks, max_new=10)
        firsts.append(ep.prefill_batch({s0: toks})[s0])
        s1 = ep.try_claim(tokens=toks, max_new=10)      # registry hit
        assert (s0, s1) == (0, 1)
        assert ep.prefill_batch({s1: toks})[s1] == firsts[-1]
    assert firsts[0] == firsts[1]
    f0 = firsts[0]
    _same_state(ref, port)
    t0, t1 = port._tables[0], port._tables[1]
    assert t0[0] == t1[0] and port.pool.is_shared(t0[0])
    assert t0[1] != t1[1]
    idx = torch.as_tensor(t1)
    snap = {k: v[:, idx].clone() for k, v in port.cache.items()}
    cur_r = cur_p = {0: f0}
    for _ in range(8):
        cur_r = ref.decode_all(cur_r)
        cur_p = port.decode_all(cur_p)
        assert cur_p == cur_r
    for k, v in port.cache.items():
        assert torch.equal(v[:, idx], snap[k])
    cur_r = cur_p = {1: f0}
    for _ in range(3):
        cur_r = ref.decode_all(cur_r)
        cur_p = port.decode_all(cur_p)
        assert cur_p == cur_r
    _same_state(ref, port)
    for ep in (ref, port):
        ep.release(0)
        ep.release(1)
    assert port.pool.check_balanced() and port.free_pages == ref.free_pages


def test_paged_row_migration_midstream():
    """A paged row extracted mid-stream and inserted into a peer paged
    endpoint resumes the dense stream, and ships fewer bytes than a dense
    row (the same byte count as the reference's payload)."""
    cfg_t, pt = _models()[2:]
    rng = np.random.default_rng(23)
    toks = rng.integers(0, 64, 9).astype(np.int32)
    total_new = 9
    dense = TEndpoint(cfg_t, pt, slots=2, max_len=32, device="cpu")
    sd = dense.try_claim(tokens=toks, max_new=total_new)
    want = [dense.prefill_batch({sd: toks})[sd]]
    for _ in range(total_new - 1):
        want.append(dense.decode_all({sd: want[-1]})[sd])

    ref_src, src = _pair(slots=2, max_len=32, paged=True, page_size=8)
    dst = TEndpoint(cfg_t, pt, slots=2, max_len=32, device="cpu",
                    paged=True, page_size=8)
    ss = src.try_claim(tokens=toks, max_new=total_new)
    got = [src.prefill_batch({ss: toks})[ss]]
    sr = ref_src.try_claim(tokens=toks, max_new=total_new)
    ref_src.prefill_batch({sr: toks})
    for _ in range(3):
        got.append(src.decode_all({ss: got[-1]})[ss])
        ref_src.decode_all({sr: got[-2]})
    state, = src.extract_rows([ss])
    ref_state, = ref_src.extract_rows([sr])
    assert state.nbytes == ref_state.nbytes
    d_state, = dense.extract_rows([sd])
    assert state.nbytes < sum(l.numel() * l.element_size()
                              for l in d_state.values())
    pos = int(src.slot_pos[ss])
    remaining = total_new - len(got)
    sdst = dst.try_claim(reserve_tokens=pos + remaining)
    assert sdst is not None
    dst.insert_rows([state], [sdst], [pos])
    src.release(ss)
    for _ in range(remaining):
        got.append(dst.decode_all({sdst: got[-1]})[sdst])
    assert got == want
    dst.release(sdst)
    assert src.pool.check_balanced() and dst.pool.check_balanced()
    for length in (1, 7, 8, 9, 32, 40):
        assert (src.cache_nbytes_per_row(length)
                == ref_src.cache_nbytes_per_row(length))
    assert src.pool_nbytes == ref_src.pool_nbytes


def test_admission_in_pages():
    """(tests/test_paged_cache.py:205) A pool of exactly one row: claims
    are refused for pages, not slots, and short requests pack two where a
    dense pool holds one."""
    ref, port = _pair(slots=4, max_len=32, paged=True, page_size=8,
                      total_pages=4, prefix_cache=False)
    toks = np.random.default_rng(0).integers(0, 64, 20).astype(np.int32)
    for ep in (ref, port):
        assert ep.page_need(20, 8) == 4
        s0 = ep.try_claim(tokens=toks, max_new=8)
        assert s0 is not None and ep.free_pages == 0
        assert ep.try_claim(tokens=toks, max_new=8) is None
        assert ep.try_claim(tokens=toks[:4], max_new=1) is None
        ep.release(s0)
        assert ep.free_pages == 4 and ep.admissible_pages == 4
        s1 = ep.try_claim(tokens=toks[:4], max_new=1)
        s2 = ep.try_claim(tokens=toks[:4], max_new=1)
        assert s1 is not None and s2 is not None and ep.free_pages == 2
    _same_state(ref, port)
    for ep in (ref, port):
        ep.release(1)
        ep.release(0)
    _same_state(ref, port)
    assert port.pool.check_balanced() and port.free_pages == 4


def test_registry_backpressure():
    """(tests/test_paged_cache.py:231) Pages pinned only by the prefix
    registry are reclaimable: a claim that needs them evicts LRU entries
    instead of failing."""
    ref, port = _pair(slots=2, max_len=32, paged=True, page_size=8,
                      total_pages=4)
    rng = np.random.default_rng(1)
    a = rng.integers(0, 64, 10).astype(np.int32)
    b = rng.integers(64, 128, 20).astype(np.int32)
    for ep in (ref, port):
        s = ep.try_claim(tokens=a, max_new=2)
        ep.prefill_batch({s: a})
        ep.release(s)
        assert len(ep.prefix) == 1
        assert ep.used_pages > 0 and ep.admissible_pages == ep.total_pages
    _same_state(ref, port)
    for ep in (ref, port):
        s2 = ep.try_claim(tokens=b, max_new=8)           # all 4 pages
        assert s2 is not None and len(ep.prefix) == 0
    _same_state(ref, port)
    _null_page_intact(port)
    for ep in (ref, port):
        ep.release(0)
    assert port.pool.check_balanced() and port.pool._free == ref.pool._free


def test_tierspec_page_validation():
    for mod in (t_topo, j_topo):
        with pytest.raises(ValueError):
            mod.TierSpec("t", max_len=32, page_size=5)          # must divide
        with pytest.raises(ValueError):
            mod.TierSpec("t", max_len=32, page_size=8, pool_pages=3)
        with pytest.raises(ValueError):
            mod.TierSpec("t", max_len=32, pool_pages=8)  # needs page_size
        spec = mod.TierSpec("t", slots=4, max_len=32, page_size=8)
        assert spec.pages_per_row == 4 and spec.total_pages == 16
        assert mod.TierSpec("t", max_len=32, page_size=8,
                            pool_pages=6).total_pages == 6
        assert mod.TierSpec("t", max_len=32).total_pages == 0
        # a cost-modeled spec is built unresolved, and pages alike
        spec = mod.TierSpec("t", slots=4, max_len=32, page_size=8,
                            model="stablelm-1.6b")
        assert spec.cost_modeled and not spec.resolved
        assert spec.total_pages == 16 and spec.devices == 1


def test_paged_endpoint_refuses_what_is_not_ported():
    cfg_t, pt = _models()[2:]
    with pytest.raises(ValueError):
        TEndpoint(cfg_t, pt, max_len=32, device="cpu", paged=True,
                  page_size=5)
    with pytest.raises(ValueError):
        TEndpoint(cfg_t, pt, max_len=32, device="cpu", paged=True,
                  page_size=8, total_pages=3)
    # a rolling window narrower than max_len leaves no full-context leaf
    # to page: both packages refuse the endpoint when it is built
    cfg_j, pj = _models()[:2]
    msg = "model family 'dense' has no pageable cache leaves"
    with pytest.raises(ValueError, match=msg):
        JEndpoint(dataclasses.replace(cfg_j, sliding_window=16), pj,
                  slots=1, max_len=32, paged=True, page_size=8)
    windowed = dataclasses.replace(cfg_t, sliding_window=16)
    with pytest.raises(ValueError, match=msg):
        TEndpoint(windowed, pt, slots=1, max_len=32, device="cpu",
                  paged=True, page_size=8)
    with pytest.raises(ValueError, match=msg):
        t_zoo.init_paged_pool(windowed, 1, 32, 4, 8,
                              t_zoo.init_cache(windowed, 1, 32, "cpu"))
    # a window wider than max_len pages like the dense family: both
    # packages decode the same ids from it
    wide = dataclasses.replace(cfg_t, sliding_window=48)
    assert t_zoo.paged_leaves(wide, 32) == ("k", "v", "pos")
    eps = (JEndpoint(dataclasses.replace(cfg_j, sliding_window=48), pj,
                     slots=1, max_len=32, paged=True, page_size=8),
           TEndpoint(wide, pt, slots=1, max_len=32, device="cpu",
                     paged=True, page_size=8))
    toks = np.arange(5, 17, dtype=np.int32)
    streams = []
    for ep in eps:
        s = ep.try_claim(tokens=toks, max_new=24)
        out = [ep.prefill_batch({s: toks})[s]]
        for _ in range(23):                 # past max_len: the rows wrap
            out.append(ep.decode_all({s: out[-1]})[s])
        streams.append(out)
    assert streams[0] == streams[1]


# --------------------------------------------------------------------------
# the continuum over paged tiers
# --------------------------------------------------------------------------


def _paged_topology(mod):
    return mod.Topology(
        (mod.TierSpec("edge", slots=2, max_len=32, page_size=8,
                      pool_pages=5),
         mod.TierSpec("cloud", slots=4, max_len=32, page_size=8,
                      extra_latency_s=0.02, queue_depth_per_slot=None)),
        (mod.LinkSpec(rtt_s=0.0),), waterfall=False)


def _drive(cc, model, vocab, seed, rounds, spec_cls, req_cls):
    """Submit a seeded ramped stream (half of it drawn from 3 reused
    prompts, so prefixes hit), tick per round, drain.  Returns requests
    by rid and the per-tick served counts."""
    rng = np.random.default_rng(seed)
    cc.deploy(spec_cls(name="fn", arch=ARCH), *model)
    prompts = _prompt_pool(rng)
    reqs = {}
    for rnd in range(rounds):
        for _ in range(2 + 2 * rnd):
            toks = (prompts[int(rng.integers(0, 3))].copy()
                    if rng.uniform() < 0.5 else
                    rng.integers(0, vocab, int(rng.integers(3, 13))
                                 ).astype(np.int32))
            r = req_cls(rid=len(reqs), tokens=toks,
                        max_new=int(rng.integers(1, 6)))
            reqs[r.rid] = r
            cc.submit("fn", r)
        cc.tick()
    cc.drain()
    return reqs, [rec["tiers"] for rec in cc.log]


def _continuum_pair(policy, seed=0, rounds=4):
    cfg_j, pj, cfg_t, pt = _models()
    ref = j_platform.Continuum(topology=_paged_topology(j_topo),
                               policy=policy, seed=seed)
    port = t_platform.Continuum(topology=_paged_topology(t_topo),
                                policy=policy, seed=seed, device="cpu")
    rj, tj = _drive(ref, (cfg_j, pj), cfg_t.vocab_size, seed, rounds,
                    JFunctionSpec, j_platform.Request)
    rt, tt = _drive(port, (cfg_t, pt), cfg_t.vocab_size, seed, rounds,
                    t_platform.FunctionSpec, t_platform.Request)
    return ref, port, rj, rt, tj, tt


def _same_outputs(rj, rt):
    assert sorted(rj) == sorted(rt)
    for rid in rj:
        assert rj[rid].failed == rt[rid].failed, rid
        if rj[rid].output is None:
            assert rt[rid].output is None, rid
        else:
            np.testing.assert_array_equal(rt[rid].output, rj[rid].output,
                                          err_msg=f"request {rid}")


def _drained_balanced(port):
    assert port.queued == 0 and port.in_flight == 0
    for tier in port.tiers:
        ep = tier.endpoints["fn"]
        assert ep.paged and ep.active == 0 and ep.pool.check_balanced()
        # after the drain only the registry holds pages
        assert ep.used_pages == len(ep.prefix.pinned_pages())


@pytest.mark.parametrize("policy", ["0", "100"])
def test_paged_continuum_static_split_matches_reference(policy):
    ref, port, rj, rt, tj, tt = _continuum_pair(policy)
    _same_outputs(rj, rt)
    assert tt == tj                       # per-tick, per-tier served counts
    served = sum(sum(t.values()) for t in tt)
    assert served + sum(r.failed for r in rt.values()) == len(rt)
    busy = 0 if policy == "0" else 1
    assert sum(t[port.tiers[busy].name] for t in tt) == served > 0
    ep_t = port.tiers[busy].endpoints["fn"]
    ep_j = ref.tiers[busy].endpoints["fn"]
    assert ep_t.prefill_hit_rate == ep_j.prefill_hit_rate > 0
    assert ep_t.peak_active == ep_j.peak_active
    assert ep_t.pool._free == ep_j.pool._free
    _drained_balanced(port)


def test_paged_continuum_auto_matches_reference_outputs():
    ref, port, rj, rt, tj, tt = _continuum_pair("auto", rounds=5)
    _same_outputs(rj, rt)
    served = sum(sum(t.values()) for t in tt)
    assert served + sum(r.failed for r in rt.values()) == len(rt)
    assert all(r.output is not None for r in rt.values() if not r.failed)
    _drained_balanced(port)
    assert (port.edge.endpoints["fn"].params
            is port.cloud.endpoints["fn"].params)


def test_paged_kernel_launcher_refuses_cpu_tensors():
    from repro_torch.kernels import decode_attention
    q = torch.zeros(1, 2, 16)
    pool = torch.zeros(2, 4, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention.paged_decode_attention(
            q, pool, pool, torch.zeros((1, 1), dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32),
            torch.full((2, 4), -1, dtype=torch.int32))
