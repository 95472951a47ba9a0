"""The paged tier of the windowed families, in the port, against the
reference, on the CPU at smoke width.

A paged pool pages a cache leaf only when its length axis has extent
``max_len``.  hymba-1.5b's smoke config (3 layers, window 16, layer 1
global) at max_len 32 or 64 pages its global layer's KV and keeps its
two rolling-window stacks and every layer's SSM state per slot
("residual" leaves, carried by prefill and migration with the row).
Held against the reference's paged endpoint, through the blocking
fixture of ``tests/test_torch_chain.py``:

* token ids at every step of a random admit / decode / retire schedule
  with the window rows wrapping, and paged == dense inside the port,
  without a prefix registry;
* the reference's exact-prompt hit, which reuses the global layer's
  pages but leaves the slot's window rows and SSM state as they were:
  the port reproduces its diverged stream (ROADMAP §3, "Reference
  limitations kept for parity");
* ``PagedRow`` page and residual leaves and ``nbytes``, for a row that
  is partly filled and for one that wrapped; ``cache_nbytes_per_row``;
* a paged hymba row migrated mid-stream == unmigrated, in the
  reference and in the port, and through both live continua
  (``tests/torch_live.py``: outputs, latencies and link bytes equal);
* mixtral-8x7b pages like the dense family below its window and raises
  the reference's ``ValueError`` at and above it; rwkv6-7b raises it
  always.
"""

import hypothesis
import hypothesis.strategies as st
import numpy as np
import pytest

from repro.serving.engine import Endpoint as JEndpoint
from repro_torch.models import transformer as t_transformer
from repro_torch.serving.engine import Endpoint as TEndpoint
from test_torch_chain import (_sequential_reference,  # noqa: F401
                              deterministic_clock)  # noqa: F401
from test_torch_hymba import paged_layer_leaves
from torch_live import Pair, migrate_split, models, two_tier

ARCH = "hymba-1.5b"
PAGE = 8


def _endpoints(max_len, slots=3, arch=ARCH, **kw):
    """(reference paged, port paged, port dense) over the same weights."""
    cfg_j, pj, cfg_t, pt = models(arch)
    paged = dict(paged=True, page_size=PAGE, **kw)
    return (JEndpoint(cfg_j, pj, slots=slots, max_len=max_len, **paged),
            TEndpoint(cfg_t, pt, slots=slots, max_len=max_len, device="cpu",
                      **paged),
            TEndpoint(cfg_t, pt, slots=slots, max_len=max_len, device="cpu"))


def _serve(ep, toks, steps):
    s = ep.try_claim(tokens=toks, max_new=steps + 1)
    out = [ep.prefill_batch({s: toks})[s]]
    for _ in range(steps):
        out.append(ep.decode_all({s: out[-1]})[s])
    return s, out


def _layer_leaves(cfg_t, leaves):
    """The port's stacked leaves as {(layer, key): tensor as numpy}."""
    groups = t_transformer.cache_groups(cfg_t)
    out = {}
    for name, leaf in leaves.items():
        group, _, key = name.rpartition("/")
        layers = groups[group + "/"] if group else range(cfg_t.num_layers)
        for j, i in enumerate(layers):
            out[(i, key)] = leaf[j].numpy()
    return out


def _ref_leaves(ref, leaves, paged):
    """The reference's flat leaf list as {(layer, key): numpy}, for the
    paged or the residual leaves (its tree order: layers, keys sorted)."""
    keys = [(i, k) for i, layer in enumerate(ref.cache) for k in sorted(layer)]
    mine = [lk for lk, pg in zip(keys, ref._is_paged_leaf) if pg == paged]
    return {lk: np.asarray(l) for lk, l in zip(mine, leaves)}


# ---------------------------------------------------------------- streams


@hypothesis.settings(max_examples=3, deadline=None, database=None)
@hypothesis.given(seed=st.integers(0, 10_000))
def test_paged_hymba_stream_matches_reference(seed):
    """A random admit / decode / retire schedule, no prefix registry:
    prompts of 5 or 20 tokens and up to 40 positions a row at max_len 64,
    so the 16-wide window rows wrap and the global pages fill; the port's
    paged ids equal the reference's paged ids and the port's dense ids
    at every step, with equal page tables and free pages."""
    rng = np.random.default_rng(seed)
    ref, port, dense = _endpoints(64, prefix_cache=False)
    vocab = port.cfg.vocab_size
    active = {}
    for _ in range(30):
        if len(active) < 3 and rng.uniform() < 0.5:
            toks = rng.integers(0, vocab,
                                int(rng.choice([5, 20]))).astype(np.int32)
            need = int(rng.integers(1, 21))
            slots = {ep.try_claim(tokens=toks, max_new=need)
                     for ep in (ref, port, dense)}
            assert len(slots) == 1 and None not in slots
            s = slots.pop()
            first = {ep.prefill_batch({s: toks})[s]
                     for ep in (ref, port, dense)}
            assert len(first) == 1
            active[s] = [need - 1, first.pop()]
        for s in [s for s, (rem, _) in active.items() if rem <= 0]:
            for ep in (ref, port, dense):
                ep.release(s)
            del active[s]
        if active:
            cur = {s: tok for s, (_, tok) in active.items()}
            nr = ref.decode_all(dict(cur))
            assert port.decode_all(dict(cur)) == nr
            assert dense.decode_all(dict(cur)) == nr
            for s in active:
                active[s] = [active[s][0] - 1, nr[s]]
        assert port._tables == ref._tables
        assert port.free_pages == ref.free_pages
        np.testing.assert_array_equal(port.slot_pos, ref.slot_pos)
    for s in active:
        port.release(s)
    assert port.pool.check_balanced()


def test_paged_equals_dense_past_max_len():
    """One row decoding past max_len 32: the global pages wrap (every
    page of the table is rewritten) and so do the window rows."""
    ref, port, dense = _endpoints(32, slots=2, prefix_cache=False)
    toks = np.arange(3, 23, dtype=np.int32)
    streams = [_serve(ep, toks, 30)[1] for ep in (ref, port, dense)]
    assert streams[0] == streams[1] == streams[2]


def test_exact_hit_stream_equals_reference_divergence():
    """The same 20-token prompt served twice in one slot with the prefix
    registry on.  The second claim is an exact hit: the global layer's
    pages are reused and prefill is skipped, but the slot's window rows
    and SSM state keep the first request's final state.  The port's
    second stream equals the reference's, which is not the dense one."""
    ref, port, dense = _endpoints(64, slots=2)
    toks = np.random.default_rng(0).integers(0, 256, 20).astype(np.int32)
    runs = {}
    for name, ep in (("ref", ref), ("port", port), ("dense", dense)):
        runs[name] = []
        for _ in range(2):
            s, out = _serve(ep, toks, 6)
            assert s == 0
            ep.release(s)
            runs[name].append(out)
    assert runs["port"] == runs["ref"]
    assert runs["port"][0] == runs["dense"][0] == runs["dense"][1]
    assert runs["port"][1] != runs["dense"][1]
    assert port.prefill_hit_tokens == ref.prefill_hit_tokens == 20
    assert port.prefill_hit_rate == ref.prefill_hit_rate == 0.5


# ---------------------------------------------------------------- rows


@pytest.mark.parametrize("max_len,steps", [(64, 6), (32, 30)],
                         ids=["partial", "wrapped"])
def test_paged_row_leaves_and_bytes_match_reference(max_len, steps):
    """``extract_rows`` of a row 26 positions in at max_len 64 (4 of 8
    pages, the last one partly filled; window rows wrapped) and of one 50
    positions in at max_len 32 (the global pages wrapped too): each page
    leaf and residual leaf equal to the reference's, layer by layer, and
    ``nbytes`` equal."""
    ref, port, _ = _endpoints(max_len, slots=2, prefix_cache=False)
    toks = np.arange(7, 27, dtype=np.int32)
    sr, _ = _serve(ref, toks, steps)
    sp, _ = _serve(port, toks, steps)
    [rj] = ref.extract_rows([sr])
    [rt] = port.extract_rows([sp])
    assert (rt.n_pages, rt.pos) == (rj.n_pages, rj.pos)
    assert rt.nbytes == rj.nbytes
    cfg_t = port.cfg
    assert (set(_layer_leaves(cfg_t, rt.page_leaves))
            == paged_layer_leaves(cfg_t, port._paged) == {
                (1, "k"), (1, "v"), (1, "pos")})
    for got, want in ((_layer_leaves(cfg_t, rt.page_leaves),
                       _ref_leaves(ref, rj.page_leaves, True)),
                      (_layer_leaves(cfg_t, rt.resid_leaves),
                       _ref_leaves(ref, rj.resid_leaves, False))):
        assert sorted(got) == sorted(want)
        for lk in want:
            assert got[lk].shape == want[lk].shape, lk
            np.testing.assert_allclose(got[lk], want[lk], atol=1e-5,
                                       rtol=1e-4, err_msg=str(lk))
    assert rt.nbytes == port.cache_nbytes_per_row(rt.pos)


@pytest.mark.parametrize("max_len", [8, 32, 64])
def test_cache_nbytes_per_row_matches_reference(max_len):
    ref, port, _ = _endpoints(max_len, slots=2)
    for L in (0, 1, 7, 8, 9, 16, 17, 31, 32, 33, 64, 100):
        assert port.cache_nbytes_per_row(L) == ref.cache_nbytes_per_row(L)
    assert port.pool_nbytes == ref.pool_nbytes


def _migrated(src, dst, toks, before, after):
    """Serve ``toks`` on ``src`` for ``before`` decode steps, move the row
    to ``dst`` beside a busy neighbour and decode ``after`` more."""
    s, got = _serve(src, toks, before)
    [state] = src.extract_rows([s])
    pos = int(src.slot_pos[s])
    src.release(s)
    other = np.arange(3, dtype=np.int32) + 7
    o = dst.try_claim(tokens=other, max_new=after + 1)
    dst.prefill_batch({o: other})
    d = dst.try_claim(reserve_tokens=pos + after)
    dst.insert_rows([state], [d], [pos])
    for _ in range(after):
        got.append(dst.decode_all({d: got[-1], o: 1})[d])
    return got, state, dst.cache_nbytes_per_row(pos)


def test_paged_hymba_row_migrated_equals_unmigrated():
    """Moved after 12 steps (window rows wrapped, 4 of 8 global pages),
    the row decodes 14 more on a pool of another size: the ids equal the
    unmigrated dense run, in the reference and in the port, and the
    payload's bytes equal the row's cache bytes in both."""
    toks = np.arange(5, 25, dtype=np.int32)
    ref, port, dense = _endpoints(64, slots=2, prefix_cache=False)
    want = _serve(dense, toks, 26)[1]
    ref_dst, port_dst, _ = _endpoints(64, slots=4, prefix_cache=False)
    got_j, state_j, bytes_j = _migrated(ref, ref_dst, toks, 12, 14)
    got_t, state_t, bytes_t = _migrated(port, port_dst, toks, 12, 14)
    assert got_t == got_j == want
    assert state_t.nbytes == state_j.nbytes == bytes_t == bytes_j
    assert state_t.n_pages == 4


def test_live_paged_hymba_migration_matches_reference(deterministic_clock):
    """Two rows resident at a paged edge; R_t crosses the threshold after
    three steps and the longer one moves to the paged cloud: every
    output, latency, per-tick record, counter and link byte equal
    between the packages (the link carries the row's ``PagedRow`` bytes
    and 4 B a token), and the ids equal the unmigrated runs."""
    paged = dict(page_size=PAGE)
    pair = Pair(lambda m: two_tier(m, rtt=0.02, edge_kw=paged,
                                   cloud_kw=paged),
                lambda m: migrate_split(m, 100.0, thr=None), arch=ARCH,
                max_steps_per_tick=3)
    prompt = np.arange(6, dtype=np.int32)
    keep = prompt + 5
    pair.resident(0, prompt, 24)
    pair.resident(1, keep, 9)
    assert pair.tick()["inflight"] == 2
    for cc in pair.ccs:
        cc.policy.migrate_threshold = 50.0
    assert pair.tick()["migrations_fired"] >= 1
    pair.drain()
    pair.check()
    c = pair.port.metrics.counter
    assert c("migrations_completed") >= 1 and c("migrations_aborted") == 0
    _, _, dense = _endpoints(64, slots=2)
    assert list(pair.reqs[1][0].output) == _serve(dense, prompt, 23)[1]


# ---------------------------------------------------------------- families


def test_mixtral_pages_like_dense_below_its_window():
    """mixtral's smoke window is 16: at max_len 8 its one stack has
    extent max_len and pages (ids equal to the reference's paged ids and
    the port's dense ones, past max_len); at max_len 16 the rolling rows
    no longer follow max_len, and both packages refuse the paged
    endpoint when it is built, as at 32."""
    ref, port, dense = _endpoints(8, slots=2, arch="mixtral-8x7b",
                                  prefix_cache=False)
    assert port._paged == ("k", "v", "pos")
    toks = np.arange(1, 4, dtype=np.int32)
    streams = [_serve(ep, toks, 12)[1] for ep in (ref, port, dense)]
    assert streams[0] == streams[1] == streams[2]
    cfg_j, pj, cfg_t, pt = models("mixtral-8x7b")
    msg = "model family 'moe' has no pageable cache leaves"
    for max_len in (16, 32):
        with pytest.raises(ValueError, match=msg):
            JEndpoint(cfg_j, pj, slots=1, max_len=max_len, paged=True,
                      page_size=PAGE)
        with pytest.raises(ValueError, match=msg):
            TEndpoint(cfg_t, pt, slots=1, max_len=max_len, device="cpu",
                      paged=True, page_size=PAGE)


def test_rwkv6_has_no_pageable_leaf():
    cfg_j, pj, cfg_t, pt = models("rwkv6-7b")
    msg = "model family 'rwkv6' has no pageable cache leaves"
    with pytest.raises(ValueError, match=msg):
        JEndpoint(cfg_j, pj, slots=1, max_len=32, paged=True, page_size=PAGE)
    with pytest.raises(ValueError, match=msg):
        TEndpoint(cfg_t, pt, slots=1, max_len=32, device="cpu", paged=True,
                  page_size=PAGE)
