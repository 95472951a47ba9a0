"""The port's serving stack (Endpoint, Continuum) against the JAX
reference, on the CPU, with the same parameters and request streams.

Token ids are exact: greedy decoding of the same float32 model must emit
the same ids per request.  Under a static split the per-tier served
counts are exact too (routing then draws nothing); under ``"auto"`` R_t
follows wall-clock latencies, so only per-request outputs and
conservation (served + failed == submitted after ``drain()``) are held.
"""

import jax
import numpy as np
import pytest
import torch
import hypothesis
import hypothesis.strategies as st

from repro import configs as j_configs
from repro import platform as j_platform
from repro.core.replication import FunctionSpec as JFunctionSpec
from repro.models import model_zoo as j_zoo
from repro.serving.engine import Endpoint as JEndpoint
from repro.serving.engine import Request as JRequest
from repro_torch import bridge
from repro_torch import configs as t_configs
from repro_torch import platform as t_platform
from repro_torch.serving.engine import Endpoint as TEndpoint

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ARCH = "stablelm-1.6b"


@pytest.fixture(scope="module")
def models():
    cfg_j = j_configs.get_smoke_config(ARCH)
    cfg_t = t_configs.get_smoke_config(ARCH)
    pj = j_zoo.init(jax.random.PRNGKey(0), cfg_j)
    pt = bridge.params_from_numpy({k: np.asarray(v) for k, v in pj.items()},
                                  cfg_t, "cpu")
    return cfg_j, pj, cfg_t, pt


@hypothesis.settings(max_examples=3, deadline=None, database=None)
@hypothesis.given(seed=st.integers(0, 10_000))
def test_endpoint_stream_matches_reference(models, seed):
    """The same random admit / decode / retire schedule (the loop of
    test_parity_fuzz's paged-vs-dense stream fuzz, without paging) gives
    the same token ids at every step; the rolling 32-token cache wraps."""
    cfg_j, pj, cfg_t, pt = models
    rng = np.random.default_rng(seed)
    slots, max_len = 3, 32
    ref = JEndpoint(cfg_j, pj, slots=slots, max_len=max_len)
    port = TEndpoint(cfg_t, pt, slots=slots, max_len=max_len, device="cpu")
    active = {}                       # slot -> [remaining, last_token]
    for _ in range(24):
        if len(active) < slots and rng.uniform() < 0.5:
            toks = rng.integers(0, 64, int(rng.integers(1, 16))).astype(
                np.int32)
            need = int(rng.integers(1, 9))
            sr = ref.try_claim(tokens=toks, max_new=need)
            sp = port.try_claim(tokens=toks, max_new=need)
            assert sr == sp and sr is not None
            fr = ref.prefill_batch({sr: toks})[sr]
            fp = port.prefill_batch({sp: toks})[sp]
            assert fr == fp
            active[sr] = [need - 1, fr]
        retire = [s for s, (rem, _) in active.items() if rem <= 0]
        for s in retire:
            ref.release(s)
            port.release(s)
            del active[s]
        if active and rng.uniform() < 0.9:
            cur = {s: tok for s, (_, tok) in active.items()}
            nr = ref.decode_all(dict(cur))
            np_ = port.decode_all(dict(cur))
            assert nr == np_
            for s in active:
                active[s] = [active[s][0] - 1, nr[s]]
    np.testing.assert_array_equal(port.slot_pos, ref.slot_pos)


def test_endpoint_packed_prefill_and_rows(models):
    """A packed multi-request prefill (shared length groups, pow2 batch
    bucket with a repeated row) matches the reference; extracted rows
    re-inserted into a peer endpoint resume the same stream; the logical
    row size matches the reference's."""
    cfg_j, pj, cfg_t, pt = models
    rng = np.random.default_rng(5)
    ref = JEndpoint(cfg_j, pj, slots=4, max_len=32)
    port = TEndpoint(cfg_t, pt, slots=4, max_len=32, device="cpu")
    prompts = {}
    for L in (5, 9, 9, 9):
        s = port.try_claim()
        assert ref.try_claim() == s
        prompts[s] = rng.integers(0, 256, L).astype(np.int32)
    fr = ref.prefill_batch(prompts)
    fp = port.prefill_batch(prompts)
    assert fr == fp
    nr = ref.decode_all(fr)
    np_ = port.decode_all(fp)
    assert nr == np_
    peer = TEndpoint(cfg_t, pt, slots=2, max_len=32, device="cpu")
    rows = port.extract_rows([1, 3])
    dst = [peer.try_claim(), peer.try_claim()]
    peer.insert_rows(rows, dst, [int(port.slot_pos[1]), int(port.slot_pos[3])])
    moved = peer.decode_all({dst[0]: np_[1], dst[1]: np_[3]})
    stay = port.decode_all({1: np_[1], 3: np_[3]})
    assert [moved[dst[0]], moved[dst[1]]] == [stay[1], stay[3]]
    for length in (1, 7, 32, 40):
        assert port.cache_nbytes_per_row(length) == \
            ref.cache_nbytes_per_row(length)
    port.reset_slot(2)                    # back to the init template
    assert bool((port.cache["pos"][:, 2] == -1).all())
    assert not port.cache["k"][:, 2].any()
    assert bool((port.cache["pos"][:, 3] >= 0).any())


def _drive(cc, cfg_vocab, seed, rounds, spec_cls, req_cls):
    """Submit a seeded ramped request stream, tick per round, drain.
    Returns (requests by rid, per-tick served counts)."""
    rng = np.random.default_rng(seed)
    cc.deploy(spec_cls(name="fn", arch=ARCH), *cc._model)
    reqs = {}
    for rnd in range(rounds):
        for _ in range(2 + 2 * rnd):
            L = int(rng.integers(3, 13))
            r = req_cls(rid=len(reqs),
                        tokens=rng.integers(0, cfg_vocab, L).astype(np.int32),
                        max_new=int(rng.integers(1, 5)))
            reqs[r.rid] = r
            cc.submit("fn", r)
        cc.tick()
    cc.drain()
    return reqs, [rec["tiers"] for rec in cc.log]


def _pair(models, policy, seed=0, rounds=4):
    cfg_j, pj, cfg_t, pt = models
    ref = j_platform.Continuum(
        edge=j_platform.TierConfig(slots=2, max_len=32),
        cloud=j_platform.TierConfig(slots=4, max_len=32,
                                    extra_latency_s=0.02),
        policy=policy, seed=seed)
    ref._model = (cfg_j, pj)
    port = t_platform.Continuum(
        edge=t_platform.TierConfig(slots=2, max_len=32),
        cloud=t_platform.TierConfig(slots=4, max_len=32,
                                    extra_latency_s=0.02),
        policy=policy, seed=seed, device="cpu")
    port._model = (cfg_t, pt)
    rj, tj = _drive(ref, cfg_t.vocab_size, seed, rounds, JFunctionSpec,
                    JRequest)
    rt, tt = _drive(port, cfg_t.vocab_size, seed, rounds,
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


@pytest.mark.parametrize("policy", ["0", "100"])
def test_continuum_static_split_matches_reference(models, policy):
    ref, port, rj, rt, tj, tt = _pair(models, policy)
    _same_outputs(rj, rt)
    assert tt == tj                       # per-tick, per-tier served counts
    served = sum(sum(t.values()) for t in tt)
    assert served + sum(r.failed for r in rt.values()) == len(rt)
    busy = "edge" if policy == "0" else "cloud"
    assert sum(t[busy] for t in tt) == served > 0


def test_continuum_auto_matches_reference_outputs(models):
    ref, port, rj, rt, tj, tt = _pair(models, "auto", rounds=5)
    _same_outputs(rj, rt)
    served = sum(sum(t.values()) for t in tt)
    failed = sum(r.failed for r in rt.values())
    assert served + failed == len(rt)
    assert port.queued == 0 and port.in_flight == 0
    assert all(r.output is not None for r in rt.values() if not r.failed)
    # both tiers share the one set of weights
    assert (port.edge.endpoints["fn"].params
            is port.cloud.endpoints["fn"].params)
