"""The port's hymba family against the JAX reference, on the CPU.

The hymba-1.5b smoke config in float32 (3 layers, window 16, layer 1
global): parameters come from the reference's ``model_zoo.init`` and
cross over through ``repro_torch.bridge``.  The reference runs its plain
XLA path (``use_pallas=False``, the SSM's chunked scan); the port runs
``kernels.ops.ssd_scan``'s plain sequential scan on CPU tensors.  The SSM
block's output and state agree within 1e-4 (the reference's own
``ssd_scan`` tolerance), model logits within 1e-4, token ids, cache
positions, slot positions, served counts and row byte counts exactly.
"""

import dataclasses

import hypothesis
import hypothesis.strategies as st
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro import platform as j_platform
from repro.core.replication import FunctionSpec as JFunctionSpec
from repro.models import model_zoo as j_zoo
from repro.models import ssm as j_ssm
from repro.serving.engine import Endpoint as JEndpoint
from repro.serving.engine import Request as JRequest
from repro_torch import bridge
from repro_torch import configs as t_configs
from repro_torch import platform as t_platform
from repro_torch.kernels import ops as t_ops
from repro_torch.models import model_zoo as t_zoo
from repro_torch.models import ssm as t_ssm
from repro_torch.models import transformer as t_transformer
from repro_torch.serving.engine import Endpoint as TEndpoint

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ARCH = "hymba-1.5b"


@pytest.fixture(scope="module")
def models():
    cfg_j = j_configs.get_smoke_config(ARCH)
    cfg_t = t_configs.get_smoke_config(ARCH)
    pj = j_zoo.init(jax.random.PRNGKey(0), cfg_j)
    pt = bridge.params_from_numpy({k: np.asarray(v) for k, v in pj.items()},
                                  cfg_t, "cpu")
    return cfg_j, pj, cfg_t, pt


def _f64(x):
    return np.asarray(x, np.float64)


# ---------------------------------------------------------------- config


@pytest.mark.parametrize("which", ["smoke", "full"])
def test_config_and_param_table_match_reference(which):
    get_j = j_configs.get_smoke_config if which == "smoke" else \
        j_configs.get_config
    get_t = t_configs.get_smoke_config if which == "smoke" else \
        t_configs.get_config
    cj, ct = get_j(ARCH), get_t(ARCH)
    for f in ("family", "num_layers", "d_model", "num_heads", "num_kv_heads",
              "head_dim", "d_ff", "vocab_size", "ssm_state", "ssm_expand",
              "ssm_conv", "ssm_d_inner", "sliding_window", "global_layers",
              "rope_theta", "activation", "norm_type", "norm_eps"):
        assert getattr(ct, f) == getattr(cj, f), f
    tj, tt = j_zoo.param_table(cj), t_zoo.param_table(ct)
    assert sorted(tj) == sorted(tt)
    for k in tj:
        assert tuple(tj[k].shape) == tuple(tt[k].shape), k
        assert (tj[k].init, tj[k].scale) == (tt[k].init, tt[k].scale), k
    assert ct.param_count() == cj.param_count()
    dt = torch.bfloat16 if which == "full" else torch.float32
    assert ct.param_dtype == ct.compute_dtype == dt


def test_bridge_carries_hymba_params_and_refuses_drift(models):
    cfg_j, pj, cfg_t, pt = models
    flat = {k: np.asarray(v) for k, v in pj.items()}
    for k, v in flat.items():
        np.testing.assert_array_equal(pt[k].numpy(), v, err_msg=k)
    drifted = dict(flat)
    drifted["layers/ssm/A_logs"] = drifted.pop("layers/ssm/A_log")
    with pytest.raises(ValueError, match="parameter keys differ"):
        bridge.params_from_numpy(drifted, cfg_t, "cpu")
    bad = dict(flat)
    bad["layers/ssm/wB"] = bad["layers/ssm/wB"][..., :-1]
    with pytest.raises(ValueError, match="shape"):
        bridge.params_from_numpy(bad, cfg_t, "cpu")


def test_init_draws_the_reference_constants():
    cfg = t_configs.get_smoke_config(ARCH)
    p = t_zoo.init(cfg, torch.Generator().manual_seed(0))
    assert bool((p["layers/ssm/dt_bias"] == -2.0).all())
    assert bool((p["layers/ssm/A_log"] == 0.0).all())
    assert bool((p["layers/ssm/Dskip"] == 1.0).all())


# ---------------------------------------------------------------- ssm_block


def _layer(params, i):
    """Layer i's slice of a stacked parameter dict (either package)."""
    return {k[len("layers/"):]: v[i] for k, v in params.items()
            if k.startswith("layers/")}


@pytest.mark.parametrize("S", [1, 16, 128, 256])
def test_ssm_block_matches_reference(models, S):
    """Prefill from a nonzero state: the block's output, final h and conv
    state against the reference's XLA path; then one decode step from the
    prefilled state, with only row 0 written."""
    cfg_j, pj, cfg_t, pt = models
    rng = np.random.default_rng(S)
    B, d = 2, cfg_t.d_model
    I, N, K = cfg_t.ssm_d_inner, cfg_t.ssm_state, cfg_t.ssm_conv
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    h0 = (0.3 * rng.standard_normal((B, I, N))).astype(np.float32)
    c0 = rng.standard_normal((B, K - 1, I)).astype(np.float32)
    pl_j, pl_t = _layer(pj, 1), _layer(pt, 1)
    out_j, st_j = j_ssm.ssm_block(cfg_j, pl_j, jnp.asarray(x),
                                  {"h": jnp.asarray(h0),
                                   "conv": jnp.asarray(c0)}, "prefill")
    st_t = {"h": torch.from_numpy(h0.copy()),
            "conv": torch.from_numpy(c0.copy())}
    t_ops.reset_launches()
    with torch.no_grad():
        out_t = t_ssm.ssm_block(cfg_t, pl_t, torch.from_numpy(x), st_t,
                                "prefill")
    assert t_ops.launches["ssd_scan_plain"] == 1
    assert out_t.dtype == torch.float32 and out_t.shape == (B, S, d)
    assert st_t["h"].dtype == torch.float32
    np.testing.assert_allclose(out_t.numpy(), _f64(out_j), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(st_t["h"].numpy(), _f64(st_j["h"]),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(st_t["conv"].numpy(), _f64(st_j["conv"]),
                               atol=1e-4, rtol=1e-4)

    x1 = rng.standard_normal((B, 1, d)).astype(np.float32)
    out1_j, st1_j = j_ssm.ssm_block(cfg_j, pl_j, jnp.asarray(x1), st_j,
                                    "decode")
    before = {k: v.clone() for k, v in st_t.items()}
    with torch.no_grad():
        out1_t = t_ssm.ssm_block(cfg_t, pl_t, torch.from_numpy(x1), st_t,
                                 "decode", rows=torch.tensor([0]))
    assert t_ops.launches["ssd_scan_plain"] == 1          # decode: no scan
    np.testing.assert_allclose(out1_t.numpy(), _f64(out1_j), atol=1e-4,
                               rtol=1e-4)
    for k in ("h", "conv"):
        np.testing.assert_allclose(st_t[k][0].numpy(), _f64(st1_j[k][0]),
                                   atol=1e-4, rtol=1e-4)
        assert torch.equal(st_t[k][1], before[k][1]), k


# ---------------------------------------------------------------- model


def _check_caches(tag, cfg_t, cj, ct):
    views = t_transformer.layer_caches(cfg_t, ct)
    assert len(views) == len(cj) == cfg_t.num_layers
    for i, (lj, lt) in enumerate(zip(cj, views)):
        assert sorted(lt) == sorted(lj), (tag, i)
        np.testing.assert_array_equal(lt["pos"].numpy(), np.asarray(lj["pos"]),
                                      err_msg=f"{tag}: layer {i} pos")
        for k in ("k", "v", "h", "conv"):
            assert tuple(lt[k].shape) == tuple(lj[k].shape), (tag, i, k)
            np.testing.assert_allclose(lt[k].numpy(), _f64(lj[k]),
                                       atol=1e-4, rtol=1e-4,
                                       err_msg=f"{tag}: layer {i} {k}")


def test_prefill_and_decode_match_reference(models):
    """A 20-token prompt (longer than the 16-token window) and 16 decode
    steps into a 32-wide cache: the window layers' rolling caches wrap,
    the global layer's does not.  Logits within 1e-4, greedy ids, cache
    positions and every layer's k/v/h/conv against the reference."""
    cfg_j, pj, cfg_t, pt = models
    rng = np.random.default_rng(0)
    B, S, W = 2, 20, 32
    tok = rng.integers(0, cfg_t.vocab_size, (B, S)).astype(np.int32)
    j_prefill = jax.jit(lambda p, b, c: j_zoo.prefill(cfg_j, p, b, c))
    j_decode = jax.jit(lambda p, c, x, t: j_zoo.decode(cfg_j, p, c, x, t))
    cj = j_zoo.init_cache(cfg_j, B, W)
    lj, cj = j_prefill(pj, {"tokens": jnp.asarray(tok)}, cj)
    ct = t_zoo.init_cache(cfg_t, B, W, "cpu")
    t_ops.reset_launches()
    with torch.no_grad():
        lt, ct = t_zoo.prefill(cfg_t, pt, {"tokens": torch.from_numpy(tok)},
                               ct)
    assert t_ops.launches["ssd_scan_plain"] == cfg_t.num_layers
    assert t_ops.launches["flash_attention_plain"] == cfg_t.num_layers
    np.testing.assert_allclose(lt.numpy(), _f64(lj), atol=1e-4, rtol=0)
    _check_caches("prefill", cfg_t, cj, ct)
    toks = np.asarray(lj).argmax(-1).astype(np.int32)
    assert np.array_equal(toks, lt.numpy().argmax(-1))
    t = np.full(B, S, np.int32)
    for step in range(12):
        gj, cj = j_decode(pj, cj, jnp.asarray(toks), jnp.asarray(t))
        with torch.no_grad():
            gt, ct = t_zoo.decode(cfg_t, pt, ct, torch.from_numpy(toks),
                                  torch.from_numpy(t))
        np.testing.assert_allclose(gt.numpy(), _f64(gj), atol=1e-4, rtol=0,
                                   err_msg=f"decode {step}")
        toks = np.asarray(gj).argmax(-1).astype(np.int32)
        assert np.array_equal(toks, gt.numpy().argmax(-1)), step
        t = t + 1
    _check_caches("decode", cfg_t, cj, ct)
    assert t_ops.launches["ssd_scan_plain"] == cfg_t.num_layers


def test_prefill_decode_consistency():
    """The port of ``tests/test_archs.py::test_prefill_decode_consistency``
    for hymba: decode(t=S) after prefill(S) == prefill(S+1)'s last
    logits."""
    cfg = t_configs.get_smoke_config(ARCH)
    params = t_zoo.init(cfg, torch.Generator().manual_seed(1))
    B, S = 2, 24
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32))
    with torch.no_grad():
        cache = t_zoo.init_cache(cfg, B, S + 8, "cpu")
        _, cache = t_zoo.prefill(cfg, params, {"tokens": toks[:, :S]}, cache)
        lgA, _ = t_zoo.decode(cfg, params, cache, toks[:, S],
                              torch.full((B,), S, dtype=torch.int32))
        cacheB = t_zoo.init_cache(cfg, B, S + 8, "cpu")
        lgB, _ = t_zoo.prefill(cfg, params, {"tokens": toks}, cacheB)
    rel = (lgA - lgB).abs().max() / (lgB.abs().max() + 1e-9)
    assert rel < 2e-3, rel


def test_inactive_rows_keep_their_state(models):
    """decode with an active mask writes only the active rows: the masked
    row's KV, h and conv stay bit for bit."""
    _, _, cfg_t, pt = models
    tok = np.random.default_rng(2).integers(0, cfg_t.vocab_size,
                                            (3, 8)).astype(np.int32)
    cache = t_zoo.init_cache(cfg_t, 3, 32, "cpu")
    with torch.no_grad():
        t_zoo.prefill(cfg_t, pt, {"tokens": torch.from_numpy(tok)}, cache)
        before = {k: v.clone() for k, v in cache.items()}
        t_zoo.decode(cfg_t, pt, cache, torch.tensor([1, 2, 3]),
                     torch.tensor([8, 8, 8]),
                     torch.tensor([True, False, True]))
    assert {"h", "conv", "window/k", "global/k"} <= set(cache)
    for k in cache:
        assert torch.equal(cache[k][:, 1], before[k][:, 1]), k
        assert not torch.equal(cache[k][:, 0], before[k][:, 0]), k


def paged_layer_leaves(cfg_t, names):
    """The (layer, key) pairs a set of the port's stacked leaf names
    covers."""
    groups = t_transformer.cache_groups(cfg_t)
    out = set()
    for name in names:
        group, _, key = name.rpartition("/")
        layers = groups[group + "/"] if group else range(cfg_t.num_layers)
        out |= {(i, key) for i in layers}
    return out


def test_paged_pool_is_not_ported_for_hymba(models):
    """hymba's paged pool is ported (``tests/test_torch_paged_hybrid.py``
    holds its streams against the reference); it pages exactly the
    leaves the reference pages: the global layer's KV when max_len
    outgrows the 16-wide window, every attention stack below it, never
    the SSM state."""
    cfg_j, pj, cfg_t, pt = models
    for max_len in (8, 16, 32, 64):
        ref = JEndpoint(cfg_j, pj, slots=2, max_len=max_len, paged=True,
                        page_size=8)
        port = TEndpoint(cfg_t, pt, slots=2, max_len=max_len, device="cpu",
                         paged=True, page_size=8)
        keys = [(i, k) for i, layer in enumerate(ref.cache)
                for k in sorted(layer)]
        want = {lk for lk, pg in zip(keys, ref._is_paged_leaf) if pg}
        assert paged_layer_leaves(cfg_t, port._paged) == want, max_len
        assert port.pool_nbytes == ref.pool_nbytes, max_len


# ---------------------------------------------------------------- Endpoint


def _row_state(ep, slot):
    return {k: v[:, slot].clone() for k, v in ep.cache.items()}


@hypothesis.settings(max_examples=3, deadline=None, database=None)
@hypothesis.given(seed=st.integers(0, 10_000))
def test_endpoint_stream_matches_reference(models, seed):
    """A random admit / decode / retire stream (the loop of
    ``test_torch_serving``'s stream test) gives the same token ids at
    every step.  Prompts of 5 or 20 tokens and up to 32 positions a row,
    so the 16-wide window layers wrap while the 32-wide global layer does
    not; now and then one live row sits out a step, and its KV rows and
    SSM state must not move."""
    cfg_j, pj, cfg_t, pt = models
    rng = np.random.default_rng(seed)
    slots, max_len = 3, 32
    ref = JEndpoint(cfg_j, pj, slots=slots, max_len=max_len)
    port = TEndpoint(cfg_t, pt, slots=slots, max_len=max_len, device="cpu")
    active = {}                       # slot -> [remaining, last_token]
    parked = 0
    for _ in range(28):
        if len(active) < slots and rng.uniform() < 0.5:
            L = int(rng.choice([5, 20]))
            toks = rng.integers(0, cfg_t.vocab_size, L).astype(np.int32)
            need = int(rng.integers(1, max_len - L + 1))
            sr = ref.try_claim(tokens=toks, max_new=need)
            sp = port.try_claim(tokens=toks, max_new=need)
            assert sr == sp and sr is not None
            fr = ref.prefill_batch({sr: toks})[sr]
            fp = port.prefill_batch({sp: toks})[sp]
            assert fr == fp
            active[sr] = [need - 1, fr]
        for s in [s for s, (rem, _) in active.items() if rem <= 0]:
            ref.release(s)
            port.release(s)
            del active[s]
        if active and rng.uniform() < 0.9:
            cur = {s: tok for s, (_, tok) in active.items()}
            sit_out = None
            if len(cur) > 1 and rng.uniform() < 0.3:
                sit_out = int(rng.choice(sorted(cur)))
                del cur[sit_out]
                held = _row_state(port, sit_out)
                parked += 1
            nr = ref.decode_all(dict(cur))
            np_ = port.decode_all(dict(cur))
            assert nr == np_
            if sit_out is not None:
                for k, v in _row_state(port, sit_out).items():
                    assert torch.equal(v, held[k]), k
            for s in cur:
                active[s] = [active[s][0] - 1, nr[s]]
        np.testing.assert_array_equal(port.slot_pos, ref.slot_pos)
    hypothesis.note(f"rows parked for a step: {parked}")


def test_endpoint_packed_prefill_rows_and_bytes(models):
    """Packed prefill (a repeated-row pow2 batch, no length padding),
    extract/insert into a peer endpoint resuming the same stream, reset,
    and the logical row size against the reference to the byte."""
    cfg_j, pj, cfg_t, pt = models
    rng = np.random.default_rng(5)
    ref = JEndpoint(cfg_j, pj, slots=4, max_len=32)
    port = TEndpoint(cfg_t, pt, slots=4, max_len=32, device="cpu")
    prompts = {}
    for L in (5, 18, 18, 18):
        s = port.try_claim()
        assert ref.try_claim() == s
        prompts[s] = rng.integers(0, cfg_t.vocab_size, L).astype(np.int32)
    t_ops.reset_launches()
    fr = ref.prefill_batch(prompts)
    fp = port.prefill_batch(prompts)
    assert fr == fp
    # two length groups, each prefilled at its exact length
    assert t_ops.launches["ssd_scan_plain"] == 2 * cfg_t.num_layers
    nr = ref.decode_all(fr)
    np_ = port.decode_all(fp)
    assert nr == np_
    peer = TEndpoint(cfg_t, pt, slots=2, max_len=32, device="cpu")
    rows = port.extract_rows([1, 3])
    dst = [peer.try_claim(), peer.try_claim()]
    peer.insert_rows(rows, dst, [int(port.slot_pos[1]), int(port.slot_pos[3])])
    a, b = {dst[0]: np_[1], dst[1]: np_[3]}, {1: np_[1], 3: np_[3]}
    for _ in range(4):
        moved, stay = peer.decode_all(a), port.decode_all(b)
        assert [moved[dst[0]], moved[dst[1]]] == [stay[1], stay[3]]
        a = {dst[0]: moved[dst[0]], dst[1]: moved[dst[1]]}
        b = {1: stay[1], 3: stay[3]}
    for length in (0, 1, 7, 16, 17, 31, 32, 40):
        assert port.cache_nbytes_per_row(length) == \
            ref.cache_nbytes_per_row(length), length
    port.reset_slot(2)                    # back to the init template
    for k, leaf in port.cache.items():
        assert torch.equal(leaf[:, 2], port._row_init[k][:, 0]), k
    assert bool((port.cache["h"][:, 3] != 0).any())


def test_prompt_length_rule_of_the_ssm_scan(models):
    """A 200-token prompt is refused by the port's endpoint, as by the
    reference's kernel path (``use_pallas=True``)."""
    cfg_j, pj, cfg_t, pt = models
    toks = np.arange(200, dtype=np.int32) % cfg_t.vocab_size
    ref = JEndpoint(dataclasses.replace(cfg_j, use_pallas=True), pj,
                    slots=1, max_len=256)
    port = TEndpoint(cfg_t, pt, slots=1, max_len=256, device="cpu")
    for ep in (ref, port):
        s = ep.try_claim()
        with pytest.raises(ValueError, match="not divisible by chunk 128"):
            ep.prefill_batch({s: toks})


# ---------------------------------------------------------------- Continuum


def _drive(cc, vocab, seed, rounds, spec_cls, req_cls):
    rng = np.random.default_rng(seed)
    cc.deploy(spec_cls(name="fn", arch=ARCH), *cc._model)
    reqs = {}
    for rnd in range(rounds):
        for _ in range(2 + 2 * rnd):
            L = int(rng.choice([4, 18]))
            r = req_cls(rid=len(reqs),
                        tokens=rng.integers(0, vocab, L).astype(np.int32),
                        max_new=int(rng.integers(1, 6)))
            reqs[r.rid] = r
            cc.submit("fn", r)
        cc.tick()
    cc.drain()
    return reqs, [rec["tiers"] for rec in cc.log]


@pytest.mark.parametrize("policy", ["0", "100"])
def test_continuum_static_split_matches_reference(models, policy):
    """The continuum over hymba smoke: per-tick, per-tier served counts
    and every request's token ids equal the reference's."""
    cfg_j, pj, cfg_t, pt = models
    ref = j_platform.Continuum(
        edge=j_platform.TierConfig(slots=2, max_len=32),
        cloud=j_platform.TierConfig(slots=4, max_len=32,
                                    extra_latency_s=0.02),
        policy=policy, seed=0)
    ref._model = (cfg_j, pj)
    port = t_platform.Continuum(
        edge=t_platform.TierConfig(slots=2, max_len=32),
        cloud=t_platform.TierConfig(slots=4, max_len=32,
                                    extra_latency_s=0.02),
        policy=policy, seed=0, device="cpu")
    port._model = (cfg_t, pt)
    rj, tj = _drive(ref, cfg_t.vocab_size, 0, 3, JFunctionSpec, JRequest)
    rt, tt = _drive(port, cfg_t.vocab_size, 0, 3, t_platform.FunctionSpec,
                    t_platform.Request)
    assert tt == tj
    assert sorted(rj) == sorted(rt)
    for rid in rj:
        assert rj[rid].failed == rt[rid].failed, rid
        if rj[rid].output is None:
            assert rt[rid].output is None, rid
        else:
            np.testing.assert_array_equal(rt[rid].output, rj[rid].output,
                                          err_msg=f"request {rid}")
    served = sum(sum(t.values()) for t in tt)
    assert served + sum(r.failed for r in rt.values()) == len(rt)
    busy = "edge" if policy == "0" else "cloud"
    assert sum(t[busy] for t in tt) == served > 0
