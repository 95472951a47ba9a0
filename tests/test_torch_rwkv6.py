"""The port's rwkv6 family against the JAX reference, on the CPU.

The rwkv6-7b smoke config in float32 (2 layers, d 64, 4 heads of 16):
parameters come from the reference's ``model_zoo.init`` and cross over
through ``repro_torch.bridge``.  The reference runs its XLA path
(``use_pallas=False``, the chunked WKV form); the port runs
``kernels.ops.rwkv6_scan``'s plain per-token recurrence on CPU tensors.
Prompt lengths are ones both of the reference's paths admit (<= 32, or a
multiple of 128), so either could be the oracle.  Blocks and their state
agree within the reference's own WKV tolerance, 5e-4 abs / 5e-3 rel
(``tests/test_kernels.py:137-138``); model logits within 1e-4 of the
largest logit; token ids, slot positions, served counts and row byte
counts exactly.
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
from repro.models import rwkv6 as j_rwkv6
from repro.serving.engine import Endpoint as JEndpoint
from repro.serving.engine import Request as JRequest
from repro_torch import bridge
from repro_torch import configs as t_configs
from repro_torch import platform as t_platform
from repro_torch.kernels import ops as t_ops
from repro_torch.models import model_zoo as t_zoo
from repro_torch.models import rwkv6 as t_rwkv6
from repro_torch.models import transformer as t_transformer
from repro_torch.serving.engine import Endpoint as TEndpoint

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ARCH = "rwkv6-7b"
TOL = dict(atol=5e-4, rtol=5e-3)
STATE = ("tm_x", "tm_s", "cm_x")


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
              "head_dim", "rwkv_head_dim", "num_rwkv_heads", "d_ff",
              "vocab_size", "activation", "norm_type", "norm_eps"):
        assert getattr(ct, f) == getattr(cj, f), f
    tj, tt = j_zoo.param_table(cj), t_zoo.param_table(ct)
    assert sorted(tj) == sorted(tt)
    for k in tj:
        assert tuple(tj[k].shape) == tuple(tt[k].shape), k
        assert (tj[k].init, tj[k].scale) == (tt[k].init, tt[k].scale), k
    assert ct.param_count() == cj.param_count()
    dt = torch.bfloat16 if which == "full" else torch.float32
    assert ct.param_dtype == ct.compute_dtype == dt


def test_get_config_returns_the_reference_config():
    """rwkv6-7b is ported: ``get_config`` returns the reference's full
    config (7,576,752,128 parameters, 15.15 GB in bf16) instead of
    raising."""
    cj, ct = j_configs.get_config(ARCH), t_configs.get_config(ARCH)
    assert ct.name == cj.name == ARCH and ct.family == "rwkv6"
    assert (ct.num_layers, ct.d_model, ct.num_rwkv_heads, ct.rwkv_head_dim,
            ct.d_ff, ct.vocab_size) == (32, 4096, 64, 64, 14336, 65536)
    assert ct.param_count() == cj.param_count() == 7_576_752_128
    assert ARCH in t_configs.ARCHS


def test_bridge_carries_rwkv6_params_and_refuses_drift(models):
    cfg_j, pj, cfg_t, pt = models
    flat = {k: np.asarray(v) for k, v in pj.items()}
    for k, v in flat.items():
        np.testing.assert_array_equal(pt[k].numpy(), v, err_msg=k)
    drifted = dict(flat)
    drifted["layers/tm/decay"] = drifted.pop("layers/tm/decay_a")
    with pytest.raises(ValueError, match="parameter keys differ"):
        bridge.params_from_numpy(drifted, cfg_t, "cpu")
    bad = dict(flat)
    bad["layers/tm/u"] = bad["layers/tm/u"][..., :-1]
    with pytest.raises(ValueError, match="shape"):
        bridge.params_from_numpy(bad, cfg_t, "cpu")


def test_init_draws_the_reference_constants():
    cfg = t_configs.get_smoke_config(ARCH)
    p = t_zoo.init(cfg, torch.Generator().manual_seed(0))
    assert bool((p["layers/tm/w0"] == -5.0).all())
    assert bool((p["layers/tm/ln_scale"] == 1.0).all())
    assert bool((p["layers/tm/ln_bias"] == 0.0).all())
    table = t_zoo.param_table(cfg)
    uniform = [k for k, s in table.items() if s.init == "uniform_pm"]
    assert sorted(uniform) == ["layers/cm/mu_k", "layers/cm/mu_r",
                               "layers/tm/mu5", "layers/tm/mu_x",
                               "layers/tm/u"]
    for k in uniform:
        scale = table[k].scale
        assert float(p[k].abs().max()) <= scale, k
        # spread over the interval, both signs
        assert float(p[k].min()) < -scale / 2 < scale / 2 < float(p[k].max())


# ---------------------------------------------------------------- blocks


def _layer(params, i):
    """Layer i's slice of a stacked parameter dict (either package)."""
    return {k[len("layers/"):]: v[i] for k, v in params.items()
            if k.startswith("layers/")}


@pytest.mark.parametrize("block", ["time_mix", "channel_mix"])
@pytest.mark.parametrize("S", [1, 24, 64, 128])
def test_block_matches_reference(models, block, S):
    """Prefill of S tokens from a nonzero state: the block's output and
    every state leaf against the reference's XLA path; then one decode
    step from the prefilled state with only row 0 written."""
    cfg_j, pj, cfg_t, pt = models
    rng = np.random.default_rng(S)
    B, d = 2, cfg_t.d_model
    H, D = cfg_t.num_rwkv_heads, cfg_t.rwkv_head_dim
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    st0 = {"x": rng.standard_normal((B, d)).astype(np.float32)}
    if block == "time_mix":
        st0["s"] = (0.3 * rng.standard_normal((B, H, D, D))).astype(
            np.float32)
    fj, ft = getattr(j_rwkv6, block), getattr(t_rwkv6, block)
    pl_j, pl_t = _layer(pj, 1), _layer(pt, 1)
    out_j, st_j = fj(cfg_j, pl_j, jnp.asarray(x),
                     {k: jnp.asarray(v) for k, v in st0.items()}, "prefill")
    st_t = {k: torch.from_numpy(v.copy()) for k, v in st0.items()}
    t_ops.reset_launches()
    with torch.no_grad():
        out_t = ft(cfg_t, pl_t, torch.from_numpy(x), st_t, "prefill")
    assert t_ops.launches["rwkv6_scan_plain"] == (block == "time_mix")
    assert out_t.dtype == torch.float32 and out_t.shape == (B, S, d)
    np.testing.assert_allclose(out_t.numpy(), _f64(out_j), **TOL)
    for k in st0:
        assert st_t[k].dtype == torch.float32, k
        np.testing.assert_allclose(st_t[k].numpy(), _f64(st_j[k]), **TOL,
                                   err_msg=k)

    x1 = rng.standard_normal((B, 1, d)).astype(np.float32)
    out1_j, st1_j = fj(cfg_j, pl_j, jnp.asarray(x1), st_j, "decode")
    before = {k: v.clone() for k, v in st_t.items()}
    with torch.no_grad():
        out1_t = ft(cfg_t, pl_t, torch.from_numpy(x1), st_t, "decode",
                    rows=torch.tensor([0]))
    assert t_ops.launches["rwkv6_scan_plain"] == (block == "time_mix")
    np.testing.assert_allclose(out1_t.numpy(), _f64(out1_j), **TOL)
    for k in st0:
        np.testing.assert_allclose(st_t[k][0].numpy(), _f64(st1_j[k][0]),
                                   **TOL, err_msg=k)
        assert torch.equal(st_t[k][1], before[k][1]), k


# ---------------------------------------------------------------- model


def _check_caches(tag, cfg_t, cj, ct):
    views = t_transformer.layer_caches(cfg_t, ct)
    assert sorted(ct) == sorted(cj) == sorted(STATE)
    for i, lt in enumerate(views):
        for k in STATE:
            assert tuple(lt[k].shape) == tuple(cj[k].shape[1:]), (tag, i, k)
            assert lt[k].dtype == torch.float32, (tag, i, k)
            np.testing.assert_allclose(lt[k].numpy(), _f64(cj[k][i]), **TOL,
                                       err_msg=f"{tag}: layer {i} {k}")


def test_prefill_and_decode_match_reference(models):
    """A 24-token prompt and 12 decode steps: logits within 1e-4 of the
    largest logit, greedy ids, and every layer's tm_x, tm_s and cm_x
    against the reference."""
    cfg_j, pj, cfg_t, pt = models
    rng = np.random.default_rng(0)
    B, S, W = 2, 24, 64
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
    assert t_ops.launches["rwkv6_scan_plain"] == cfg_t.num_layers
    assert sum(t_ops.launches.values()) == cfg_t.num_layers  # no attention
    scale = float(np.abs(np.asarray(lj)).max())
    np.testing.assert_allclose(lt.numpy(), _f64(lj), atol=1e-4 * scale,
                               rtol=0)
    _check_caches("prefill", cfg_t, cj, ct)
    toks = np.asarray(lj).argmax(-1).astype(np.int32)
    assert np.array_equal(toks, lt.numpy().argmax(-1))
    t = np.full(B, S, np.int32)
    for step in range(12):
        gj, cj = j_decode(pj, cj, jnp.asarray(toks), jnp.asarray(t))
        with torch.no_grad():
            gt, ct = t_zoo.decode(cfg_t, pt, ct, torch.from_numpy(toks),
                                  torch.from_numpy(t))
        scale = float(np.abs(np.asarray(gj)).max())
        np.testing.assert_allclose(gt.numpy(), _f64(gj), atol=1e-4 * scale,
                                   rtol=0, err_msg=f"decode {step}")
        toks = np.asarray(gj).argmax(-1).astype(np.int32)
        assert np.array_equal(toks, gt.numpy().argmax(-1)), step
        t = t + 1
    _check_caches("decode", cfg_t, cj, ct)
    assert t_ops.launches["rwkv6_scan_plain"] == cfg_t.num_layers


def test_prefill_decode_consistency():
    """The port of ``tests/test_archs.py::test_prefill_decode_consistency``
    for rwkv6: decode(t=S) after prefill(S) == prefill(S+1)'s last
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
    row's tm_x, tm_s and cm_x stay bit for bit, across several steps."""
    _, _, cfg_t, pt = models
    tok = np.random.default_rng(2).integers(0, cfg_t.vocab_size,
                                            (3, 8)).astype(np.int32)
    cache = t_zoo.init_cache(cfg_t, 3, 32, "cpu")
    act = torch.tensor([True, False, True])
    with torch.no_grad():
        t_zoo.prefill(cfg_t, pt, {"tokens": torch.from_numpy(tok)}, cache)
        before = {k: v.clone() for k, v in cache.items()}
        for step in range(3):
            t_zoo.decode(cfg_t, pt, cache, torch.tensor([1, 2, 3]) + step,
                         torch.full((3,), 8 + step, dtype=torch.int32), act)
    assert sorted(cache) == sorted(STATE)
    for k in cache:
        assert torch.equal(cache[k][:, 1], before[k][:, 1]), k
        assert not torch.equal(cache[k][:, 0], before[k][:, 0]), k


# ---------------------------------------------------------------- Endpoint


def _row_state(ep, slot):
    return {k: v[:, slot].clone() for k, v in ep.cache.items()}


@hypothesis.settings(max_examples=3, deadline=None, database=None)
@hypothesis.given(seed=st.integers(0, 10_000))
def test_endpoint_stream_matches_reference(models, seed):
    """A random admit / decode / retire stream (the loop of the hymba
    file's stream test) gives the same token ids and slot positions at
    every step; now and then one live row sits out a step, and its state
    must not move."""
    cfg_j, pj, cfg_t, pt = models
    rng = np.random.default_rng(seed)
    slots, max_len = 3, 40
    ref = JEndpoint(cfg_j, pj, slots=slots, max_len=max_len)
    port = TEndpoint(cfg_t, pt, slots=slots, max_len=max_len, device="cpu")
    active = {}                       # slot -> [remaining, last_token]
    parked = 0
    for _ in range(28):
        if len(active) < slots and rng.uniform() < 0.5:
            L = int(rng.choice([5, 20, 32]))
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


def test_cache_nbytes_per_row_matches_reference(models):
    """A row's state has no length axis: its logical bytes equal the
    reference's to the byte and do not grow with the position (the
    smoke config: 2 layers x (4x16x16 fp32 tm_s + 2x64 fp32 tm_x, cm_x))."""
    cfg_j, pj, cfg_t, pt = models
    ref = JEndpoint(cfg_j, pj, slots=2, max_len=32)
    port = TEndpoint(cfg_t, pt, slots=2, max_len=32, device="cpu")
    want = 2 * (4 * 16 * 16 * 4 + 2 * 64 * 4)
    for length in (0, 1, 7, 16, 17, 31, 32, 40, 1000):
        assert port.cache_nbytes_per_row(length) == \
            ref.cache_nbytes_per_row(length) == want, length
    full = t_configs.get_config(ARCH)
    meta = t_zoo.init_cache(full, 1, 2048, "meta")
    assert sum(l.numel() * l.element_size() for l in meta.values()) == \
        34_078_720


def _serve(ep, prompt, steps):
    """Greedy stream of one request served alone: [first, next...]."""
    slot = ep.try_claim()
    out = [ep.prefill_batch({slot: prompt})[slot]]
    for _ in range(steps):
        out.append(ep.decode_all({slot: out[-1]})[slot])
    ep.release(slot)
    return out


def test_extract_insert_resumes_the_unmigrated_stream(models):
    """The mirror of ``tests/test_migration.py``'s roundtrip for rwkv6:
    decode 4 steps on one endpoint, move the row's state into another
    pool beside a busy neighbour, decode on: the stream equals the
    unmigrated one, the port's and the reference's."""
    cfg_j, pj, cfg_t, pt = models
    prompt = np.arange(6, dtype=np.int32)
    solo = _serve(TEndpoint(cfg_t, pt, slots=2, max_len=64, device="cpu"),
                  prompt, 9)
    assert solo == _serve(JEndpoint(cfg_j, pj, slots=2, max_len=64), prompt,
                          9)
    src = TEndpoint(cfg_t, pt, slots=2, max_len=64, device="cpu")
    dst = TEndpoint(cfg_t, pt, slots=4, max_len=64, device="cpu")
    s = src.try_claim()
    got = [src.prefill_batch({s: prompt})[s]]
    for _ in range(4):
        got.append(src.decode_all({s: got[-1]})[s])
    [state] = src.extract_rows([s])
    assert sorted(state) == sorted(STATE)
    pos = int(src.slot_pos[s])
    src.release(s)
    other = dst.try_claim()
    first = dst.prefill_batch({other: np.arange(3, dtype=np.int32)})[other]
    d = dst.try_claim()
    dst.insert_rows([state], [d], [pos])
    nxt = {other: first, d: got[-1]}
    for _ in range(5):
        nxt = dst.decode_all(nxt)
        got.append(nxt[d])
    assert got == solo


def test_slot_reuse_is_stateless_and_mixed_wave_is_serial(models):
    """The mirrors of ``tests/test_policy_control.py``'s recurrent-slot
    tests: reusing a slot leaks no state of its last request, and a wave
    of two prompt lengths (two prefill groups) equals serving each
    alone.  The smoke config has num_layers == slots == 2, so this also
    pins the slot axis of every state leaf."""
    _, _, cfg_t, pt = models
    ep = TEndpoint(cfg_t, pt, slots=2, max_len=32, device="cpu")
    a = np.arange(3, 9, dtype=np.int32)
    b = np.arange(20, 26, dtype=np.int32)
    first = _serve(ep, a, 3)
    _serve(ep, b, 3)                       # pollute the slot
    assert _serve(ep, a, 3) == first

    short = np.arange(2, 6, dtype=np.int32)
    long = np.arange(7, 15, dtype=np.int32)
    s0, s1 = ep.try_claim(), ep.try_claim()
    t_ops.reset_launches()
    firsts = ep.prefill_batch({s0: short, s1: long})
    assert t_ops.launches["rwkv6_scan_plain"] == 2 * cfg_t.num_layers
    streams = {s0: [firsts[s0]], s1: [firsts[s1]]}
    tk = dict(firsts)
    for _ in range(3):
        tk = ep.decode_all(tk)
        for s in (s0, s1):
            streams[s].append(tk[s])
    ep.release(s0)
    ep.release(s1)
    assert streams[s0] == _serve(ep, short, 3)
    assert streams[s1] == _serve(ep, long, 3)


def test_paged_endpoint_raises_in_both_packages(models):
    """rwkv6 has no full-context leaf to page: both packages refuse a
    paged endpoint with the reference's ValueError."""
    cfg_j, pj, cfg_t, pt = models
    msg = "model family 'rwkv6' has no pageable cache leaves"
    with pytest.raises(ValueError, match=msg):
        JEndpoint(cfg_j, pj, slots=2, max_len=32, paged=True)
    with pytest.raises(ValueError, match=msg):
        TEndpoint(cfg_t, pt, slots=2, max_len=32, device="cpu", paged=True)


def test_prompt_length_rule_of_the_wkv_scan(models):
    """A 160-token prompt is refused by the port's endpoint, as by the
    reference's kernel path (``use_pallas=True``)."""
    cfg_j, pj, cfg_t, pt = models
    toks = np.arange(160, dtype=np.int32) % cfg_t.vocab_size
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
            L = int(rng.choice([4, 18, 32]))
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
    """The continuum over rwkv6 smoke: per-tick, per-tier served counts
    and every request's token ids equal the reference's."""
    cfg_j, pj, cfg_t, pt = models
    ref = j_platform.Continuum(
        edge=j_platform.TierConfig(slots=2, max_len=40),
        cloud=j_platform.TierConfig(slots=4, max_len=40,
                                    extra_latency_s=0.02),
        policy=policy, seed=0)
    ref._model = (cfg_j, pj)
    port = t_platform.Continuum(
        edge=t_platform.TierConfig(slots=2, max_len=40),
        cloud=t_platform.TierConfig(slots=4, max_len=40,
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
