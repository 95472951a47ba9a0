"""The port's tensor-parallel endpoint against the reference, on the CPU.

Mirrors ``tests/test_sharded_tier.py``'s parity checks.  The reference
pins its weight-gather TP bit for bit against its unsharded engine on
two forced host devices; here a sharded port endpoint runs over
``forced_devices(n)`` (n shards on the one CPU) and is held to:

* ``validate_tp``'s refusals, message for message;
* the partition specs of every dense config, equal to the reference's
  ``AxisRules.spec`` (whose rule tables read only a mesh's
  ``axis_names`` and ``shape``, so a plain object stands in for a
  ``jax`` mesh of 256 devices);
* the token ids of the reference's unsharded stream, exactly, and the
  port's unsharded logits within the float32 tolerance of the
  reference's kernel tests.  At these widths (contractions of 64) torch's
  CPU products give the column slices the same sums as the whole, so
  the logits are bitwise equal too, save one case the test names; at
  the full widths they are not (ROADMAP §3);
* mesh-invariant row bytes, ``compatible_with`` by tp, the paged
  refusal, migration between two sharded tiers, and a costed chain
  whose (1, 2) edge deploys sharded.
"""

import dataclasses
import functools
import warnings

import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.launch import sharding as j_lsh
from repro.models import model_zoo as j_zoo
from repro.serving import sharded as j_sharded
from repro.serving.engine import Endpoint as JEndpoint
from repro_torch import configs as t_configs
from repro_torch import platform as t_platform
from repro_torch.core import topology as t_topo
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import sharding as t_lsh
from repro_torch.models import model_zoo as t_zoo
from repro_torch.serving import sharded as t_sharded
from repro_torch.serving import tiers as t_tiers
from repro_torch.serving.engine import Endpoint as TEndpoint
from test_torch_chain import _advancing, _StepClock
from torch_live import models

ATOL, RTOL = 2e-5, 2e-4          # tests/test_kernels.py's float32 tolerance

DENSE = [a for a in t_configs.ARCHS
         if t_configs.get_config(a).family == "dense"]

#: (arch, tp) of the sharded endpoints held against the reference
CASES = [("stablelm-1.6b", 2), ("stablelm-1.6b", 4), ("qwen2.5-14b", 2)]


def _mesh(tp: int) -> t_mesh.Mesh:
    return t_mesh.make_mesh((1, tp), ("data", "model"),
                            t_mesh.host_devices("cpu"))


def _sharded(cfg, params, tp, **kw) -> TEndpoint:
    with t_mesh.forced_devices(tp):
        return TEndpoint(cfg, params, device="cpu", mesh=_mesh(tp), **kw)


def _prompts(vocab):
    """``tests/test_sharded_tier.py``'s prompts: 5, 6 and 7 tokens."""
    rng = np.random.RandomState(7)
    return {s: rng.randint(0, vocab, size=(5 + s,)).astype(np.int32)
            for s in range(3)}


def _stream(ep, steps=6):
    """Its prompts prefilled into 3 of 4 slots, then ``steps`` decode
    steps: the ids of every slot."""
    prompts = _prompts(ep.cfg.vocab_size)
    for _ in prompts:
        ep.try_claim()
    cur = ep.prefill_batch(prompts)
    out = {s: [int(v)] for s, v in cur.items()}
    for _ in range(steps):
        cur = ep.decode_all(cur)
        for s, v in cur.items():
            out[s].append(int(v))
    return out


@functools.lru_cache(maxsize=None)
def _reference_stream(arch):
    cfg_j, pj, _, _ = models(arch)
    return _stream(JEndpoint(cfg_j, pj, slots=4, max_len=32))


# ---- validate_tp ------------------------------------------------------------


@pytest.mark.parametrize("field,value", [
    ("family", "hymba"), ("tie_embeddings", True), ("num_heads", 6),
    ("num_kv_heads", 6), ("d_ff", 130), ("vocab_size", 258),
    ("d_model", 66)])
def test_validate_tp_refusals_match_reference(field, value):
    cfg_j = dataclasses.replace(j_configs.get_smoke_config("stablelm-1.6b"),
                                **{field: value})
    cfg_t = dataclasses.replace(t_configs.get_smoke_config("stablelm-1.6b"),
                                **{field: value})
    with pytest.raises(ValueError) as want:
        j_sharded.validate_tp(cfg_j, 4)
    with pytest.raises(ValueError) as got:
        t_sharded.validate_tp(cfg_t, 4)
    assert str(got.value) == str(want.value)
    t_sharded.validate_tp(cfg_t, 1)            # tp 1 serves anything


# ---- partition specs ----------------------------------------------------------


class _AxesOnly:
    """What the rule tables read of a mesh: its axis names and sizes."""

    def __init__(self, shape):
        self.axis_names = ("data", "model")
        self.shape = dict(zip(self.axis_names, shape))


@pytest.mark.parametrize("mode", ["serve_replicated", "serve"])
@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (16, 16)])
@pytest.mark.parametrize("arch", DENSE)
def test_param_specs_match_reference(arch, shape, mode):
    mesh = _AxesOnly(shape)
    rules = j_lsh.param_rules(mesh, mode)
    want = {path: tuple(rules.spec(s.axes, s.shape))
            for path, s in j_zoo.param_table(
                j_configs.get_config(arch)).items()}
    cfg = t_configs.get_config(arch)
    got = t_lsh.param_shardings(cfg, mesh, mode)
    assert got == want
    if mode == "serve_replicated":
        assert t_sharded.tp_param_specs(cfg, mesh) == want
    assert any(spec for spec in got.values())     # something is sharded


def test_cache_specs_shard_kv_heads():
    cache = t_zoo.init_cache(t_configs.get_smoke_config("stablelm-1.6b"),
                             2, 16, "meta")
    assert t_sharded.tp_cache_specs(cache) == {
        "k": (None, None, None, "model", None),
        "v": (None, None, None, "model", None), "pos": ()}


def test_mesh_records():
    assert t_mesh.host_devices("cpu") == [torch.device("cpu")]
    with t_mesh.forced_devices(4):
        assert t_mesh.host_devices("cpu") == [torch.device("cpu")] * 4
        mesh = t_mesh.make_mesh((2, 2), ("data", "model"),
                                t_mesh.host_devices("cpu"))
        assert mesh.shape == {"data": 2, "model": 2}
        assert mesh.devices.shape == (2, 2)
        assert len(t_sharded.model_devices(mesh)) == 2
        with pytest.raises(ValueError, match="needs 256 devices"):
            t_mesh.make_production_mesh(devices=t_mesh.host_devices("cpu"))
    assert t_mesh.host_devices("cpu") == [torch.device("cpu")]
    local = t_mesh.make_local_mesh(t_mesh.host_devices("cpu"))
    assert local.axis_names == ("data", "model")
    assert local.devices.shape == (1, 1)
    with pytest.warns(UserWarning, match="deploying unsharded"):
        assert t_sharded.tier_mesh((1, 2), "cpu") is None
    with t_mesh.forced_devices(2):
        assert t_sharded.tier_mesh((1, 2), "cpu").shape["model"] == 2


# ---- the sharded endpoint ------------------------------------------------------


@pytest.mark.parametrize("arch,tp", CASES)
def test_sharded_stream_equals_reference(arch, tp):
    _, _, cfg, params = models(arch)
    dense = TEndpoint(cfg, params, slots=4, max_len=32, device="cpu")
    ep = _sharded(cfg, params, tp, slots=4, max_len=32)
    assert ep._tp == tp and len(ep.params) == len(ep.cache) == tp
    want = _reference_stream(arch)
    assert _stream(dense) == want
    assert _stream(ep) == want
    # a row's bytes are its logical bytes, whatever the mesh
    assert ep.cache_nbytes_per_row(16) == dense.cache_nbytes_per_row(16) > 0
    assert ep.pool_nbytes == dense.pool_nbytes


@pytest.mark.parametrize("arch,tp", CASES)
def test_tp_functions_match_unsharded_logits(arch, tp):
    """Prefill and one decode step of the raw TP functions against the
    unsharded ones: within tolerance, and bitwise except stablelm's
    decode at tp 4, where a shard holds one kv head of one query head
    and the plain attention's einsum takes another contraction path for
    it (a last-bit difference)."""
    _, _, cfg, params = models(arch)
    cache = t_zoo.init_cache(cfg, 2, 32, "cpu")
    with t_mesh.forced_devices(tp):
        mesh = _mesh(tp)
        prefill, decode, pspecs, cspecs = t_sharded.make_tp_functions(
            cfg, mesh, cache)
        shards = t_sharded.shard_params(params, mesh, pspecs)
        caches = t_sharded.shard_cache(cache, mesh, cspecs)
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, size=(2, 8)).astype(np.int32))
    lengths = torch.tensor([8, 5], dtype=torch.int32)
    got, caches = prefill(shards, toks, lengths, caches)
    want, cache = t_zoo.prefill(cfg, params, {"tokens": toks}, cache,
                                lengths=lengths)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    assert torch.equal(got, want)              # bitwise at these widths
    # the shards' caches are the unsharded cache, kv heads split
    for name in cache:
        whole = torch.cat([c[name] for c in caches], dim=3) \
            if name != "pos" else caches[0][name]
        torch.testing.assert_close(whole, cache[name], atol=ATOL, rtol=RTOL)
    tok = got.argmax(-1).to(torch.int32)
    t = lengths.clone()
    active = torch.tensor([True, False])
    before = [{k: v[:, 1].clone() for k, v in c.items()} for c in caches]
    got, _ = decode(shards, caches, tok, t, active)
    want, _ = t_zoo.decode(cfg, params, cache, tok, t, active)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    if (arch, tp) != ("stablelm-1.6b", 4):
        assert torch.equal(got, want)
    # every shard wrote the active row and left the inactive one as it was
    for c, b in zip(caches, before):
        assert bool((c["pos"][:, 0, 8] == 8).all())
        for k in c:
            assert torch.equal(c[k][:, 1], b[k])


def test_compatibility_and_paged_refusal():
    _, _, cfg, params = models()
    dense = TEndpoint(cfg, params, slots=2, max_len=32, device="cpu")
    tp2 = _sharded(cfg, params, 2, slots=2, max_len=32)
    tp2b = _sharded(cfg, params, 2, slots=3, max_len=32)
    assert tp2.compatible_with(tp2b) and tp2b.compatible_with(tp2)
    assert not tp2.compatible_with(dense) and not dense.compatible_with(tp2)
    with pytest.raises(ValueError, match="paged=True is not supported"):
        _sharded(cfg, params, 2, slots=2, max_len=32, paged=True)
    with pytest.raises(ValueError, match="num_kv_heads divisible by tp=4"):
        _sharded(t_configs.get_smoke_config("qwen2.5-14b"),
                 models("qwen2.5-14b")[3], 4, slots=2, max_len=32)


# ---- tiers ----------------------------------------------------------------------


def _edge_spec(slots=3):
    return t_topo.Topology.costed(
        (t_topo.TierSpec("edge", slots=slots, max_len=32,
                         model="qwen2.5-14b", mesh_shape=(1, 2)),)).tiers[0]


def test_tier_deploys_sharded_or_warns():
    _, _, cfg, params = models()
    with pytest.warns(UserWarning, match="deploying unsharded"):
        tier = t_tiers.Tier("edge", _edge_spec(), "cpu")
        tier.deploy("fn", cfg, params)
    assert tier.endpoints["fn"]._tp == 1
    with t_mesh.forced_devices(2), warnings.catch_warnings():
        warnings.simplefilter("error")
        tier = t_tiers.Tier("edge", _edge_spec(), "cpu")
        tier.deploy("fn", cfg, params)
    ep = tier.endpoints["fn"]
    assert ep._tp == 2 and ep.slots == 3 and len(ep.params) == 2


def test_row_migrated_between_sharded_tiers():
    """A row extracted from one tp-2 tier after 3 steps and inserted into
    another decodes on to the unmigrated ids; the row it ships is the
    unsharded endpoint's row."""
    _, _, cfg, params = models()
    with t_mesh.forced_devices(2):
        src, dst, solo = (t_tiers.Tier(n, _edge_spec(), "cpu")
                          for n in ("a", "b", "c"))
        for tier in (src, dst, solo):
            tier.deploy("fn", cfg, params)
    src, dst, solo = (t.endpoints["fn"] for t in (src, dst, solo))
    dense = TEndpoint(cfg, params, slots=3, max_len=32, device="cpu")
    prompt = _prompts(cfg.vocab_size)[2]

    def start(ep):
        slot = ep.try_claim()
        tok = ep.prefill_batch({slot: prompt})[slot]
        ids = [tok]
        for _ in range(3):
            tok = ep.decode_all({slot: tok})[slot]
            ids.append(tok)
        return slot, ids

    def finish(ep, slot, ids, steps=5):
        for _ in range(steps):
            ids.append(ep.decode_all({slot: ids[-1]})[slot])
        return ids

    s0, moved = start(src)
    d0, unsharded = start(dense)
    row, = src.extract_rows([s0])
    want, = dense.extract_rows([d0])
    assert {k: v.shape for k, v in row.items()} == {
        k: v.shape for k, v in want.items()}
    for k in row:
        torch.testing.assert_close(row[k], want[k], atol=ATOL, rtol=RTOL)
    assert dst.compatible_with(src)
    slot = dst.try_claim()
    dst.insert_rows([row], [slot], [int(src.slot_pos[s0])])
    src.release(s0)
    moved = finish(dst, slot, moved)
    s1, stay = start(solo)
    assert moved == finish(solo, s1, stay) == finish(dense, d0, unsharded)


@pytest.fixture
def step_clock(monkeypatch):
    """The port's serving clock advances with model calls alone."""
    clock = _StepClock()
    monkeypatch.setattr(t_tiers, "time", clock)
    monkeypatch.setattr(TEndpoint, "prefill_batch",
                        _advancing(TEndpoint.prefill_batch, clock, 0.05))
    monkeypatch.setattr(TEndpoint, "decode_all",
                        _advancing(TEndpoint.decode_all, clock, 0.01))
    return clock


def _costed_chain(clock, forced: int):
    """The costed device -> edge -> cloud chain served by stablelm's smoke
    model on a bursty trace, under ``forced_devices(forced)``: the
    requests, the per-tick records, and each tier's tp."""
    clock.now = 100.0
    _, _, cfg, params = models()
    tr = t_platform.Trace.bursty(base_rps=3.0, burst_rps=20.0,
                                 duration_s=8.0, mean_on_s=3.0,
                                 mean_off_s=2.0, seed=4)
    rng = np.random.default_rng(4)
    tr.prompt_len[:] = rng.integers(3, 13, len(tr))
    tr.max_new[:] = rng.integers(1, 7, len(tr))
    topo = t_topo.Topology.device_edge_cloud(cost_model=True, max_len=32)
    with t_mesh.forced_devices(forced), \
            pytest.warns(UserWarning, match="deploying unsharded"):
        cc = t_platform.Continuum.from_topology(
            topo, policy="auto", seed=2, trace=tr, trace_vocab=64,
            device="cpu")
        cc.deploy(t_platform.FunctionSpec(name="fn", arch="stablelm-1.6b"),
                  cfg, params)
    for _ in range(int(np.ceil(tr.duration_s))):
        cc.tick()
    cc.drain()
    return (cc.trace_requests, cc.log,
            [t.endpoints["fn"]._tp for t in cc.tiers])


def test_costed_chain_sharded_equals_unsharded(step_clock):
    reqs1, log1, tps1 = _costed_chain(step_clock, 1)
    reqs2, log2, tps2 = _costed_chain(step_clock, 2)
    assert tps1 == [1, 1, 1] and tps2 == [1, 2, 1]
    assert [r.rid for r in reqs2] == [r.rid for r in reqs1]
    for a, b in zip(reqs2, reqs1):
        assert a.failed == b.failed, a.rid
        if b.output is None:
            assert a.output is None, a.rid
        else:
            np.testing.assert_array_equal(a.output, b.output)
        assert a.latency_s == b.latency_s, a.rid
    assert log2 == log1
    assert sum(rec["tiers"]["edge"] for rec in log2) > 0   # it served
