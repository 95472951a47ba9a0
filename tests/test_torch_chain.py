"""The live 3-tier device -> edge -> cloud chain against the reference,
on the CPU, at smoke width.

A ``Topology.device_edge_cloud``-shaped chain (links 5 ms / 50 MB/s and
40 ms / 100 MB/s, waterfall spill on), dense and with a paged edge,
serves the same request streams in both packages over the same float32
weights.  Held exactly: every request's output ids and failure, and every
per-tick record (R_t, served per tier, spilled, waves, steps, backlog,
rejected, link MB, replicas).

* Under split 0 routing draws nothing, so the streams match as they are;
  one case pins the device tier to zero replicas so every arrival
  spills down the chain.
* Under ``"auto"`` and ``"auto+net"`` fed through ``trace=``, R_t
  follows request latencies, which the runtime reads off the wall clock.
  The test gives both packages a clock that advances only with model
  calls (``prefill_batch`` / ``decode_all``), so latencies are a function
  of the schedule, and feeds the port's router the uniforms the
  reference's ``jax.random`` key chain draws (routing functions take
  their draws as arguments).  Everything else runs unchanged.

The reference's jitted endpoint programs are blocked before they return,
as in ``tests/test_torch_paged.py`` (its paged ``decode_all`` otherwise
races its page write-back).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro import platform as j_platform
from repro.core import topology as j_topo
from repro.core.replication import AutoscalingPolicy as JAutoscaling
from repro.core.replication import FunctionSpec as JFunctionSpec
from repro.models import model_zoo as j_zoo
from repro.serving import tiers as j_tiers
from repro.serving.engine import Endpoint as JEndpoint
from repro.workloads import trace as j_trace
from repro_torch import bridge
from repro_torch import configs as t_configs
from repro_torch import platform as t_platform
from repro_torch.core import policy as t_policy
from repro_torch.core import router as t_router
from repro_torch.core import topology as t_topo
from repro_torch.core.replication import AutoscalingPolicy as TAutoscaling
from repro_torch.serving import tiers as t_tiers
from repro_torch.serving.engine import Endpoint as TEndpoint
from repro_torch.workloads import faults as t_faults
from repro_torch.workloads import trace as t_trace

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ARCH = "stablelm-1.6b"
RECORD_KEYS = ("R", "edge", "cloud", "tiers", "spilled", "waves", "steps",
               "link_MB", "backlog", "rejected", "replicas")


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
    """Block every jitted program of a reference endpoint before it
    returns (the reference's code is unchanged)."""
    init = JEndpoint.__init__

    def __init__(self, *args, **kwargs):
        init(self, *args, **kwargs)
        for name, fn in list(vars(self).items()):
            if callable(fn) and hasattr(fn, "lower"):
                setattr(self, name, _blocking(fn))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JEndpoint, "__init__", __init__)
        yield


def _chain(mod, asc_mod, paged, pin_device=False):
    """device (2 slots, depth 4) -> edge (4 slots, depth 8; paged: page
    8, 10 pages, the KV of 2.5 rows) -> cloud (6 slots, unbounded)."""
    edge_kw = dict(page_size=8, pool_pages=10) if paged else {}
    return mod.Topology(
        (mod.TierSpec("device", slots=2, max_len=32, queue_depth_per_slot=4,
                      autoscaling=(asc_mod(max_scale=0) if pin_device
                                   else None)),
         mod.TierSpec("edge", slots=4, max_len=32, queue_depth_per_slot=8,
                      **edge_kw),
         mod.TierSpec("cloud", slots=6, max_len=32, extra_latency_s=0.02,
                      queue_depth_per_slot=None)),
        (mod.LinkSpec(rtt_s=0.005, bandwidth_Bps=50e6),
         mod.LinkSpec(rtt_s=0.04, bandwidth_Bps=100e6)),
        waterfall=True)


class _StepClock:
    """A ``time`` stand-in whose clock moves only with model calls."""

    def __init__(self):
        self.now = 100.0

    def perf_counter(self):
        return self.now

    def sleep(self, s):
        self.now += s


def _advancing(fn, clock, dt):
    def call(*a, **kw):
        out = fn(*a, **kw)
        clock.now += dt
        return out
    return call


class _ReferenceDraws:
    """The port's routing generator replaced by the reference's
    ``jax.random`` key chain: per routed batch the reference splits once
    for routing and once for hedging, pads the batch to a power of two
    and the distribution with a void function row."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def route(self, dist, fn_ids, num_functions):
        self.key, sub = jax.random.split(self.key)
        self.key, _ = jax.random.split(self.key)
        B, N = len(fn_ids), dist.shape[1]
        Bp = max(1, 1 << (B - 1).bit_length())
        ids = np.full(Bp, num_functions, np.int32)
        ids[:B] = fn_ids
        distp = np.zeros((num_functions + 1, N), np.float32)
        distp[:num_functions] = dist
        distp[num_functions, 0] = 100.0
        extra_u = np.array(jax.random.uniform(sub, (num_functions + 1, N)))
        noise = np.array(jax.random.uniform(jax.random.fold_in(sub, 1),
                                            (Bp,)))
        return t_router.route_tiers(
            torch.from_numpy(distp), torch.from_numpy(ids),
            torch.from_numpy(extra_u), torch.from_numpy(noise)).numpy()[:B]


@pytest.fixture
def deterministic_clock(monkeypatch):
    """Both packages' serving clocks advance with model calls alone, and
    the port routes with the reference's draws."""
    clocks = {}
    for name, tiers, ep in (("ref", j_tiers, JEndpoint),
                            ("port", t_tiers, TEndpoint)):
        clock = clocks[name] = _StepClock()
        monkeypatch.setattr(tiers, "time", clock)
        monkeypatch.setattr(ep, "prefill_batch",
                            _advancing(ep.prefill_batch, clock, 0.05))
        monkeypatch.setattr(ep, "decode_all",
                            _advancing(ep.decode_all, clock, 0.01))

    def route_tiers(self, rng, dist, fn_ids, num_functions):
        if len(fn_ids) == 0:
            return np.zeros(0, np.int32)
        return rng.route(dist, fn_ids, num_functions)
    monkeypatch.setattr(t_policy.Policy, "route_tiers", route_tiers)
    return clocks


def _stream(seed, rounds=5):
    """Per round: a burst of requests (lengths 3-12, 1-5 new tokens)."""
    rng = np.random.default_rng(seed)
    out = []
    for rnd in range(rounds):
        for _ in range(3 + 3 * rnd):
            L = int(rng.integers(3, 13))
            out.append((rnd, rng.integers(0, 64, L).astype(np.int32),
                        int(rng.integers(1, 6))))
    return out


def _serve(cc, model, spec_cls, req_cls, stream, rounds):
    cc.deploy(spec_cls(name="fn", arch=ARCH), *model)
    reqs = {}
    for rnd in range(rounds):
        for r_, toks, need in stream:
            if r_ == rnd:
                r = req_cls(rid=len(reqs), tokens=toks.copy(), max_new=need)
                reqs[r.rid] = r
                cc.submit("fn", r)
        cc.tick()
    cc.drain()
    return reqs


def _same_records(port, ref):
    assert len(port.log) == len(ref.log)
    for i, (a, b) in enumerate(zip(port.log, ref.log)):
        for k in RECORD_KEYS:
            assert a[k] == b[k], (i, k, a[k], b[k])


def _same_outputs(rj, rt):
    assert sorted(rj) == sorted(rt)
    for rid in rj:
        assert rj[rid].failed == rt[rid].failed, rid
        if rj[rid].output is None:
            assert rt[rid].output is None, rid
        else:
            np.testing.assert_array_equal(rt[rid].output, rj[rid].output,
                                          err_msg=f"request {rid}")


def _conserved(port, reqs):
    assert port.queued == 0 and port.in_flight == 0
    served = sum(sum(rec["tiers"].values()) for rec in port.log)
    failed = sum(r.failed for r in reqs.values())
    assert served + failed == len(reqs)
    assert all(len(r.output) == r.max_new
               for r in reqs.values() if not r.failed)


@pytest.mark.parametrize("paged,pin_device", [(False, False), (True, False),
                                              (False, True), (True, True)])
def test_chain_split_zero_matches_reference(paged, pin_device):
    cfg_j, pj, cfg_t, pt = _models()
    ref = j_platform.Continuum.from_topology(
        _chain(j_topo, JAutoscaling, paged, pin_device), policy="0", seed=1)
    port = t_platform.Continuum.from_topology(
        _chain(t_topo, TAutoscaling, paged, pin_device), policy="0", seed=1,
        device="cpu")
    stream = _stream(seed=3 + paged + 2 * pin_device)
    rj = _serve(ref, (cfg_j, pj), JFunctionSpec, j_platform.Request,
                stream, 5)
    rt = _serve(port, (cfg_t, pt), t_platform.FunctionSpec,
                t_platform.Request, stream, 5)
    _same_outputs(rj, rt)
    _same_records(port, ref)
    _conserved(port, rt)
    assert sum(rec["rejected"] for rec in port.log) > 0
    if pin_device:
        assert sum(rec["spilled"] for rec in port.log) > 0
        assert sum(rec["tiers"]["device"] for rec in port.log) == 0
        assert sum(rec["link_MB"][0] for rec in port.log) > 0
    assert port.edge.endpoints["fn"].params is port.cloud.endpoints[
        "fn"].params


def _bursty(mod, seed):
    tr = mod.Trace.bursty(base_rps=3.0, burst_rps=20.0, duration_s=10.0,
                          mean_on_s=3.0, mean_off_s=2.0, seed=seed)
    rng = np.random.default_rng(seed)
    tr.prompt_len[:] = rng.integers(3, 13, len(tr))
    tr.max_new[:] = rng.integers(1, 7, len(tr))
    return tr


@pytest.mark.parametrize("policy,paged", [("auto", False), ("auto", True),
                                          ("auto+net", False)])
def test_chain_trace_driven_auto_matches_reference(deterministic_clock,
                                                   policy, paged):
    cfg_j, pj, cfg_t, pt = _models()
    kw = dict(policy=policy, seed=2, trace_vocab=64, req_bytes=4.0e3)
    ref = j_platform.Continuum.from_topology(
        _chain(j_topo, JAutoscaling, paged), trace=_bursty(j_trace, 4), **kw)
    port = t_platform.Continuum.from_topology(
        _chain(t_topo, TAutoscaling, paged), trace=_bursty(t_trace, 4),
        device="cpu", **kw)
    port.rng = _ReferenceDraws(2)
    for cc, model, spec in ((ref, (cfg_j, pj), JFunctionSpec),
                            (port, (cfg_t, pt), t_platform.FunctionSpec)):
        cc.deploy(spec(name="fn", arch=ARCH), *model)
        for _ in range(int(np.ceil(cc.trace.duration_s))):
            cc.tick()
        cc.drain()
    rj = {r.rid: r for r in ref.trace_requests}
    rt = {r.rid: r for r in port.trace_requests}
    assert len(rt) == len(_bursty(t_trace, 4))
    for a, b in zip(port.trace_requests, ref.trace_requests):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    _same_outputs(rj, rt)
    _same_records(port, ref)
    _conserved(port, rt)
    # the controller engaged, and the requests it pushed down crossed
    assert max(rec["R"] for rec in port.log) > 0
    assert sum(rec["tiers"]["device"] for rec in port.log) < len(rt)


def test_chain_net_aware_boundaries_parse_like_reference():
    """Each boundary parses ``"auto+net"`` against its own link's
    bandwidth and the ``req_bytes`` hint."""
    cfg_j, pj, cfg_t, pt = _models()
    ref = j_platform.Continuum.from_topology(
        j_topo.Topology.device_edge_cloud(max_len=32), policy="auto+net",
        req_bytes=6.0e6)
    port = t_platform.Continuum.from_topology(
        t_topo.Topology.device_edge_cloud(max_len=32), policy="auto+net",
        req_bytes=6.0e6, device="cpu")
    ref.deploy(JFunctionSpec(name="fn", arch=ARCH), cfg_j, pj)
    port.deploy(t_platform.FunctionSpec(name="fn", arch=ARCH), cfg_t, pt)
    assert len(port.control.policies) == len(ref.control.policies) == 2
    for a, b in zip(port.control.policies, ref.control.policies):
        assert type(a).__name__ == type(b).__name__ == "NetAwareOffload"
        assert a.spec == b.spec
        for f in ("net_aware", "link_bytes_per_s", "req_bytes"):
            assert getattr(a.cfg, f) == getattr(b.cfg, f), f
    assert [p.cfg.link_bytes_per_s for p in port.control.policies] == [
        50e6, 100e6]


def test_live_runtime_refuses_what_is_not_ported():
    """Hedging, migration, live faults and the sketch front end are
    ported (their own files hold them); a bad ``eq1``, ``trace_prompts``
    or ``scheduler`` and a missing card still raise."""
    topo = t_topo.Topology.device_edge_cloud(max_len=32)
    for spec in ("auto+hedge", "auto+migrate", "auto+net+hedge+migrate"):
        cc = t_platform.Continuum.from_topology(topo, policy=spec,
                                                device="cpu")
        assert cc.policy.spec == spec
    cc = t_platform.Continuum.from_topology(
        topo, device="cpu", faults=t_faults.edge_brownout(1.0, 2.0))
    assert cc.faults is not None and cc.link_state[0].up
    cc = t_platform.Continuum.from_topology(topo, device="cpu",
                                            eq1="sketch")
    assert cc.eq1 == "sketch"
    with pytest.raises(ValueError, match="eq1"):
        t_platform.Continuum.from_topology(topo, device="cpu", eq1="exact")
    with pytest.raises(ValueError, match="trace_prompts"):
        t_platform.Continuum.from_topology(topo, device="cpu",
                                           trace_prompts="zipf")
    with pytest.raises(ValueError, match="scheduler"):
        t_platform.Continuum.from_topology(topo, device="cpu",
                                           scheduler="batch")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            t_platform.Continuum.from_topology(topo)


def test_trace_prompts_per_function_match_reference():
    """``trace_prompts="per_fn"``: a function's prompt is fixed by its
    name and length, identically in both packages."""
    cfg_j, pj, cfg_t, pt = _models()
    kw = dict(policy="0", trace_vocab=64, trace_prompts="per_fn")
    ref = j_platform.Continuum.from_topology(
        _chain(j_topo, JAutoscaling, False), trace=_bursty(j_trace, 5), **kw)
    port = t_platform.Continuum.from_topology(
        _chain(t_topo, TAutoscaling, False), trace=_bursty(t_trace, 5),
        device="cpu", **kw)
    ref.deploy(JFunctionSpec(name="fn", arch=ARCH), cfg_j, pj)
    port.deploy(t_platform.FunctionSpec(name="fn", arch=ARCH), cfg_t, pt)
    assert port._ingest_trace() == ref._ingest_trace() > 0
    for a, b in zip(port.trace_requests, ref.trace_requests):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert a.max_new == b.max_new
