"""Shared harness of the live-control tests (``test_torch_migration``,
``test_torch_hedge``, ``test_torch_live_faults``,
``test_torch_scheduler``): one scenario driven through the reference's
live continuum and the port's, step for step, on the CPU at smoke width.

Both packages run on a clock that moves only with model calls (and with
``time.sleep``, which the migration landing waits on), and the port
routes with the reference's ``jax.random`` draws, as in
``tests/test_torch_chain.py``.  :meth:`Pair.check` then holds, exactly:
every request's output ids, ``failed`` flag and charged latency, every
per-tick record (all fields), the platform counters and the per-link
egress bytes.
"""

import functools

import jax
import numpy as np

from repro import configs as j_configs
from repro import platform as j_platform
from repro.core import policy as j_policy
from repro.core import topology as j_topo
from repro.core.replication import AutoscalingPolicy as JAutoscaling
from repro.core.replication import FunctionSpec as JFunctionSpec
from repro.models import model_zoo as j_zoo
from repro.serving import tiers as j_tiers
from repro.workloads import faults as j_faults
from repro_torch import bridge
from repro_torch import configs as t_configs
from repro_torch import platform as t_platform
from repro_torch.core import policy as t_policy
from repro_torch.core import topology as t_topo
from repro_torch.core.replication import AutoscalingPolicy as TAutoscaling
from repro_torch.core.replication import FunctionSpec as TFunctionSpec
from repro_torch.serving import tiers as t_tiers
from repro_torch.workloads import faults as t_faults
from test_torch_chain import _ReferenceDraws

#: each package's modules, in the order (reference, port)
PACKAGES = (
    dict(platform=j_platform, topo=j_topo, policy=j_policy, tiers=j_tiers,
         faults=j_faults, asc=JAutoscaling, spec=JFunctionSpec),
    dict(platform=t_platform, topo=t_topo, policy=t_policy, tiers=t_tiers,
         faults=t_faults, asc=TAutoscaling, spec=TFunctionSpec),
)


@functools.lru_cache(maxsize=None)
def models(arch="stablelm-1.6b"):
    """(reference cfg, params, port cfg, params): the same float32 smoke
    weights in both packages."""
    cfg_j = j_configs.get_smoke_config(arch)
    cfg_t = t_configs.get_smoke_config(arch)
    pj = j_zoo.init(jax.random.PRNGKey(0), cfg_j)
    pt = bridge.params_from_numpy({k: np.asarray(v) for k, v in pj.items()},
                                  cfg_t, "cpu")
    return cfg_j, pj, cfg_t, pt


def two_tier(m, edge=2, cloud=4, max_len=64, rtt=0.0, waterfall=False,
             edge_kw=None, cloud_kw=None):
    """An edge -> cloud pair over one link of ``rtt`` seconds."""
    return m["topo"].Topology(
        tiers=(m["topo"].TierSpec("edge", slots=edge, max_len=max_len,
                                  **(edge_kw or {})),
               m["topo"].TierSpec("cloud", slots=cloud, max_len=max_len,
                                  **(cloud_kw or {}))),
        links=(m["topo"].LinkSpec(rtt_s=rtt),), waterfall=waterfall)


def migrate_split(m, pct, thr=50.0):
    """A static split with a migration threshold (deterministic)."""
    class _Migrate(m["policy"].StaticSplit):
        def __init__(self):
            super().__init__(pct)
            self.migrate_threshold = thr
    return _Migrate()


def always_hedge(m, pct=0.0, thr=None, stay=False):
    """A static split that hedges every queued request; ``stay`` keeps
    every primary at the ingress while R_t = ``pct`` drives ``thr``."""
    class _Hedge(m["policy"].StaticSplit):
        def __init__(self):
            super().__init__(pct)
            self.migrate_threshold = thr

        def tier_distribution(self, R_all, num_tiers):
            if not stay:
                return super().tier_distribution(R_all, num_tiers)
            d = np.zeros((R_all.shape[1], num_tiers), np.float32)
            d[:, 0] = 100.0
            return d

        def hedge(self, *args):
            # the reference passes a key first; the port draws nothing
            return np.ones(len(args[-3]), bool)
    return _Hedge()


class Pair:
    """One scenario through the reference (``ref``) and the port
    (``port``).  ``topo(m)`` and ``policy(m)`` build each package's own
    objects; ``fns`` are deployed in order over ``arch``'s weights."""

    def __init__(self, topo, policy, arch="stablelm-1.6b", fns=("fn",),
                 **kw):
        cfg_j, pj, cfg_t, pt = models(arch)
        self.ccs = []
        for m, (cfg, params) in zip(PACKAGES, ((cfg_j, pj), (cfg_t, pt))):
            extra = {} if m is PACKAGES[0] else {"device": "cpu"}
            cc = m["platform"].Continuum.from_topology(
                topo(m), policy=policy(m), seed=0, **kw, **extra)
            for fn in fns:
                cc.deploy(m["spec"](name=fn, arch=arch), cfg, params)
            self.ccs.append(cc)
        self.ref, self.port = self.ccs
        self.port.rng = _ReferenceDraws(0)
        self.reqs = ({}, {})

    def _request(self, k, rid, tokens, max_new):
        r = PACKAGES[k]["platform"].Request(
            rid=rid, tokens=np.asarray(tokens, np.int32).copy(),
            max_new=max_new)
        self.reqs[k][rid] = r
        return r

    def submit(self, rid, tokens, max_new, fn="fn"):
        out = [cc.submit(fn, self._request(k, rid, tokens, max_new))
               for k, cc in enumerate(self.ccs)]
        assert out[0] == out[1]
        return out[1]

    def resident(self, rid, tokens, max_new, tier=0, fn="fn"):
        """Admit a request straight into a tier's slots, past routing
        (the deterministic way to pre-load a tier)."""
        for k, cc in enumerate(self.ccs):
            tiers = PACKAGES[k]["tiers"]
            item = tiers._Queued(fn, self._request(k, rid, tokens, max_new),
                                 t_submit=tiers.time.perf_counter())
            cc.tiers[tier].admit(fn, [item])

    def push(self, rid, tokens, max_new, tier, fn="fn"):
        """Queue a request straight at a tier's gateway."""
        for k, cc in enumerate(self.ccs):
            tiers = PACKAGES[k]["tiers"]
            item = tiers._Queued(fn, self._request(k, rid, tokens, max_new),
                                 t_submit=tiers.time.perf_counter())
            cc.gateways[tier].push(item, force=True)

    def fault(self, t, kind, target, **kw):
        for k, cc in enumerate(self.ccs):
            cc.apply_fault(PACKAGES[k]["faults"].FaultEvent(t, kind, target,
                                                            **kw))

    def tick(self, identities=True):
        recs = [cc.tick() for cc in self.ccs]
        assert recs[1] == recs[0], (recs[1], recs[0])
        if identities:
            self.identities()
        return recs[1]

    def drain(self):
        n = [cc.drain() for cc in self.ccs]
        assert n[0] == n[1]
        return n[1]

    def identities(self):
        """The hedge and migration accounting identities, in the port."""
        c = self.port.metrics.counter
        assert c("hedges_fired") == (c("hedges_won") + c("hedges_cancelled")
                                     + self.port.hedges_open)
        assert c("migrations_fired") == (c("migrations_completed")
                                         + c("migrations_aborted")
                                         + self.port.migrations_open)

    def check(self):
        """Everything the two runs produced, held equal."""
        ref, port = self.reqs
        assert sorted(port) == sorted(ref)
        for rid in ref:
            a, b = port[rid], ref[rid]
            assert a.failed == b.failed, rid
            if b.output is None:
                assert a.output is None, rid
            else:
                np.testing.assert_array_equal(a.output, b.output,
                                              err_msg=f"request {rid}")
            assert a.latency_s == b.latency_s, (rid, a.latency_s,
                                                b.latency_s)
        assert len(self.port.log) == len(self.ref.log)
        for i, (a, b) in enumerate(zip(self.port.log, self.ref.log)):
            assert a == b, (i, a, b)
        assert dict(self.port.metrics.counters) == dict(
            self.ref.metrics.counters)
        assert self.port.link_bytes == self.ref.link_bytes
        assert self.port.tier_up == self.ref.tier_up
        assert [t.metrics.latency_values().tolist() for t in self.port.tiers
                ] == [t.metrics.latency_values().tolist()
                      for t in self.ref.tiers]

    def served(self):
        return {t.name: sum(r["tiers"][t.name] for r in self.port.log)
                for t in self.port.tiers}
