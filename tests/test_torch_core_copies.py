"""The port's copies of the reference's JAX-free control-plane modules,
held against the originals on the same observation sequences, on the
CPU: ``core/metrics.py`` (the latency windows the controller and the
simulator scrape), ``core/autoscaler.py`` (the Knative KPA) and
``core/replication.py`` (the selective-field reconciler).  The port keeps
its own copies because it imports nothing of ``repro``; these tests are
what keeps them from drifting.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import autoscaler as j_asc
from repro.core import metrics as j_metrics
from repro.core import replication as j_repl
from repro_torch.core import autoscaler as t_asc
from repro_torch.core import metrics as t_metrics
from repro_torch.core import replication as t_repl


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_registry_matches_reference(seed):
    """record_latency / latency_windows / drain_fresh / counters over a
    random interleaving, windows wrapping the ring capacity."""
    rng = np.random.default_rng(seed)
    names = ["a", "b", "c"]
    ref = j_metrics.MetricsRegistry(names[:2], capacity=48)
    port = t_metrics.MetricsRegistry(names[:2], capacity=48)
    for step in range(400):
        op = rng.uniform()
        if step == 50:
            ref.register("c", capacity=48)
            port.register("c", capacity=48)
        live = names if step >= 50 else names[:2]
        if op < 0.6:
            fn = live[int(rng.integers(0, len(live)))]
            v = float(rng.lognormal(-2, 1))
            ref.record_latency(fn, v)
            port.record_latency(fn, v)
        elif op < 0.75:
            W = int(rng.choice([8, 32, 64]))
            lj, vj = ref.latency_windows(W)
            lt, vt = port.latency_windows(W)
            np.testing.assert_array_equal(lt, lj)
            np.testing.assert_array_equal(vt, vj)
        elif op < 0.85:
            ij, xj = ref.drain_fresh()
            it, xt = port.drain_fresh()
            np.testing.assert_array_equal(it, ij)
            np.testing.assert_array_equal(xt, xj)
        elif op < 0.95:
            ref.inc("rejected", 2.0)
            port.inc("rejected", 2.0)
            ref.set_gauge("depth", float(step))
            port.set_gauge("depth", float(step))
        else:
            ref.clear()
            port.clear()
        assert port.counter("rejected") == ref.counter("rejected")
    for fn in (None, "a", "c"):
        np.testing.assert_array_equal(port.latency_values(fn),
                                      ref.latency_values(fn))


@pytest.mark.parametrize("policy", [
    dict(), dict(min_scale=1, max_scale=3, target_concurrency=2.0),
    dict(max_scale=0), dict(panic_threshold=1.5, scale_to_zero_grace_s=5.0)])
def test_autoscaler_matches_reference(policy):
    """The KPA's observe / desired over a bursty concurrency sequence at
    scrape cadence: replicas and state after every scrape."""
    rng = np.random.default_rng(len(policy))
    ref = j_asc.Autoscaler(j_repl.AutoscalingPolicy(**policy),
                           stable_window_s=20.0, panic_window_s=4.0)
    port = t_asc.Autoscaler(t_repl.AutoscalingPolicy(**policy),
                            stable_window_s=20.0, panic_window_s=4.0)
    t = 0.0
    seen = set()
    for step in range(300):
        t += float(rng.choice([0.5, 1.0, 1.0, 3.0]))
        burst = (step // 40) % 2 == 1
        conc = float(rng.poisson(18.0 if burst else 1.5))
        if step % 90 > 75:
            conc = 0.0                     # idle stretches scale to zero
        ref.observe(t, conc)
        port.observe(t, conc)
        assert port.desired(t) == ref.desired(t), step
        assert port.replicas == ref.replicas
        seen.add(port.replicas)
        assert (dataclasses.asdict(port.state)
                == dataclasses.asdict(ref.state)), step
    # the sequence scales up and back down (pinned: stays at zero)
    assert len(seen) > 2 or policy.get("max_scale") == 0


def test_replication_reconcile_matches_reference():
    """reconcile over spec revisions, cloud- and edge-owned annotations
    and edge-state writes: changed flags, writes, hashes and edge views."""
    def specs(mod, rev, ann, asc):
        return {
            "f": mod.FunctionSpec(name="f", arch="stablelm-1.6b",
                                  revision=rev, annotations=ann,
                                  autoscaling=mod.AutoscalingPolicy(**asc)),
            "g": mod.FunctionSpec(name="g", arch="hymba-1.5b",
                                  env={"K": "v"}),
        }
    ref, port = j_repl.ReplicationController(), t_repl.ReplicationController()
    edge_key = j_repl.EDGE_ANNOTATION_PREFIX + "node"
    assert edge_key == t_repl.EDGE_ANNOTATION_PREFIX + "node"
    steps = [(1, {}, {}), (1, {}, {}), (2, {}, {}),
             (2, {"team": "x"}, {}), (2, {"team": "x", edge_key: "n1"}, {}),
             (2, {"team": "x"}, {"max_scale": 8}), (3, {}, {"min_scale": 1}),
             (3, {}, {"min_scale": 1})]
    for i, (rev, ann, asc) in enumerate(steps):
        cj = ref.reconcile(specs(j_repl, rev, ann, asc))
        ct = port.reconcile(specs(t_repl, rev, ann, asc))
        assert ct == cj, i
        assert (port.writes, port.reconciles) == (ref.writes, ref.reconciles)
        if i == 3:
            for rc in (ref, port):
                rc.set_edge_state("f", ready_instances=2, status="Ready",
                                  traffic_pct_to_cloud=37.5)
        for name in ("f", "g"):
            ej, et = ref.get(name), port.get(name)
            assert et.spec.spec_hash() == ej.spec.spec_hash(), (i, name)
            assert (et.ready_instances, et.traffic_pct_to_cloud,
                    et.last_seen_revision, et.status,
                    dict(et.edge_annotations)) == (
                ej.ready_instances, ej.traffic_pct_to_cloud,
                ej.last_seen_revision, ej.status, dict(ej.edge_annotations))
    assert port.get("missing") is None and ref.get("missing") is None
