"""The port's cost-modeled tiers against the reference, on the CPU.

Mirrors the cost-model tests of ``tests/test_sharded_tier.py``:
``TierSpec``'s all-or-nothing cost fields, both deployments refusing an
unresolved spec, the two registered formulas, and the pricing.  The
port counts a decode step in closed form where the reference walks a
synthetic HLO text; the counts are held exactly equal to that walk for
every dense config over tp, batch and max_len.  Under a hardware record
built from the reference's own constants (:func:`reference_hardware`)
the port's roofline, its resolved slots, step times and rates, and the
simulator over a costed chain are bitwise the reference's.  The H100
record itself is checked only for what the pricing must give on it.
"""

import dataclasses
import itertools
import warnings

import numpy as np
import pytest

from repro import configs as j_configs
from repro.core import simulator as j_sim
from repro.core import topology as j_topo
from repro.launch import hlo_analysis, hlo_cost
from repro.launch import tier_cost as j_tc
from repro.serving.tiers import Tier as JTier
from repro_torch import configs as t_configs
from repro_torch import platform as t_platform
from repro_torch.core import simulator as t_sim
from repro_torch.core import topology as t_topo
from repro_torch.launch import roofline as t_roof
from repro_torch.launch import tier_cost as t_tc
from repro_torch.serving.tiers import Tier as TTier
from torch_live import models

DENSE = [a for a in t_configs.ARCHS
         if t_configs.get_config(a).family == "dense"]


def reference_hardware() -> t_roof.Hardware:
    """A hardware record of the reference's own constants (its roofline
    rates and its HBM budget), read from the reference's modules."""
    return t_roof.Hardware(
        name="reference constants", peak_flops=hlo_analysis.PEAK_FLOPS,
        vector_flops=hlo_analysis.VPU_FLOPS, hbm_bw=hlo_analysis.HBM_BW,
        link_bw=hlo_analysis.LINK_BW, hbm_bytes=j_tc.HBM_BYTES)


# ---- TierSpec validation: cost-modeled fields are all-or-nothing ----------


@pytest.mark.parametrize("mod", [t_topo, j_topo], ids=["port", "ref"])
def test_spec_validation_matches_reference(mod):
    with pytest.raises(ValueError, match="mesh_shape requires model"):
        mod.TierSpec("cloud", mesh_shape=(1, 2))
    for bad in ((2,), (0, 2)):
        with pytest.raises(ValueError, match="two positive"):
            mod.TierSpec("cloud", model="stablelm-1.6b", mesh_shape=bad)
    with pytest.raises(ValueError, match="requires model"):
        mod.TierSpec("cloud", decode_step_ms=5.0)
    with pytest.raises(ValueError, match="set neither by hand"):
        mod.TierSpec("cloud", model="stablelm-1.6b", service_rate_mult=2.0)
    with pytest.raises(ValueError, match="set neither by hand"):
        mod.TierSpec("cloud", model="stablelm-1.6b", decode_step_ms=5.0)
    with pytest.raises(ValueError, match="must be > 0"):
        mod.TierSpec("cloud", model="stablelm-1.6b", decode_step_ms=-1.0,
                     service_rate_mult=1.0)
    unres = mod.TierSpec("cloud", model="stablelm-1.6b", mesh_shape=(2, 4))
    assert unres.cost_modeled and not unres.resolved
    assert unres.devices == 8
    res = dataclasses.replace(unres, decode_step_ms=3.0,
                              service_rate_mult=1.0)
    assert res.cost_modeled and res.resolved
    plain = mod.TierSpec("edge", service_rate_mult=1.0)
    assert not plain.cost_modeled and plain.resolved and plain.devices == 1


# ---- both deployments refuse unresolved cost-modeled specs ----------------


def _unresolved(mod):
    return mod.Topology(tiers=(mod.TierSpec("edge", service_rate_mult=1.0),
                               mod.TierSpec("cloud", model="stablelm-1.6b",
                                            queue_depth_per_slot=None)),
                        links=(mod.LinkSpec(),), waterfall=False)


def test_simulator_refuses_unresolved_spec():
    for sim, mod in ((t_sim, t_topo), (j_sim, j_topo)):
        with pytest.raises(ValueError, match="unresolved"):
            sim.ContinuumSimulator("matmult", "auto", sim.SimConfig(
                duration_s=10.0), topology=_unresolved(mod)).run()


def test_live_deploy_refuses_unresolved_spec():
    with pytest.raises(ValueError, match="unresolved"):
        JTier("cloud", _unresolved(j_topo).tiers[1]).deploy("fn", None, None)
    with pytest.raises(ValueError, match="unresolved"):
        TTier("cloud", _unresolved(t_topo).tiers[1], "cpu").deploy(
            "fn", None, None)


def test_mesh_deploys_unsharded_on_one_device():
    """A resolved spec takes its derived slots; a mesh wider than the
    host deploys unsharded with the reference's warning, and on a host
    with the devices it asks for (two forced CPU devices here) the
    tensor-parallel endpoint, at the same slots."""
    _, _, cfg_t, pt = models()
    spec = t_topo.Topology.costed(
        (t_topo.TierSpec("edge", slots=3, max_len=32, model="qwen2.5-14b",
                         mesh_shape=(1, 2)),), hw=reference_hardware()
    ).tiers[0]
    tier = TTier("edge", spec, "cpu")
    with pytest.warns(UserWarning, match="deploying unsharded"):
        tier.deploy("fn", cfg_t, pt)
    assert tier.endpoints["fn"].slots == spec.slots == 3
    assert tier.endpoints["fn"]._tp == 1
    from repro_torch.launch import mesh as t_mesh
    tier = TTier("edge", spec, "cpu")
    with t_mesh.forced_devices(2), warnings.catch_warnings():
        warnings.simplefilter("error")
        tier.deploy("fn", cfg_t, pt)
    assert tier.endpoints["fn"]._tp == 2
    assert tier.endpoints["fn"].slots == spec.slots == 3
    flat = t_topo.Topology.costed(
        (t_topo.TierSpec("d", slots=2, max_len=32, model="stablelm-1.6b",
                         mesh_shape=(1, 1)),)).tiers[0]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        TTier("d", flat, "cpu").deploy("fn", cfg_t, pt)


def test_resolve_costs_is_identity_for_hand_set_chains():
    topo = t_topo.Topology.pair(
        t_topo.TierSpec("edge", slots=2),
        t_topo.TierSpec("cloud", slots=16, queue_depth_per_slot=None))
    assert topo.resolve_costs() is topo
    out = t_tc.resolve_specs(topo.tiers)
    assert out[0] is topo.tiers[0] and out[1] is topo.tiers[1]
    assert out[1].service_rate_mult is None


# ---- the registered formulas -----------------------------------------------


@pytest.mark.parametrize("args", [(4, 12e9, 1e9, 1e9, 1e9),
                                  (500, 12e9, 1e9, 1e9, 1e9),
                                  (7, 80e9, 3.3e9, 1e9, 201e6),
                                  (1, 2.5e9, 1.4e9, 1e9, 1e8)])
def test_formulas_match_reference(args):
    assert (t_tc.derived_slot_capacity(*args)
            == j_tc.derived_slot_capacity(*args))
    for ref_s, s in ((2.0, 4.0), (3.0, 3.0), (1e-3, 7.3e-4)):
        assert (t_tc.derived_service_rate_mult(ref_s, s)
                == j_tc.derived_service_rate_mult(ref_s, s))
    for mod in (t_tc, j_tc):
        with pytest.raises(ValueError, match="kv_row_bytes"):
            mod.derived_slot_capacity(4, 12e9, 1e9, 1e9, 0.0)
        with pytest.raises(ValueError, match="does not fit"):
            mod.derived_slot_capacity(4, 2e9, 1.5e9, 1e9, 1e9)
        with pytest.raises(ValueError, match="must be > 0"):
            mod.derived_service_rate_mult(0.0, 1.0)


# ---- the pricing ------------------------------------------------------------


def _windowed(mod):
    return dataclasses.replace(mod.get_config("stablelm-1.6b"),
                               sliding_window=128)


@pytest.mark.parametrize("arch", DENSE + ["windowed"])
def test_counts_equal_the_reference_hlo_walk(arch):
    """For every tp, batch and max_len: FLOPs, tensor-core FLOPs, HBM
    bytes, collective wire bytes and the number of collectives equal
    ``hlo_cost.analyze_hlo(decode_step_hlo(...))`` exactly, and so do the
    per-device weight and KV-row bytes."""
    if arch == "windowed":
        cj, ct = _windowed(j_configs), _windowed(t_configs)
    else:
        cj, ct = j_configs.get_config(arch), t_configs.get_config(arch)
    for tp, B, max_len in itertools.product((1, 2, 4, 16, 256),
                                            (1, 2, 16, 64), (256, 1024)):
        want = hlo_cost.analyze_hlo(j_tc.decode_step_hlo(
            cj, tp=tp, batch=B, max_len=max_len))
        got = t_tc.decode_step_counts(ct, tp=tp, batch=B, max_len=max_len)
        for key in got:
            assert got[key] == want[key], (tp, B, max_len, key)
        assert (t_tc.params_bytes_per_device(ct, tp)
                == j_tc.params_bytes_per_device(cj, tp))
        assert (t_tc.kv_row_bytes_per_device(ct, tp, max_len)
                == j_tc.kv_row_bytes_per_device(cj, tp, max_len))


@pytest.mark.parametrize("arch,mesh,slots,max_len", [
    ("stablelm-1.6b", None, 500, 256),
    ("stablelm-1.6b", (1, 1), 2, 1024),
    ("llama3-405b", (16, 16), 64, 256),
    ("llama3-405b", (8, 8), 16, 1024),
    ("nemotron-4-340b", (16, 8), 8, 256),
])
def test_tier_cost_equals_reference_under_its_constants(arch, mesh, slots,
                                                        max_len):
    """The whole TierCost, the roofline's ``step_s`` bit for bit."""
    want = j_tc.tier_cost(arch, mesh_shape=mesh, requested_slots=slots,
                          max_len=max_len)
    # the port keeps the reference's 1 GB runtime reserve
    assert t_tc.HBM_RESERVE_BYTES == j_tc.HBM_RESERVE_BYTES
    got = t_tc.tier_cost(arch, mesh_shape=mesh, requested_slots=slots,
                         max_len=max_len, hw=reference_hardware())
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.decode_step_ms == want.decode_step_ms


def test_roofline_equals_reference_bitwise():
    rng = np.random.default_rng(0)
    hw = reference_hardware()
    for _ in range(200):
        flops, mxu, by, coll = (float(x) for x in
                                rng.uniform(0, 1e15, 4) * rng.integers(0, 2,
                                                                       4))
        mxu = min(mxu, flops)
        want = hlo_analysis.Roofline(flops, by, coll, 4,
                                     mxu_flops_per_device=mxu)
        got = t_roof.Roofline(flops, by, coll, 4, mxu_flops_per_device=mxu,
                              hw=hw)
        assert got.to_dict() == want.to_dict()


def test_reference_refusals_kept():
    with pytest.raises(ValueError, match="dense family"):
        t_tc.tier_cost("qwen2-moe-a2.7b")
    # 14 B parameters do not fit the reference's budget unsharded; they
    # fit one H100
    with pytest.raises(ValueError, match="does not fit"):
        t_tc.tier_cost("qwen2.5-14b", hw=reference_hardware())
    assert t_tc.tier_cost("qwen2.5-14b").slots == 4
    with pytest.raises(ValueError, match="does not fit"):
        t_tc.tier_cost("llama3-405b")


def test_h100_pricing():
    """On the H100 record: small-batch unsharded decode streams weights
    (memory-bound, no collectives), sharding shrinks the per-device
    footprint, and the requested slots clamp to the 80 GB fit."""
    c = t_platform.tier_cost("stablelm-1.6b", requested_slots=5000)
    assert isinstance(c, t_platform.TierCost)
    assert c.devices == 1 and c.mesh_shape == (1, 1)
    assert c.slots == c.kv_fit_slots < 5000
    assert c.roofline["dominant"] == "memory" and c.decode_step_s > 0
    assert c.roofline["collective_bytes_per_device"] == 0.0
    cfg = t_configs.get_config("qwen2.5-14b")
    p1, p2 = (t_tc.params_bytes_per_device(cfg, tp) for tp in (1, 2))
    assert p1 / 2 < p2 < p1
    assert (t_tc.kv_row_bytes_per_device(cfg, 2, 256)
            < t_tc.kv_row_bytes_per_device(cfg, 1, 256))
    assert c.roofline["memory_s"] == (c.roofline["bytes_per_device"]
                                      / t_roof.H100_SXM5.hbm_bw)


def test_resolve_specs_matches_reference():
    specs = [(mod.TierSpec("device", slots=2, model="stablelm-1.6b",
                           queue_depth_per_slot=4),
              mod.TierSpec("edge", slots=4, service_rate_mult=1.0),
              mod.TierSpec("cloud", slots=64, max_len=1024,
                           model="llama3-405b", mesh_shape=(16, 16),
                           queue_depth_per_slot=None))
             for mod in (t_topo, j_topo)]
    got = t_tc.resolve_specs(specs[0], hw=reference_hardware())
    want = j_tc.resolve_specs(specs[1])
    assert got[0].service_rate_mult == 1.0 and got[1] is specs[0][1]
    for a, b in zip(got, want):
        assert (a.slots, a.decode_step_ms, a.service_rate_mult) == (
            b.slots, b.decode_step_ms, b.service_rate_mult)


@pytest.mark.parametrize("max_len", [256, 1024])
def test_device_edge_cloud_costed_sim_matches_reference(max_len):
    """The costed chain resolves to the reference's slots, steps and
    rates under its constants, and the simulator over it gives the
    reference's SimResult; on the H100 record it resolves and
    simulates."""
    from test_torch_sim import assert_same_result
    want = j_topo.Topology.device_edge_cloud(cost_model=True,
                                             max_len=max_len)
    got = t_topo.Topology.device_edge_cloud(cost_model=True, max_len=max_len,
                                            hw=reference_hardware())
    for a, b in zip(got.tiers, want.tiers):
        assert (a.slots, a.decode_step_ms, a.service_rate_mult,
                a.mesh_shape, a.model) == (b.slots, b.decode_step_ms,
                                           b.service_rate_mult,
                                           b.mesh_shape, b.model)
    cfg = dict(duration_s=150.0, seed=3)
    assert_same_result(
        t_sim.ContinuumSimulator("matmult", "auto+net", t_sim.SimConfig(
            **cfg), topology=got).run(),
        j_sim.ContinuumSimulator("matmult", "auto+net", j_sim.SimConfig(
            **cfg), topology=want).run())
    h100 = t_topo.Topology.device_edge_cloud(cost_model=True,
                                             max_len=max_len)
    dev, edge, cloud = h100.tiers
    assert all(t.resolved for t in h100.tiers)
    assert dev.service_rate_mult == 1.0
    assert (dev.slots, edge.slots, cloud.slots) == (2, 4, 64)
    assert dev.decode_step_ms < min(edge.decode_step_ms,
                                    cloud.decode_step_ms)
    res = t_platform.Continuum.simulate("matmult", "auto", topology=h100)
    assert res.successes > 0


def test_h100_record_is_the_data_sheet():
    hw = t_roof.H100_SXM5
    assert "H100" in hw.name and "700 W" in hw.name
    assert (hw.peak_flops, hw.vector_flops, hw.hbm_bw, hw.link_bw,
            hw.hbm_bytes) == (989e12, 67e12, 3.35e12, 450e9, 80e9)
    assert t_tc.tier_cost("stablelm-1.6b").roofline["compute_s"] > 0
