"""Sharded training in the port, against the reference, on the CPU.

* The train, serve and cache spec tables, the batch specs and the train
  state's specs equal the reference's rule functions for every config,
  on a stand-in 2x2 and 4x1 mesh (the rules are pure in the mesh).
* ``ring_allreduce_int8`` and ``allreduce_compressed`` equal the
  reference's bit for bit, the reference run under ``shard_map`` in a
  subprocess with 4 forced host devices (as
  ``tests/test_sharding_dryrun.py:209-247``).
* The sharded step under ``forced_devices(4)`` at meshes (2, 2), (4, 1)
  and (1, 4), accum 2 with int8 compression, and a MoE config at (2, 2),
  against the reference's unsharded jitted step: loss, grad_norm, lr and
  tokens within the float32 tolerance (2e-5 abs / 2e-4 rel,
  ``tests/test_kernels.py:17-19``); params, moments and the error
  buffer within ``tests/test_torch_train_loop.py``'s state gate (max
  |d| <= 2 x peak lr x steps, 99.9 % of the elements within 1e-6).
* A replicated gradient layout and a quantile compression scale give
  the one-device step's update.
* Checkpoints across packages and meshes, float32, bit for bit: a
  reference checkpoint restored onto a port mesh, the port's sharded
  save restored in the reference and onto another mesh.
"""

import dataclasses
import functools
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from repro import configs as j_configs
from repro.launch import sharding as j_lsh
from repro.models import model_zoo as j_zoo
from repro.training import checkpoint as j_ckpt
from repro.training import compression as j_comp
from repro.training import data as j_data
from repro.training import optimizer as j_opt
from repro.training import train_loop as j_loop
from repro_torch import bridge, placement
from repro_torch import configs as t_configs
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import sharding as t_lsh
from repro_torch.launch.train_cost import MeshShape
from repro_torch.models import model_zoo as t_zoo
from repro_torch.training import checkpoint as t_ckpt
from repro_torch.training import compression as t_comp
from repro_torch.training import optimizer as t_opt
from repro_torch.training import train_loop as t_loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL = 2e-5, 2e-4              # float32, tests/test_kernels.py:17-19
PEAK_LR, STEPS = 1e-3, 3          # as tests/test_torch_train_loop.py
MESHES = ((2, 2), (4, 1))


def _jmesh(shape):
    dev = np.array(jax.devices()[:1] * int(np.prod(shape))).reshape(shape)
    return JMesh(dev, ("data", "model"))


def _tmesh(shape):
    return MeshShape(dict(zip(("data", "model"), shape)))


def _spec(named):
    return tuple(named.spec)


# ---------------------------------------------------------------------------
# spec tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", t_configs.ARCHS)
def test_spec_tables_match_reference(arch, shape):
    cfg_j, cfg_t = j_configs.get_config(arch), t_configs.get_config(arch)
    jm, tm = _jmesh(shape), _tmesh(shape)
    for mode in ("train", "serve", "serve_replicated"):
        want = {k: _spec(v) for k, v in
                j_lsh.param_shardings(cfg_j, jm, mode).items()}
        assert t_lsh.param_shardings(cfg_t, tm, mode) == want, mode
    for mode in ("train", "serve"):
        assert t_lsh.act_rules(tm, mode).map == j_lsh.act_rules(jm,
                                                                 mode).map
    # the train state: moments mirror params, the step replicated
    js = j_lsh.train_state_shardings(cfg_j, jm, compression=True)
    ts = t_lsh.train_state_shardings(cfg_t, tm, compression=True)
    for part in ("params", "err"):
        assert getattr(ts, part) == {k: _spec(v) for k, v in
                                     getattr(js, part).items()}
    assert ts.opt.mu == ts.opt.nu == ts.params
    assert ts.opt.step == _spec(js.opt.step) == t_lsh.replicated(tm)
    assert t_lsh.train_state_shardings(cfg_t, tm).err is None
    # every shape's batch
    for name, sh in t_configs.SHAPES.items():
        want = {k: _spec(v) for k, v in j_lsh.batch_shardings(
            j_configs.input_specs(cfg_j, j_configs.SHAPES[name]),
            jm).items()}
        got = t_lsh.batch_shardings(t_configs.input_specs(cfg_t, sh), tm)
        assert got == want, name


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", t_configs.ARCHS)
def test_cache_specs_match_reference(arch, shape):
    """The port stacks every cache leaf over its layers (hymba one stack
    per attention width); each spec is the reference's per-layer one
    behind a replicated layers dim."""
    cfg_j, cfg_t = j_configs.get_config(arch), t_configs.get_config(arch)
    jm, tm = _jmesh(shape), _tmesh(shape)
    cache_j = j_zoo.init_cache(cfg_j, 4, 128, abstract=True)
    cache_t = t_zoo.init_cache(cfg_t, 4, 128, "meta")
    for mode in ("serve", "train"):
        got = t_lsh.cache_shardings(cfg_t, cache_t, tm, mode)
        want = j_lsh.cache_shardings(cfg_j, cache_j, jm, mode)
        if isinstance(want, dict):       # stacked in both packages
            assert got == {k: _spec(v) for k, v in want.items()}, mode
            continue
        for name, leaf in cache_t.items():   # the reference's layer list
            key = name.rpartition("/")[2]
            per_layer = [_spec(w[key]) for w, c in zip(want, cache_j)
                         if tuple(c[key].shape) == tuple(leaf.shape[1:])]
            assert per_layer, name
            ref = per_layer[0]
            assert got[name] == ((None,) + ref if ref else ()), (mode, name)


def test_long_500k_batch_stays_replicated():
    cfg = t_configs.get_config("rwkv6-7b")
    batch = t_configs.input_specs(cfg, t_configs.SHAPES["long_500k"])
    assert tuple(batch["tokens"].shape) == (1,)
    assert t_lsh.batch_shardings(batch, _tmesh((2, 2))) == {
        "tokens": (), "t": ()}
    train = t_configs.input_specs(cfg, t_configs.SHAPES["train_4k"])
    assert t_lsh.batch_shardings(train, _tmesh((2, 2)))["tokens"] == (
        "data",)


def test_place_and_join_are_bitwise_for_every_spec():
    with t_mesh.forced_devices(8):
        mesh = t_mesh.make_mesh((2, 2, 2), ("pod", "data", "model"),
                                t_mesh.host_devices("cpu"))
    g = torch.Generator().manual_seed(0)
    t = torch.randn(8, 4, 6, generator=g)
    for spec in ((), ("data",), (None, "model"), ("data", "model"),
                 (("pod", "data"), None, "model"), (None, ("data", "pod"))):
        p = placement.place(t, spec, mesh)
        assert torch.equal(placement.join(p), t), spec
        # replicas on one device are one tensor
        assert len(list(placement.aligned(p))) == len(list(p.blocks()))
    p = placement.place(t, (("pod", "data"),), mesh)
    assert torch.equal(p.pieces[1, 0, 1], t[4:6])    # pod 1, data 0: block 2
    with pytest.raises(ValueError, match="does not split"):
        placement.place(torch.zeros(3, 2), ("data",), mesh)


# ---------------------------------------------------------------------------
# the int8 ring and the compressed all-reduce against shard_map
# ---------------------------------------------------------------------------


def _ring_inputs():
    rng = np.random.default_rng(3)
    return {"x": rng.integers(-127, 128, (4, 8, 5)).astype(np.int8),
            "ga": (rng.standard_normal((4, 6, 7)) *
                   np.array([1, 3, 0.5, 2])[:, None, None]).astype(np.float32),
            "ea": (rng.standard_normal((4, 6, 7)) * 0.01).astype(np.float32),
            "gb": rng.standard_normal((4, 10)).astype(np.float32),
            "eb": (rng.standard_normal((4, 10)) * 0.01).astype(np.float32)}


def test_ring_and_compressed_allreduce_match_reference_bitwise(tmp_path):
    inp = _ring_inputs()
    np.savez(tmp_path / "in.npz", **inp)
    code = textwrap.dedent("""\
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import functools, inspect, sys
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import PartitionSpec as P
        try:
            from jax import shard_map
        except ImportError:
            from jax.experimental.shard_map import shard_map
        from repro.training import compression

        mesh = jax.make_mesh((4,), ("data",))
        ck = ("check_vma" if "check_vma"
              in inspect.signature(shard_map).parameters else "check_rep")
        d = np.load(sys.argv[1])
        cfg = compression.CompressionConfig(enabled=True)

        @functools.partial(shard_map, mesh=mesh, in_specs=P("data"),
                           out_specs=P("data"), **{ck: False})
        def ring(x):
            return compression.ring_allreduce_int8(x[0], "data")[None]

        @functools.partial(shard_map, mesh=mesh, in_specs=(P("data"),) * 2,
                           out_specs=(P("data"),) * 2, **{ck: False})
        def comp(g, e):
            m, ne = compression.allreduce_compressed(
                {k: v[0] for k, v in g.items()},
                {k: v[0] for k, v in e.items()}, cfg, "data")
            return ({k: v[None] for k, v in m.items()},
                    {k: v[None] for k, v in ne.items()})

        out = {"ring": np.asarray(ring(jnp.asarray(d["x"])))}
        g = {k: jnp.asarray(d["g" + k]) for k in "ab"}
        e = {k: jnp.asarray(d["e" + k]) for k in "ab"}
        m, ne = comp(g, e)
        for k in "ab":
            out["mean" + k] = np.asarray(m[k])
            out["err" + k] = np.asarray(ne[k])
        np.savez(sys.argv[2], **out)
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", code,
                          str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    ref = np.load(tmp_path / "out.npz")

    stats = {}
    got = t_comp.ring_allreduce_int8(
        [torch.from_numpy(inp["x"][j]) for j in range(4)], stats)
    for j in range(4):
        assert got[j].dtype == torch.int32          # the sum, in int32
        np.testing.assert_array_equal(got[j].numpy(), ref["ring"][j])
    np.testing.assert_array_equal(
        ref["ring"][0], inp["x"].astype(np.int32).sum(0))
    # 2 (n - 1) hops a member, each a quarter of x in int32
    assert stats["wire_bytes"] == 4 * 2 * 3 * (8 // 4) * 5 * 4

    cfg = t_comp.CompressionConfig(enabled=True)
    means, errs = t_comp.allreduce_compressed(
        [{k: torch.from_numpy(inp["g" + k][j]) for k in "ab"}
         for j in range(4)],
        [{k: torch.from_numpy(inp["e" + k][j]) for k in "ab"}
         for j in range(4)], cfg)
    for j in range(4):
        for k in "ab":
            np.testing.assert_array_equal(means[j][k].numpy(),
                                          ref["mean" + k][j])
            np.testing.assert_array_equal(errs[j][k].numpy(),
                                          ref["err" + k][j])


# ---------------------------------------------------------------------------
# the sharded step against the reference's unsharded jitted step
# ---------------------------------------------------------------------------


def _configs():
    tj = j_loop.TrainConfig(
        opt=j_opt.OptimizerConfig(peak_lr=PEAK_LR, warmup_steps=2,
                                  total_steps=10),
        accum_steps=2, compression=j_comp.CompressionConfig(enabled=True))
    tt = t_loop.TrainConfig(
        opt=t_opt.OptimizerConfig(peak_lr=PEAK_LR, warmup_steps=2,
                                  total_steps=10),
        accum_steps=2, compression=t_comp.CompressionConfig(enabled=True))
    return tj, tt


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batches(cfg_j):
    dcfg = j_data.DataConfig(batch=4, seq_len=32, seed=1)
    return [_np_tree(j_data.make_batch(cfg_j, dcfg, i)) for i in range(STEPS)]


@functools.lru_cache(maxsize=None)
def _reference_run(arch):
    """(initial state, per-step metrics, final state) of the reference's
    unsharded jitted step, as numpy."""
    cfg_j = j_configs.get_smoke_config(arch)
    tj, _ = _configs()
    s = j_loop.init_state(jax.random.PRNGKey(0), cfg_j, tj)
    init = _np_tree(s)
    step = jax.jit(j_loop.make_train_step(cfg_j, tj))
    metrics = []
    for b in _batches(cfg_j):
        s, m = step(s, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return init, metrics, _np_tree(s)


def _cpu_mesh(shape):
    with t_mesh.forced_devices(4):
        return t_mesh.make_mesh(shape, ("data", "model"),
                                t_mesh.host_devices("cpu"))


def _assert_state_close(got, want):
    """``tests/test_torch_train_loop.py``'s gate, on every part."""
    for part, tree in (("params", want.params), ("mu", want.opt.mu),
                       ("nu", want.opt.nu), ("err", want.err)):
        d = np.concatenate([np.abs(got[part][k] - v).ravel()
                            for k, v in tree.items()])
        assert d.max() <= 2 * PEAK_LR * STEPS, part
        assert (d <= 1e-6).mean() >= 0.999, part


@pytest.mark.parametrize("arch,shape", [
    ("stablelm-1.6b", (2, 2)), ("stablelm-1.6b", (4, 1)),
    ("stablelm-1.6b", (1, 4)), ("qwen2-moe-a2.7b", (2, 2))])
def test_sharded_step_matches_reference_unsharded_step(arch, shape):
    cfg_j = j_configs.get_smoke_config(arch)
    cfg_t = t_configs.get_smoke_config(arch)
    _, tt = _configs()
    init, want_metrics, want = _reference_run(arch)
    mesh = _cpu_mesh(shape)
    sh = t_lsh.train_state_shardings(cfg_t, mesh, compression=True)
    st = bridge.state_from_numpy(init, cfg_t, "cpu", shardings=sh,
                                 mesh=mesh)
    assert isinstance(st.params["embed"], placement.Placed)
    step = t_loop.make_train_step(cfg_t, tt, mesh=mesh)
    for b, wm in zip(_batches(cfg_j), want_metrics):
        bt = {k: torch.from_numpy(v.copy()) for k, v in b.items()}
        bsh = t_lsh.batch_shardings(bt, mesh)
        st, m = step(st, {k: placement.place(v, bsh[k], mesh)
                          for k, v in bt.items()})
        assert sorted(m) == sorted(wm)
        for k in ("loss", "grad_norm", "lr", "tokens") + (
                ("moe_aux", "router_z") if "moe_aux" in wm else ()):
            np.testing.assert_allclose(float(m[k]), wm[k], atol=ATOL,
                                       rtol=RTOL, err_msg=k)
    assert int(st.opt.step) == STEPS
    for p in st.params.values():                     # still placed
        assert isinstance(p, placement.Placed) and p.mesh is mesh
    _assert_state_close(bridge.state_to_numpy(st), want)
    # a data replica gathers what its position does not hold, and adds
    # back as much of its gradient, every microbatch
    if shape[0] * shape[1] > 1:
        assert step.traffic["gather_bytes"] > 0
    assert step.traffic["gather_bytes"] == step.traffic["reduce_bytes"]


def test_sharded_step_options_match_the_unsharded_step():
    """A replicated ``grad_shardings`` (the accumulator resharded to the
    parameter layout before the update) and a ``clip_quantile`` scale
    (taken over the joined leaf) give the one-device step's update."""
    cfg = t_configs.get_smoke_config("stablelm-1.6b")
    _, tt = _configs()
    tt = dataclasses.replace(tt, compression=t_comp.CompressionConfig(
        enabled=True, clip_quantile=0.9))
    mesh = _cpu_mesh((2, 2))
    init = t_loop.init_state(torch.Generator().manual_seed(0), cfg, tt)
    ref = t_loop.init_state(torch.Generator().manual_seed(0), cfg, tt)
    st = t_loop.place_state(init, t_lsh.train_state_shardings(
        cfg, mesh, compression=True), mesh)
    step = t_loop.make_train_step(cfg, tt, mesh=mesh, grad_shardings={
        k: () for k in st.params})
    b = {k: torch.from_numpy(v.copy()) for k, v in _batches(
        j_configs.get_smoke_config("stablelm-1.6b"))[0].items()}
    st, m = step(st, b)
    ref, mr = t_loop.make_train_step(cfg, tt, "cpu")(ref, b)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(mr[k]), atol=ATOL,
                                   rtol=RTOL, err_msg=k)
    got = bridge.state_to_numpy(st)
    want = bridge.state_to_numpy(ref)
    for part in ("params", "mu", "nu", "err"):
        d = np.concatenate([np.abs(got[part][k] - v).ravel()
                            for k, v in want[part].items()])
        assert d.max() <= 2 * PEAK_LR * STEPS, part
        assert (d <= 1e-6).mean() >= 0.999, part


def test_sharded_step_takes_only_a_placed_state():
    cfg = t_configs.get_smoke_config("stablelm-1.6b")
    _, tt = _configs()
    mesh = _cpu_mesh((2, 2))
    st = t_loop.init_state(torch.Generator().manual_seed(0), cfg, tt)
    with pytest.raises(ValueError, match="placed on its mesh"):
        t_loop.make_train_step(cfg, tt, mesh=mesh)(st, {})
    with pytest.raises(ValueError, match="pass mesh= too"):
        t_loop.make_train_step(cfg, tt, "cpu", grad_shardings={})


def test_abstract_state_matches_reference():
    for arch in ("stablelm-1.6b", "qwen2-moe-a2.7b"):
        cfg_j, cfg_t = (j_configs.get_config(arch),
                        t_configs.get_config(arch))
        tj, tt = _configs()
        sj = j_loop.abstract_state(cfg_j, tj)
        st = t_loop.abstract_state(cfg_t, tt)
        for a, b in ((st.params, sj.params), (st.opt.mu, sj.opt.mu),
                     (st.err, sj.err)):
            assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                    for k, v in a.items()} == {
                k: (tuple(v.shape), str(v.dtype)) for k, v in b.items()}
        assert st.params["embed"].device.type == "meta"


# ---------------------------------------------------------------------------
# checkpoints across packages and meshes
# ---------------------------------------------------------------------------


def test_checkpoints_cross_packages_and_meshes(tmp_path):
    arch = "stablelm-1.6b"
    cfg_j = j_configs.get_smoke_config(arch)
    cfg_t = t_configs.get_smoke_config(arch)
    tj, tt = _configs()
    init, _, _ = _reference_run(arch)
    # a reference checkpoint, restored onto a (2, 2) port mesh
    j_ckpt.save(str(tmp_path / "ref"), 3,
                j_loop.init_state(jax.random.PRNGKey(0), cfg_j, tj))
    mesh = _cpu_mesh((2, 2))
    sh = t_lsh.train_state_shardings(cfg_t, mesh, compression=True)
    st, _ = t_ckpt.restore(str(tmp_path / "ref"), 3,
                           t_loop.abstract_state(cfg_t, tt),
                           shardings=sh, mesh=mesh)
    assert isinstance(st.opt.mu["embed"], placement.Placed)
    got = bridge.state_to_numpy(st)
    for part, tree in (("params", init.params), ("mu", init.opt.mu),
                       ("err", init.err)):
        for k, v in tree.items():
            np.testing.assert_array_equal(got[part][k], v)
    # the port's sharded save, restored in the reference ...
    step = t_loop.make_train_step(cfg_t, tt, mesh=mesh)
    b = {k: torch.from_numpy(v.copy()) for k, v in _batches(cfg_j)[0].items()}
    st, _ = step(st, b)
    t_ckpt.save(str(tmp_path / "port"), 4, st)
    sj, _ = j_ckpt.restore(str(tmp_path / "port"), 4,
                           j_loop.abstract_state(cfg_j, tj))
    got = bridge.state_to_numpy(st)
    for part, tree in (("params", sj.params), ("nu", sj.opt.nu),
                       ("err", sj.err)):
        for k, v in tree.items():
            np.testing.assert_array_equal(got[part][k], np.asarray(v))
    assert int(sj.opt.step) == 1
    # ... and onto a (4, 1) mesh (elastic resharding)
    mesh41 = _cpu_mesh((4, 1))
    s41, _ = t_ckpt.restore(
        str(tmp_path / "port"), 4, t_loop.abstract_state(cfg_t, tt),
        shardings=t_lsh.train_state_shardings(cfg_t, mesh41,
                                              compression=True),
        mesh=mesh41)
    again = bridge.state_to_numpy(s41)
    for part in ("params", "mu", "nu", "err"):
        for k, v in got[part].items():
            np.testing.assert_array_equal(again[part][k], v)
    with pytest.raises(ValueError, match="needs their mesh"):
        t_ckpt.restore(str(tmp_path / "port"), 4,
                       t_loop.abstract_state(cfg_t, tt), shardings=sh)
