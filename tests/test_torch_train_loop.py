"""The port's train step, checkpoints and fault-tolerant Trainer, on the
CPU.

* Three train steps with ``accum_steps=2`` and int8 error-feedback
  compression, the reference's state carried over (``bridge``) and both
  fed the reference's batches: every step's loss and ``grad_norm``
  within the float32 tolerance (2e-5 abs / 2e-4 rel,
  ``tests/test_kernels.py:17-19``).  Parameters are held to ``2 x peak
  lr x steps`` absolute: where the two packages round a near-zero
  gradient differently (here also across an int8 rounding boundary of
  the compression), Adam's normalized update turns the difference into
  up to lr a step in either direction; and 99.9 % of all elements to
  1e-6.
* The reference's fault-tolerance cases (``tests/test_fault_tolerance.py``)
  mirrored on the port: atomic roundtrip, partial directory ignored,
  shape mismatch fails, gc keeps the newest, resume within rtol 1e-6,
  straggler ratio.
* Checkpoints across the packages: a reference-written float32 and
  bfloat16 checkpoint restores in the port with the same bits, a
  port-written float32 one restores in the reference, and a bfloat16
  leaf is written byte for byte as the reference writes it.  The
  reference's own restore of a bfloat16 leaf raises (pinned).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.training import checkpoint as j_ckpt
from repro.training import compression as j_comp
from repro.training import data as j_data
from repro.training import optimizer as j_opt
from repro.training import train_loop as j_loop
from repro_torch import bridge
from repro_torch import configs as t_configs
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import compression as t_comp
from repro_torch.training import data as t_data
from repro_torch.training import optimizer as t_opt
from repro_torch.training import train_loop as t_loop

ATOL, RTOL = 2e-5, 2e-4              # float32, tests/test_kernels.py:17-19
ARCH = "stablelm-1.6b"
PEAK_LR, STEPS = 1e-3, 3


def _configs(arch, compress=True):
    tj = j_loop.TrainConfig(
        opt=j_opt.OptimizerConfig(peak_lr=PEAK_LR, warmup_steps=2,
                                  total_steps=10),
        accum_steps=2,
        compression=j_comp.CompressionConfig(enabled=compress))
    tt = t_loop.TrainConfig(
        opt=t_opt.OptimizerConfig(peak_lr=PEAK_LR, warmup_steps=2,
                                  total_steps=10),
        accum_steps=2,
        compression=t_comp.CompressionConfig(enabled=compress))
    return tj, tt


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("arch", [ARCH, "qwen2-moe-a2.7b"])
def test_train_steps_match_reference(arch):
    cfg_j = j_configs.get_smoke_config(arch)
    cfg_t = t_configs.get_smoke_config(arch)
    tj, tt = _configs(arch)
    sj = j_loop.init_state(jax.random.PRNGKey(0), cfg_j, tj)
    st = bridge.state_from_numpy(_np_tree(sj), cfg_t, "cpu")
    step_j = jax.jit(j_loop.make_train_step(cfg_j, tj))
    step_t = t_loop.make_train_step(cfg_t, tt, "cpu")
    dcfg = j_data.DataConfig(batch=4, seq_len=32, seed=1)
    for i in range(STEPS):
        batch = _np_tree(j_data.make_batch(cfg_j, dcfg, i))
        sj, mj = step_j(sj, {k: jnp.asarray(v) for k, v in batch.items()})
        st, mt = step_t(st, {k: torch.from_numpy(v.copy())
                             for k, v in batch.items()})
        assert sorted(mt) == sorted(mj)
        for k in ("loss", "grad_norm", "lr", "tokens"):
            np.testing.assert_allclose(float(mt[k]), float(mj[k]),
                                       atol=ATOL, rtol=RTOL, err_msg=k)
        assert int(st.opt.step) == i + 1
    got = bridge.state_to_numpy(st)
    want = _np_tree(sj)
    for tree_t, tree_j in ((got["params"], want.params),
                           (got["err"], want.err)):
        d = np.concatenate([np.abs(tree_t[k] - v).ravel()
                            for k, v in tree_j.items()])
        assert d.max() <= 2 * PEAK_LR * STEPS
        assert (d <= 1e-6).mean() >= 0.999


def test_train_step_refuses_state_on_another_device():
    cfg = t_configs.get_smoke_config(ARCH)
    _, tt = _configs(ARCH, compress=False)
    st = t_loop.init_state(torch.Generator().manual_seed(0), cfg, tt)
    st = st._replace(params={k: v.to("meta") for k, v in st.params.items()})
    step = t_loop.make_train_step(cfg, tt, "cpu")
    with pytest.raises(ValueError, match="lives on meta"):
        step(st, t_data.make_batch(cfg, t_data.DataConfig(batch=2,
                                                          seq_len=8), 0))


def test_accumulation_needs_a_divisible_batch():
    cfg = t_configs.get_smoke_config(ARCH)
    _, tt = _configs(ARCH, compress=False)
    st = t_loop.init_state(torch.Generator().manual_seed(0), cfg, tt)
    batch = t_data.make_batch(cfg, t_data.DataConfig(batch=3, seq_len=8), 0)
    with pytest.raises(ValueError, match="batch size 3 is not divisible by "
                                         "grad-accum factor 2"):
        t_loop.make_train_step(cfg, tt, "cpu")(st, batch)


def test_state_bridge_roundtrip():
    cfg_j = dataclasses.replace(j_configs.get_smoke_config(ARCH),
                                param_dtype=jnp.bfloat16)
    cfg_t = dataclasses.replace(t_configs.get_smoke_config(ARCH),
                                param_dtype=torch.bfloat16)
    tj, _ = _configs(ARCH)
    sj = _np_tree(j_loop.init_state(jax.random.PRNGKey(3), cfg_j, tj))
    st = bridge.state_from_numpy(sj, cfg_t, "cpu")
    assert st.params["embed"].dtype == torch.bfloat16
    back = bridge.state_to_numpy(st)
    assert int(back["step"]) == int(sj.opt.step)
    for got, want in ((back["params"], sj.params), (back["mu"], sj.opt.mu),
                      (back["nu"], sj.opt.nu), (back["err"], sj.err)):
        for k, v in want.items():
            g = got[k].view(ml_dtypes.bfloat16) if got[k].dtype == \
                np.uint16 else got[k]
            assert g.dtype == v.dtype and np.array_equal(g, v), k


# ---- fault tolerance (tests/test_fault_tolerance.py, on the port) -------


def _mk_trainer(tmp, steps, fault_hook=None, seed=0):
    cfg = t_configs.get_smoke_config(ARCH)
    dcfg = t_data.DataConfig(batch=4, seq_len=32, seed=seed)
    tcfg = t_loop.TrainConfig(opt=t_opt.OptimizerConfig(
        peak_lr=1e-3, warmup_steps=4, total_steps=steps))
    lcfg = t_loop.LoopConfig(total_steps=steps, ckpt_dir=tmp, ckpt_every=5)
    return t_loop.Trainer(cfg, tcfg, lcfg,
                          lambda s: t_data.stream(cfg, dcfg, s),
                          seed=seed, fault_hook=fault_hook, device="cpu")


def test_checkpoint_atomic_roundtrip(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "nested": {"b": torch.ones(5, dtype=torch.int32)},
            "h": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)}
    d = str(tmp_path)
    ckpt.save(d, 7, tree, extra={"note": "x"})
    assert ckpt.latest_step(d) == 7
    assert not any(n.endswith(".tmp") for n in os.listdir(d))
    out, extra = ckpt.restore(d, 7, tree)
    for k in ("a", "h"):
        assert out[k].dtype == tree[k].dtype and torch.equal(out[k], tree[k])
    assert torch.equal(out["nested"]["b"], tree["nested"]["b"])
    assert extra["note"] == "x"
    # a shape-only template (meta tensors) restores onto the device given
    meta = {"a": torch.empty(3, 4, device="meta"),
            "nested": {"b": torch.empty(5, dtype=torch.int32,
                                        device="meta")},
            "h": torch.empty(2, dtype=torch.float32, device="meta")}
    out, _ = ckpt.restore(d, 7, meta, device="cpu")
    assert out["a"].device.type == "cpu" and torch.equal(out["a"], tree["a"])
    assert out["h"].dtype == torch.float32
    assert torch.equal(out["h"], tree["h"].float())


def test_optimizer_abstract_state_is_a_checkpoint_template(tmp_path):
    params = {"w": torch.randn(3, 4), "b": torch.randn(4)}
    st = t_opt.init(params)
    ckpt.save(str(tmp_path), 2, st)
    out, _ = ckpt.restore(str(tmp_path), 2, t_opt.abstract_state(params),
                          device="cpu")
    assert isinstance(out, t_opt.OptState)
    assert torch.equal(out.mu["w"], st.mu["w"]) and int(out.step) == 0


def test_partial_checkpoint_ignored(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 5, {"a": torch.zeros(3)})
    os.makedirs(os.path.join(d, "step_00000009"))      # a crashed write
    os.makedirs(os.path.join(d, "step_00000011.tmp"))
    assert ckpt.latest_step(d) == 5


def test_checkpoint_shape_mismatch_fails(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, {"a": torch.zeros(3, 4)})
    with pytest.raises(ValueError, match=r"a: checkpoint \(3, 4\) vs "
                                         r"model \(4, 3\)"):
        ckpt.restore(d, 1, {"a": torch.zeros(4, 3)})
    with pytest.raises(ValueError, match="checkpoint/model mismatch"):
        ckpt.restore(d, 1, {"b": torch.zeros(3, 4)})


def test_gc_keeps_newest(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3, 4, 5):
        ckpt.save(d, s, {"a": torch.zeros(2)})
    ckpt.gc_old(d, keep=2)
    assert ckpt.latest_step(d) == 5
    assert sorted(os.listdir(d)) == ["step_00000004", "step_00000005"]


def test_resume_matches_uninterrupted_run(tmp_path):
    """Uninterrupted run == crash at step 7 + resume from step 5."""
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    full = _mk_trainer(d1, 12).run()

    def hook(step):
        if step == 7 and not getattr(hook, "fired", False):
            hook.fired = True
            raise t_loop.PreemptionError("simulated node loss")

    t = _mk_trainer(d2, 12, fault_hook=hook)
    with pytest.raises(t_loop.PreemptionError):
        t.run()
    t2 = _mk_trainer(d2, 12)                # the restarted job
    assert t2.start_step == 5
    out = t2.run()
    full_tail = [h for h in full["history"] if h["step"] > 5]
    assert [h["step"] for h in out["history"]] == \
        [h["step"] for h in full_tail]
    for a, b in zip(out["history"], full_tail):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-6)
    assert ckpt.latest_step(d2) == 12


def test_straggler_ratio_reported(tmp_path):
    t = _mk_trainer(str(tmp_path), 6)
    out = t.run()
    assert out["straggler_ratio"] >= 1.0
    assert len(t.step_times) == 6


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA card")
    cfg = t_configs.get_smoke_config(ARCH)
    with pytest.raises(RuntimeError, match="cuda"):
        t_loop.Trainer(cfg, t_loop.TrainConfig(), t_loop.LoopConfig(),
                       lambda s: iter(()))
    with pytest.raises(RuntimeError, match="cuda"):
        t_loop.make_train_step(cfg, t_loop.TrainConfig())


# ---- checkpoints across the packages ------------------------------------


def _ref_state(dtype):
    cfg_j = dataclasses.replace(j_configs.get_smoke_config(ARCH),
                                param_dtype=dtype)
    tj, _ = _configs(ARCH)
    return cfg_j, j_loop.init_state(jax.random.PRNGKey(1), cfg_j, tj)


def _port_template(dtype):
    cfg_t = dataclasses.replace(t_configs.get_smoke_config(ARCH),
                                param_dtype=dtype)
    _, tt = _configs(ARCH)
    return t_loop.init_state(torch.Generator().manual_seed(9), cfg_t, tt)


@pytest.mark.parametrize("jdt,tdt", [(jnp.float32, torch.float32),
                                     (jnp.bfloat16, torch.bfloat16)])
def test_reference_checkpoint_restores_in_port(tmp_path, jdt, tdt):
    _, sj = _ref_state(jdt)
    d = str(tmp_path)
    j_ckpt.save(d, 3, sj, extra={"by": "reference"})
    assert ckpt.latest_step(d) == 3
    st, extra = ckpt.restore(d, 3, _port_template(tdt))
    assert extra == {"by": "reference"}
    got = bridge.state_to_numpy(st)
    want = _np_tree(sj)
    assert int(got["step"]) == int(want.opt.step)
    for tree_t, tree_j in ((got["params"], want.params),
                           (got["mu"], want.opt.mu), (got["err"], want.err)):
        for k, v in tree_j.items():
            assert tree_t[k].tobytes() == v.tobytes(), k
    if jdt == jnp.bfloat16:      # the reference cannot read its own file
        with pytest.raises(ValueError, match="No cast function"):
            j_ckpt.restore(d, 3, sj)


def test_port_checkpoint_restores_in_reference(tmp_path):
    st = _port_template(torch.float32)
    d = str(tmp_path)
    ckpt.save(d, 4, st)
    _, sj = _ref_state(jnp.float32)
    out, _ = j_ckpt.restore(d, 4, sj)
    got = _np_tree(out)
    want = bridge.state_to_numpy(st)
    for k, v in want["params"].items():
        assert np.array_equal(got.params[k], v), k
    for k, v in want["err"].items():
        assert np.array_equal(got.err[k], v), k
    assert int(got.opt.step) == int(want["step"])


def test_bfloat16_leaf_written_as_the_reference_writes_it(tmp_path):
    w = np.asarray([1.5, 2.25, -3.0, 1e-3], ml_dtypes.bfloat16)
    j_ckpt.save(str(tmp_path / "j"), 1, {"w": jnp.asarray(w)})
    ckpt.save(str(tmp_path / "t"), 1, {"w": bridge.tensor_from_numpy(
        w, "cpu")})
    for name in ("w.npy", "manifest.json"):
        a = (tmp_path / "j" / "step_00000001" / name).read_bytes()
        b = (tmp_path / "t" / "step_00000001" / name).read_bytes()
        assert a == b, name
