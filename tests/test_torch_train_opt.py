"""The port's optimizer, gradient compression, data stream and training
presets against the JAX reference, on the CPU.

* ``apply_updates`` on identical gradients, through warmup, the cosine
  decay and past its end, with clipping, the decay mask, a bfloat16
  parameter and bfloat16 moments.  The two packages round ``lr`` and
  the bias corrections each in its own float32 code (numpy on the host
  here, XLA there) and XLA may fuse a multiply-add, so parameters and
  moments are held to 1e-6 relative (1e-7 absolute) and the bfloat16
  leaves to one bfloat16 step.
* ``compress``: ``q`` and the absmax scales bitwise, the carried error
  within 1e-6 of the leaf's scale; the quantile scale on a leaf of more
  than 2**24 elements (which ``torch.quantile`` refuses) within 1e-6
  relative of ``jnp.quantile``'s.
* The data stream: the reference's Zipf table exactly, its shapes and
  copy structure, seekable.  The tokens differ from the reference's by
  design (numpy's generator, not threefry).
* ``train_preset`` equal to the reference's for every full config.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.launch import presets as j_presets
from repro.training import compression as j_comp
from repro.training import data as j_data
from repro.training import optimizer as j_opt
from repro_torch import bridge
from repro_torch import configs as t_configs
from repro_torch.launch import presets as t_presets
from repro_torch.training import compression as t_comp
from repro_torch.training import data as t_data
from repro_torch.training import optimizer as t_opt

DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
OPT_RTOL, OPT_ATOL = 1e-6, 1e-7
BF16_STEP = 2.0 ** -8                 # one bfloat16 ulp, relative


def _leaves(rng):
    """A parameter dict with every kind of leaf name the decay mask
    tells apart, and one bfloat16 matrix."""
    shapes = {"embed": (16, 8), "layers/attn/wq": (2, 8, 4),
              "layers/attn/bq": (2, 4), "layers/mlp/norm/scale": (2, 8),
              "layers/mlp/norm/bias": (2, 8), "final_norm/scale": (8,),
              "lm_head": (16, 8)}
    out = {k: rng.standard_normal(s).astype(np.float32)
           for k, s in shapes.items()}
    out["layers/mlp/wi"] = rng.standard_normal((2, 8, 12)).astype(
        ml_dtypes.bfloat16)
    return out


def _as_np(t):
    v = bridge.tensor_to_numpy(t)
    return v.view(ml_dtypes.bfloat16) if t.dtype == torch.bfloat16 else v


@pytest.mark.parametrize("moments", [jnp.float32, jnp.bfloat16])
def test_apply_updates_matches_reference(moments):
    rng = np.random.default_rng(0)
    p0 = _leaves(rng)
    cfg_j = j_opt.OptimizerConfig(peak_lr=1e-2, warmup_steps=3,
                                  total_steps=8, moment_dtype=moments)
    cfg_t = t_opt.OptimizerConfig(peak_lr=1e-2, warmup_steps=3,
                                  total_steps=8,
                                  moment_dtype=DTYPES[moments])
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    sj = j_opt.init(pj, cfg_j)
    pt = {k: bridge.tensor_from_numpy(v, "cpu") for k, v in p0.items()}
    st = t_opt.init(pt, cfg_t)
    for step in range(11):          # warmup, cosine, then past the end
        # step 5's gradients are large: the global norm clips them
        scale = 50.0 if step == 5 else 0.1
        g = {k: (rng.standard_normal(v.shape) * scale).astype(v.dtype)
             for k, v in p0.items()}
        pj, sj, ij = j_opt.apply_updates(
            cfg_j, pj, {k: jnp.asarray(v) for k, v in g.items()}, sj)
        pt, st, it = t_opt.apply_updates(
            cfg_t, pt, {k: bridge.tensor_from_numpy(v, "cpu")
                        for k, v in g.items()}, st)
        assert int(st.step) == int(sj.step) == step + 1
        np.testing.assert_allclose(float(it["lr"]), float(ij["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(it["grad_norm"]),
                                   float(ij["grad_norm"]), rtol=1e-6)
        for tree_t, tree_j in ((pt, pj), (st.mu, sj.mu), (st.nu, sj.nu)):
            for k in p0:
                got = _as_np(tree_t[k]).astype(np.float32)
                want = np.asarray(tree_j[k]).astype(np.float32)
                bf16 = tree_t[k].dtype == torch.bfloat16
                np.testing.assert_allclose(
                    got, want, rtol=BF16_STEP if bf16 else OPT_RTOL,
                    atol=0 if bf16 else OPT_ATOL, err_msg=f"{step} {k}")
    assert float(ij["lr"]) == pytest.approx(1e-3, rel=1e-6)   # the end


def test_schedule_and_decay_mask_match_reference():
    cfg_j = j_opt.OptimizerConfig(peak_lr=3e-4, warmup_steps=7,
                                  total_steps=40)
    cfg_t = t_opt.OptimizerConfig(peak_lr=3e-4, warmup_steps=7,
                                  total_steps=40)
    for s in range(0, 45):
        np.testing.assert_allclose(
            float(t_opt.schedule(cfg_t, s)),
            float(j_opt.schedule(cfg_j, jnp.int32(s))), rtol=1e-6)
    for path in ("embed", "layers/attn/bq", "layers/tm/w0", "norm/scale",
                 "x/bias", "layers/ssm/dt_bias", "layers/moe/router"):
        assert t_opt._decay_mask(path) == j_opt._decay_mask(path), path


def test_abstract_state_is_shape_only():
    p = {"w": torch.zeros(3, 4), "b": torch.zeros(4)}
    st = t_opt.abstract_state(
        p, t_opt.OptimizerConfig(moment_dtype=torch.bfloat16))
    assert st.step.device.type == "meta" and st.step.dtype == torch.int32
    assert all(v.device.type == "meta" and v.dtype == torch.bfloat16
               for v in list(st.mu.values()) + list(st.nu.values()))
    assert st.mu["w"].shape == (3, 4)


def _grad_tree(rng, n=4):
    shapes = [(64, 33), (7,), (3, 5, 11), (1000,)][:n]
    return ({f"l{i}": (rng.standard_normal(s) * 10 ** rng.uniform(-6, 1)
                       ).astype(np.float32) for i, s in enumerate(shapes)},
            {f"l{i}": (rng.standard_normal(s) * 1e-4).astype(np.float32)
             for i, s in enumerate(shapes)})


@pytest.mark.parametrize("seed", range(4))
def test_compress_is_bitwise_the_reference(seed):
    rng = np.random.default_rng(seed)
    cfg_j = j_comp.CompressionConfig(enabled=True)
    cfg_t = t_comp.CompressionConfig(enabled=True)
    g, e = _grad_tree(rng)
    ej = {k: jnp.asarray(v) for k, v in e.items()}
    et = {k: torch.from_numpy(v) for k, v in e.items()}
    for step in range(5):           # error feedback carried in each
        gg = {k: v * (1 + step) for k, v in g.items()}
        qj, sj, ej = j_comp.compress({k: jnp.asarray(v)
                                      for k, v in gg.items()}, ej, cfg_j)
        qt, stt, et = t_comp.compress({k: torch.from_numpy(v)
                                       for k, v in gg.items()}, et, cfg_t)
        dj, dt = j_comp.decompress(qj, sj), t_comp.decompress(qt, stt)
        for k in g:
            assert qt[k].dtype == torch.int8
            assert np.array_equal(qt[k].numpy(), np.asarray(qj[k])), k
            assert stt[k].numpy().tobytes() == np.asarray(sj[k]).tobytes()
            assert np.array_equal(dt[k].numpy(), np.asarray(dj[k])), k
            np.testing.assert_allclose(et[k].numpy(), np.asarray(ej[k]),
                                       atol=1e-6 * float(stt[k]), rtol=0)
            ej[k] = jnp.asarray(et[k].numpy())   # identical inputs again


@pytest.mark.parametrize("n,q", [(1, 0.9), (2, 0.5), (1001, 0.99),
                                 (4096, 0.999), (777, 1.0)])
def test_quantile_matches_jnp_quantile(n, q):
    a = np.abs(np.random.default_rng(n).standard_normal(n)).astype(
        np.float32)
    got = float(t_comp.quantile(torch.from_numpy(a), q))
    want = float(jnp.quantile(jnp.asarray(a), q))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_quantile_scale_above_torch_quantile_limit():
    """A stacked full-width leaf is far larger than 2**24 elements
    (stablelm's embed 205,520,896): torch.quantile refuses it, the port's
    quantile does not, and the scale is the reference's."""
    n = (4097, 4096)                                   # > 2**24
    g = np.random.default_rng(5).standard_normal(n).astype(np.float32)
    with pytest.raises(RuntimeError, match="too large"):
        torch.quantile(torch.from_numpy(g).reshape(-1), 0.99)
    cfg_j = j_comp.CompressionConfig(enabled=True, clip_quantile=0.99)
    cfg_t = t_comp.CompressionConfig(enabled=True, clip_quantile=0.99)
    want = float(j_comp._scale_for(jnp.asarray(g), cfg_j))
    got = float(t_comp._scale_for(torch.from_numpy(g), cfg_t))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_zipf_table_is_the_reference():
    for vocab, a in ((256, 1.2), (100352, 1.2), (50, 2.0)):
        assert np.array_equal(t_data._zipf_logits(vocab, a),
                              j_data._zipf_logits(vocab, a))


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "internvl2-1b"])
def test_batches_have_the_reference_shapes_and_structure(arch):
    cfg_t = t_configs.get_smoke_config(arch)
    cfg_j = j_configs.get_smoke_config(arch)
    dj = j_data.DataConfig(batch=3, seq_len=40, span=8, seed=2)
    dt = t_data.DataConfig(batch=3, seq_len=40, span=8, seed=2)
    bj = j_data.make_batch(cfg_j, dj, 4)
    bt = t_data.make_batch(cfg_t, dt, 4)
    assert sorted(bt) == sorted(bj)
    for k in bj:
        assert tuple(bt[k].shape) == tuple(bj[k].shape), k
        assert bt[k].dtype == DTYPES.get(bj[k].dtype.type,
                                         torch.int32), k
    tok, lab = bt["tokens"].numpy(), bt["labels"].numpy()
    assert np.array_equal(tok[:, 1:], lab[:, :-1])     # next tokens
    assert np.array_equal(tok[:, :8], tok[:, 8:16])    # doubled spans
    assert np.array_equal(tok[:, 16:24], tok[:, 24:32])
    assert tok.min() >= 0 and tok.max() < cfg_t.vocab_size
    # a Zipf unigram: the lowest ranks dominate
    many = t_data.make_batch(cfg_t, dataclasses.replace(
        dt, batch=64, seq_len=256), 0)["tokens"].numpy()
    assert (many == 0).mean() > (many == 10).mean() > 0
    again = t_data.make_batch(cfg_t, dt, 4)
    assert all(torch.equal(again[k], bt[k]) for k in bt)
    other = t_data.make_batch(cfg_t, dataclasses.replace(dt, seed=3), 4)
    assert not torch.equal(other["tokens"], bt["tokens"])


def test_data_stream_seekable():
    cfg = t_configs.get_smoke_config("stablelm-1.6b")
    dcfg = t_data.DataConfig(batch=2, seq_len=16, seed=3)
    a = [next(t_data.stream(cfg, dcfg, i)) for i in (0, 5, 9)]
    s = t_data.stream(cfg, dcfg, 0)
    all_batches = [next(s) for _ in range(10)]
    for got, idx in zip(a, (0, 5, 9)):
        assert torch.equal(got["tokens"], all_batches[idx]["tokens"])
    assert not torch.equal(all_batches[0]["tokens"],
                           all_batches[1]["tokens"])


@pytest.mark.parametrize("global_batch", [1, 8, 12, 256])
def test_train_preset_matches_reference(global_batch):
    for arch in j_configs.ARCHS:
        pj = j_presets.train_preset(j_configs.get_config(arch), global_batch)
        pt = t_presets.train_preset(t_configs.get_config(arch), global_batch)
        assert pt.accum_steps == pj.accum_steps, arch
        assert pt.opt.moment_dtype == DTYPES[pj.opt.moment_dtype], arch
        assert dataclasses.replace(pt.opt, moment_dtype=None) == \
            t_opt.OptimizerConfig(moment_dtype=None)
