"""The architectures ported with the MoE family and after it, against
the JAX reference, on the CPU at smoke width: qwen2-moe-a2.7b and
mixtral-8x7b (``moe``; mixtral's window 16 makes every cache a rolling
row), qwen2.5-14b (GQA with QKV bias), internvl2-1b (a vision prefix of
precomputed patch embeddings), musicgen-medium (gelu, LayerNorm),
llama3-405b (head_dim 8, held on the CPU only: the kernels take 16-128)
and nemotron-4-340b (relu2, LayerNorm).

For each: every config field equal to the reference's (smoke and full),
the param tables (keys, shapes, initialisers), ``param_count`` and
``active_param_count``, ``bridge.params_from_numpy`` on the reference's
parameters, prefill logits and cache (a right-padded bucket with
``lengths``), then 8 greedy decode steps with equal ids; logits within
the float32 tolerance of ``tests/test_kernels.py:17-19``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import common as j_common
from repro.models import model_zoo as j_zoo
from repro_torch import bridge
from repro_torch import configs as t_configs
from repro_torch.models import common as t_common
from repro_torch.models import model_zoo as t_zoo
from torch_live import models

ATOL, RTOL = 2e-5, 2e-4              # float32, tests/test_kernels.py:17-19
ARCHS = ["qwen2-moe-a2.7b", "mixtral-8x7b", "qwen2.5-14b", "internvl2-1b",
         "musicgen-medium", "llama3-405b", "nemotron-4-340b"]
DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


@pytest.mark.parametrize("which", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_match_reference(arch, which):
    get = "get_smoke_config" if which == "smoke" else "get_config"
    cj = getattr(j_configs, get)(arch)
    ct = getattr(t_configs, get)(arch)
    for f in dataclasses.fields(ct):
        want = getattr(cj, f.name)
        if f.name in ("param_dtype", "compute_dtype"):
            want = DTYPES[want]
        assert getattr(ct, f.name) == want, f.name


@pytest.mark.parametrize("which", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_tables_and_counts_match_reference(arch, which):
    get = "get_smoke_config" if which == "smoke" else "get_config"
    cj = getattr(j_configs, get)(arch)
    ct = getattr(t_configs, get)(arch)
    tj, tt = j_zoo.param_table(cj), t_zoo.param_table(ct)
    assert sorted(tj) == sorted(tt)
    for k in tj:
        assert (tuple(tt[k].shape), tt[k].axes, tt[k].init, tt[k].scale) == (
            tuple(tj[k].shape), tj[k].axes, tj[k].init, tj[k].scale), k
    assert ct.param_count() == cj.param_count()
    assert ct.active_param_count() == cj.active_param_count()
    if ct.family == "moe":
        assert ct.active_param_count() < ct.param_count()


def test_full_param_counts():
    """The sizes the card has to hold (ROADMAP item 5)."""
    counts = {a: t_configs.get_config(a).param_count() for a in ARCHS}
    assert counts == {"qwen2-moe-a2.7b": 14_315_784_192,
                      "mixtral-8x7b": 46_702_792_704,
                      "qwen2.5-14b": 14_770_033_664,
                      "internvl2-1b": 629_663_872,
                      "musicgen-medium": 1_365_543_936,
                      "llama3-405b": 405_853_388_800,
                      "nemotron-4-340b": 341_029_195_776}


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_accepts_reference_params(arch):
    cfg_j, pj, cfg_t, pt = models(arch)
    assert sorted(pt) == sorted(pj)
    for k, v in pj.items():
        assert np.array_equal(pt[k].numpy(), np.asarray(v)), k
    with pytest.raises(ValueError, match="parameter keys differ"):
        bridge.params_from_numpy({k: np.asarray(v) for k, v in pj.items()
                                  if "router" not in k and k != "embed"},
                                 cfg_t, "cpu")


def _run_both(arch, lengths, Lb, W, steps, seed):
    cfg_j, pj, cfg_t, pt = models(arch)
    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths, np.int32)
    tok = np.zeros((len(lengths), Lb), np.int32)
    for i, L in enumerate(lengths):
        tok[i, :L] = rng.integers(0, cfg_t.vocab_size, L)
    B = len(lengths)
    cj = j_zoo.init_cache(cfg_j, B, W)
    lj, cj = j_zoo.prefill(cfg_j, pj, {"tokens": jnp.asarray(tok)}, cj,
                           lengths=jnp.asarray(lengths))
    ct = t_zoo.init_cache(cfg_t, B, W, "cpu")
    with torch.no_grad():
        lt, ct = t_zoo.prefill(cfg_t, pt, {"tokens": torch.from_numpy(tok)},
                               ct, lengths=torch.from_numpy(lengths))
    yield "prefill", lj, lt, cj, ct
    toks = np.asarray(lj).argmax(-1).astype(np.int32)
    assert np.array_equal(toks, lt.numpy().argmax(-1))
    t = lengths.copy()
    for step in range(steps):
        gj, cj = j_zoo.decode(cfg_j, pj, cj, jnp.asarray(toks),
                              jnp.asarray(t))
        with torch.no_grad():
            gt, ct = t_zoo.decode(cfg_t, pt, ct, torch.from_numpy(toks),
                                  torch.from_numpy(t))
        yield f"decode {step}", gj, gt, cj, ct
        toks = np.asarray(gj).argmax(-1).astype(np.int32)
        assert np.array_equal(toks, gt.numpy().argmax(-1)), f"step {step}"
        t = t + 1


def _check(tag, lj, lt, cj, ct):
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL,
                               rtol=RTOL, err_msg=tag)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(ct[leaf].numpy(), np.asarray(cj[leaf]),
                                   atol=ATOL, rtol=RTOL,
                                   err_msg=f"{tag}: cache {leaf}")
    np.testing.assert_array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]),
                                  err_msg=f"{tag}: cache pos")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """A right-padded bucket (Lb=24) with per-row lengths, then 8 greedy
    decode steps; for mixtral (window 16) the prompt outgrows the
    rolling rows and decode wraps them."""
    for tag, lj, lt, cj, ct in _run_both(arch, [24, 19, 7, 1], 24, 40, 8,
                                         seed=0):
        _check(tag, lj, lt, cj, ct)


def test_internvl2_vision_prefix_matches_reference():
    """internvl2-1b's prefill with ``patches`` (B, P, d) in front of the
    tokens: positions cover the whole stream, the cache holds P + S
    positions, and decode continues after them."""
    cfg_j, pj, cfg_t, pt = models("internvl2-1b")
    rng = np.random.default_rng(1)
    B, S, P = 2, 10, cfg_t.num_patches
    tok = rng.integers(0, cfg_t.vocab_size, (B, S)).astype(np.int32)
    patches = rng.normal(0, 1, (B, P, cfg_t.d_model)).astype(np.float32)
    cj = j_zoo.init_cache(cfg_j, B, 32)
    lj, cj = j_zoo.prefill(cfg_j, pj, {"tokens": jnp.asarray(tok),
                                       "patches": jnp.asarray(patches)}, cj)
    ct = t_zoo.init_cache(cfg_t, B, 32, "cpu")
    with torch.no_grad():
        lt, ct = t_zoo.prefill(cfg_t, pt, {
            "tokens": torch.from_numpy(tok),
            "patches": torch.from_numpy(patches)}, ct)
    _check("patches prefill", lj, lt, cj, ct)
    assert (ct["pos"][:, :, :P + S] >= 0).all()
    toks = np.asarray(lj).argmax(-1).astype(np.int32)
    t = np.full(B, P + S, np.int32)
    gj, cj = j_zoo.decode(cfg_j, pj, cj, jnp.asarray(toks), jnp.asarray(t))
    with torch.no_grad():
        gt, ct = t_zoo.decode(cfg_t, pt, ct, torch.from_numpy(toks),
                              torch.from_numpy(t))
    _check("decode after the prefix", gj, gt, cj, ct)


def test_embeds_stream_follows_the_tokens():
    """``embeds`` (a precomputed stream) is appended after the tokens,
    as in the reference's ``assemble_embeds``."""
    cfg_j, pj, cfg_t, pt = models("musicgen-medium")
    rng = np.random.default_rng(2)
    tok = rng.integers(0, cfg_t.vocab_size, (2, 5)).astype(np.int32)
    emb = rng.normal(0, 1, (2, 3, cfg_t.d_model)).astype(np.float32)
    from repro.models import transformer as j_tf
    from repro_torch.models import transformer as t_tf
    ej, posj = j_tf.assemble_embeds(cfg_j, pj, {"tokens": jnp.asarray(tok),
                                               "embeds": jnp.asarray(emb)})
    et, post = t_tf.assemble_embeds(cfg_t, pt, {
        "tokens": torch.from_numpy(tok), "embeds": torch.from_numpy(emb)})
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    np.testing.assert_array_equal(post.numpy(), np.asarray(posj))


@pytest.mark.parametrize("activation", ["swiglu", "relu2", "gelu"])
def test_activations_match_reference(activation):
    """All of the reference's ``activate``; its gelu is the tanh
    approximation (``jax.nn.gelu``'s default), not torch's erf form."""
    rng = np.random.default_rng(3)
    gate = rng.normal(0, 3, (64, 32)).astype(np.float32)
    up = rng.normal(0, 1, (64, 32)).astype(np.float32)
    cj = j_common.ModelConfig(activation=activation)
    ct = t_common.ModelConfig(activation=activation)
    want = np.asarray(j_common.activate(cj, jnp.asarray(gate),
                                        jnp.asarray(up)))
    got = t_common.activate(ct, torch.from_numpy(gate), torch.from_numpy(up))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    if activation == "gelu":
        erf = torch.nn.functional.gelu(torch.from_numpy(gate))
        assert not np.allclose(erf.numpy(), want, atol=ATOL, rtol=RTOL)
    with pytest.raises(ValueError):
        t_common.activate(dataclasses.replace(ct, activation="tanh"),
                          torch.from_numpy(gate), None)


@pytest.mark.parametrize("arch", ["llama3-405b", "nemotron-4-340b"])
def test_item_6_archs_still_raise(arch):
    """Their configs are ported (the parametrisations above hold them).
    A tier priced on a (2, 8) mesh deploys their smoke models unsharded
    on a host with fewer devices; on one with 16 the tensor-parallel
    endpoint refuses them as the reference's deploy does (``validate_tp``:
    their smoke widths do not divide by 8).  Their full widths do not fit
    one card."""
    from repro.serving import sharded as j_sharded
    from repro_torch.core import topology as t_topo
    from repro_torch.launch import mesh as t_mesh
    from repro_torch.serving import tiers as t_tiers
    refusal = {"llama3-405b": "num_kv_heads divisible by tp=8, got 2",
               "nemotron-4-340b": "num_heads divisible by tp=8, got 4"}[arch]
    cfg_j, pj, cfg_t, pt = models(arch)
    spec = t_topo.Topology.costed(
        (t_topo.TierSpec("cloud", slots=2, max_len=32, model=arch,
                         mesh_shape=(2, 8)),)).tiers[0]
    with pytest.warns(UserWarning, match="deploying unsharded"):
        t_tiers.Tier("cloud", spec, "cpu").deploy("fn", cfg_t, pt)
    with pytest.raises(ValueError, match=refusal):
        j_sharded.validate_tp(cfg_j, 8)
    with t_mesh.forced_devices(16), pytest.raises(ValueError,
                                                  match=refusal):
        t_tiers.Tier("cloud", spec, "cpu").deploy("fn", cfg_t, pt)
    full = t_configs.get_config(arch)
    assert full.param_count() * 2 > 80e9
