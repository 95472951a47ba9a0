"""The port's dense transformer against the JAX reference, on the CPU.

The stablelm-1.6b smoke config in float32: parameters come from the
reference's ``model_zoo.init(PRNGKey(0))`` and cross over through
``repro_torch.bridge``.  Prefill logits (right-padded bucketed batch with
``lengths``) and decode logits must agree within 1e-4, cache k/v within
1e-5, cache positions and greedy ids exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import model_zoo as j_zoo
from repro_torch import bridge
from repro_torch import configs as t_configs
from repro_torch.models import model_zoo as t_zoo

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ARCH = "stablelm-1.6b"


@pytest.fixture(scope="module")
def models():
    cfg_j = j_configs.get_smoke_config(ARCH)
    cfg_t = t_configs.get_smoke_config(ARCH)
    pj = j_zoo.init(jax.random.PRNGKey(0), cfg_j)
    pt = bridge.params_from_numpy({k: np.asarray(v) for k, v in pj.items()},
                                  cfg_t, "cpu")
    return cfg_j, pj, cfg_t, pt


def _bucketed_batch(rng, lengths, Lb, vocab):
    tok = np.zeros((len(lengths), Lb), np.int32)
    for i, L in enumerate(lengths):
        tok[i, :L] = rng.integers(0, vocab, L)
    return tok


def _run_both(models, lengths, Lb, W, steps, seed):
    cfg_j, pj, cfg_t, pt = models
    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths, np.int32)
    tok = _bucketed_batch(rng, lengths, Lb, cfg_t.vocab_size)
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
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4,
                               rtol=0, err_msg=tag)
    assert lt.dtype == torch.float32
    for leaf in ("k", "v"):
        np.testing.assert_allclose(ct[leaf].numpy(), np.asarray(cj[leaf]),
                                   atol=1e-5, rtol=0,
                                   err_msg=f"{tag}: cache {leaf}")
    np.testing.assert_array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]),
                                  err_msg=f"{tag}: cache pos")


def test_prefill_and_decode_match_reference(models):
    """Right-padded bucket (Lb=16) with per-row lengths, then 8 decode
    steps; the cache is wide enough that nothing wraps."""
    for tag, lj, lt, cj, ct in _run_both(models, [16, 11, 5, 1], 16, 32,
                                         8, seed=0):
        _check(tag, lj, lt, cj, ct)


def test_rolling_cache_matches_reference(models):
    """max_len < prompt + new: the prompt is cut to the last W tokens and
    decode wraps around the rolling buffer (slot = pos % W)."""
    for tag, lj, lt, cj, ct in _run_both(models, [20, 13], 32, 16, 12,
                                         seed=1):
        _check(tag, lj, lt, cj, ct)


def test_inactive_rows_keep_their_cache(models):
    """decode with an active mask writes only the active rows."""
    _, _, cfg_t, pt = models
    rng = np.random.default_rng(2)
    tok = rng.integers(0, cfg_t.vocab_size, (3, 8)).astype(np.int32)
    cache = t_zoo.init_cache(cfg_t, 3, 16, "cpu")
    with torch.no_grad():
        t_zoo.prefill(cfg_t, pt, {"tokens": torch.from_numpy(tok)}, cache)
        before = {k: v.clone() for k, v in cache.items()}
        active = torch.tensor([True, False, True])
        t_zoo.decode(cfg_t, pt, cache, torch.tensor([1, 2, 3]),
                     torch.tensor([8, 8, 8]), active)
    for k in cache:
        assert torch.equal(cache[k][:, 1], before[k][:, 1])
        assert not torch.equal(cache[k][:, 0], before[k][:, 0])


@pytest.mark.parametrize("which", ["smoke", "full"])
def test_param_tables_match_reference(which):
    get_j = j_configs.get_smoke_config if which == "smoke" else \
        j_configs.get_config
    get_t = t_configs.get_smoke_config if which == "smoke" else \
        t_configs.get_config
    tj = j_zoo.param_table(get_j(ARCH))
    tt = t_zoo.param_table(get_t(ARCH))
    assert sorted(tj) == sorted(tt)
    for k in tj:
        assert tuple(tj[k].shape) == tuple(tt[k].shape), k
        assert (tj[k].init, tj[k].scale) == (tt[k].init, tt[k].scale), k


def test_full_config_matches_reference():
    cj, ct = j_configs.get_config(ARCH), t_configs.get_config(ARCH)
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
              "head_dim", "d_ff", "vocab_size", "rope_theta", "activation",
              "norm_type", "norm_eps", "qkv_bias", "sliding_window",
              "attn_logit_softcap", "tie_embeddings"):
        assert getattr(ct, f) == getattr(cj, f), f
    assert ct.param_dtype == torch.bfloat16 == ct.compute_dtype
    assert ct.param_count() == cj.param_count()


def test_unported_archs_raise():
    # every architecture of the reference is ported; an unknown one raises
    assert set(t_configs.ARCHS) == set(j_configs.ARCHS)
    assert t_configs.get_config("llama3-405b").num_layers == 126
    with pytest.raises(ValueError):
        t_configs.get_config("no-such-arch")


def test_bridge_keeps_bfloat16_bits():
    x = jax.random.normal(jax.random.PRNGKey(5), (7, 3), jnp.bfloat16)
    t = bridge.tensor_from_numpy(np.asarray(x), "cpu")
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy(),
                          np.asarray(x).view(np.int16))
