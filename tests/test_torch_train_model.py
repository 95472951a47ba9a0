"""The port's training loss against the JAX reference, on the CPU at
smoke width: ``model_zoo.loss`` of every smoke configuration on the same
parameters (``bridge``) and batch, the gradients of one configuration
per family against ``jax.grad`` of the reference's loss, remat on and
off (and in groups) bitwise in the port, and ``chunked_softmax_xent``
with padding and masked labels.

Tolerances are the reference's float32 kernel tolerance
(``tests/test_kernels.py:17-19``: 2e-5 abs / 2e-4 rel) for losses and
metrics; gradients, which sum over the batch, are held to 2e-5 abs /
2e-4 rel of their leaf's largest magnitude.
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
from repro_torch import configs as t_configs
from repro_torch.models import common as t_common
from repro_torch.models import model_zoo as t_zoo
from torch_live import models

ATOL, RTOL = 2e-5, 2e-4              # float32, tests/test_kernels.py:17-19
TRAIN_FIELDS = ("remat", "remat_group", "ce_chunk")


def _batch(cfg, B=2, S=32, seed=0):
    """Numpy tokens, labels (a few masked) and, for a vision frontend,
    patches."""
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lab[0, :3] = -1
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "labels": lab}
    if cfg.frontend == "vision":
        b["patches"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return b


def _both(b):
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


@pytest.mark.parametrize("which", ["smoke", "full"])
@pytest.mark.parametrize("arch", j_configs.ARCHS)
def test_training_fields_match_reference(arch, which):
    get = "get_smoke_config" if which == "smoke" else "get_config"
    cj = getattr(j_configs, get)(arch)
    ct = getattr(t_configs, get)(arch)
    for f in TRAIN_FIELDS:
        assert getattr(ct, f) == getattr(cj, f), f


@pytest.mark.parametrize("arch", j_configs.ARCHS)
def test_loss_and_metrics_match_reference(arch):
    cfg_j, pj, cfg_t, pt = models(arch)
    bj, bt = _both(_batch(cfg_t))
    lj, mj = jax.jit(lambda p, b: j_zoo.loss(cfg_j, p, b))(pj, bj)
    with torch.no_grad():
        lt, mt = t_zoo.loss(cfg_t, pt, bt)
    assert sorted(mt) == sorted(mj)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL,
                               rtol=RTOL)
    for k in mj:
        np.testing.assert_allclose(mt[k].numpy(), np.asarray(mj[k]),
                                   atol=ATOL, rtol=RTOL, err_msg=k)
    assert 1.0 < float(lt) < 20.0


def _port_grads(cfg, params, batch):
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss, _ = t_zoo.loss(cfg, leaves, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


# one configuration per family: dense, MoE, rwkv6, hymba, and the vision
# frontend
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "qwen2-moe-a2.7b",
                                  "rwkv6-7b", "hymba-1.5b", "internvl2-1b"])
def test_grads_match_reference(arch):
    cfg_j, pj, cfg_t, pt = models(arch)
    bj, bt = _both(_batch(cfg_t, seed=1))
    gj = jax.jit(jax.grad(lambda p, b: j_zoo.loss(cfg_j, p, b)[0]))(pj, bj)
    _, gt = _port_grads(cfg_t, pt, bt)
    assert sorted(gt) == sorted(gj)
    for k, g in gt.items():
        want = np.asarray(gj[k])
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), want, atol=ATOL * scale,
                                   rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("arch,group", [("stablelm-1.6b", 2),
                                        ("qwen2-moe-a2.7b", 2),
                                        ("hymba-1.5b", 3)])
def test_remat_is_bitwise_the_plain_backward(arch, group):
    """Recomputing each layer (and each group of layers, recomputed
    twice) in the backward changes no bit of the loss or the grads."""
    _, _, cfg, params = models(arch)
    _, bt = _both(_batch(cfg, seed=2))
    runs = {}
    for remat, G in ((False, 1), (True, 1), (True, group)):
        c = dataclasses.replace(cfg, remat=remat, remat_group=G)
        runs[(remat, G)] = _port_grads(c, params, bt)
    (l0, g0), *rest = runs.values()
    for l, g in rest:
        assert torch.equal(l, l0)
        for k in g0:
            assert torch.equal(g[k], g0[k]), k


def test_remat_recomputes_the_attention_kernel():
    """With remat the backward runs each layer's forward again: the
    attention dispatch counts 2 x layers calls a step, and 1 x without."""
    from repro_torch.kernels import ops
    _, _, cfg, params = models("stablelm-1.6b")
    _, bt = _both(_batch(cfg))
    for remat, per_layer in ((True, 2), (False, 1)):
        ops.reset_launches()
        _port_grads(dataclasses.replace(cfg, remat=remat), params, bt)
        assert ops.launches["flash_attention_plain"] == \
            per_layer * cfg.num_layers


@pytest.mark.parametrize("S,chunk", [(37, 16), (32, 16), (5, 16),
                                     (48, 512)])
def test_chunked_softmax_xent_matches_reference(S, chunk):
    """Padding S up to a chunk multiple with label -1, masked labels,
    and the gather in place of the one-hot contraction."""
    rng = np.random.default_rng(S)
    B, d, V = 3, 24, 50
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    w = rng.standard_normal((V, d)).astype(np.float32)
    lab = rng.integers(0, V, (B, S)).astype(np.int32)
    lab[rng.random((B, S)) < 0.3] = -1
    lj, nj = j_common.chunked_softmax_xent(jnp.asarray(x), jnp.asarray(w),
                                           jnp.asarray(lab), chunk)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    lt, nt = t_common.chunked_softmax_xent(xt, wt, torch.from_numpy(lab),
                                           chunk)
    assert float(nt) == float(nj) == float((lab >= 0).sum())
    np.testing.assert_allclose(lt.item(), float(lj), atol=ATOL, rtol=RTOL)
    gxj, gwj = jax.grad(lambda a, b: j_common.chunked_softmax_xent(
        a, b, jnp.asarray(lab), chunk)[0], argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    gx, gw = torch.autograd.grad(lt, (xt, wt))
    np.testing.assert_allclose(gx.numpy(), np.asarray(gxj), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(gw.numpy(), np.asarray(gwj), atol=ATOL,
                               rtol=RTOL)


def test_serving_modes_return_what_they_did():
    """Train mode returns (x, each layer's aux sums); prefill and decode
    still return the hidden states alone."""
    from repro_torch.models import transformer
    _, _, cfg, params = models("qwen2-moe-a2.7b")
    emb = torch.zeros(1, 4, cfg.d_model)
    pos = torch.arange(4, dtype=torch.int32)[None]
    with torch.no_grad():
        x, aux = transformer.forward(cfg, params, emb, pos, None, "train",
                                     layer_fn=t_zoo.family(cfg).layer_fn)
        cache = t_zoo.init_cache(cfg, 1, 8, "cpu")
        y = transformer.forward(cfg, params, emb, pos, cache, "prefill",
                                layer_fn=t_zoo.family(cfg).layer_fn)
    assert isinstance(y, torch.Tensor) and y.shape == x.shape
    assert len(aux) == cfg.num_layers
    assert all(sorted(a) == ["ce", "me", "n", "z"] for a in aux)
    assert torch.equal(x, y)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "rwkv6-7b"])
def test_scan_length_rule_applies_in_training(arch):
    """The scans' rule (S <= 128 or S % 128 == 0, ``ops._check_scan_len``)
    holds in training as in prefill."""
    _, _, cfg, params = models(arch)
    _, bt = _both(_batch(cfg, S=200))
    with pytest.raises(ValueError, match="not divisible by chunk 128"):
        t_zoo.loss(cfg, params, bt)
