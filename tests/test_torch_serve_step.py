"""The serve step (``serving/engine.make_serve_step``) against the
reference's and against itself unsharded, on the CPU.

For one smoke config of each family (dense, MoE, hymba, rwkv6), with the
same float32 weights in both packages (``torch_live.models``):

* a prefill of 4 prompts of 16 tokens into a 32-position cache, then 6
  greedy decode steps, through the port's step over a (2, 2)
  ``("data", "model")`` mesh of four forced CPU devices (params, cache
  and inputs placed by ``serve_placement``), through its unsharded step,
  and through the reference's jitted ``make_serve_step`` on one device:
  the ids equal, the logits within the reference kernel tests' float32
  tolerance (2e-5 abs / 2e-4 rel), the mesh's joined cache equal to the
  unsharded one after every step;
* one row (the long_500k cell's batch), which ``batch_shardings`` leaves
  replicated: the first data replica alone runs it and every replica's
  blocks are written back;
* the bytes the mesh step counts (``serve_step.traffic``) equal
  ``launch/serve_cost.serve_step_counts``' closed-form collective bytes,
  term by term, for each family, both steps and both serve modes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model_zoo as j_zoo
from repro.serving import engine as j_engine
from repro_torch import configs as t_configs
from repro_torch import placement
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import serve_cost
from repro_torch.models import model_zoo as t_zoo
from repro_torch.serving import engine as t_engine
from torch_live import models

ATOL, RTOL = 2e-5, 2e-4          # tests/test_kernels.py's float32 tolerance

ARCHS = ("stablelm-1.6b", "qwen2-moe-a2.7b", "hymba-1.5b", "rwkv6-7b")
B, S, L, STEPS = 4, 16, 32, 6


def _mesh():
    with t_mesh.forced_devices(4):
        return t_mesh.make_mesh((2, 2), ("data", "model"),
                                t_mesh.host_devices("cpu"))


def _tokens(vocab, batch=B, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (batch, S)).astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def _joined(cache):
    return {k: placement.join(v, "cpu") for k, v in cache.items()}


def _run_port(cfg, params, toks, mesh=None, serve_mode="serve"):
    """(per-step logits, final cache (joined), the steps' traffic) of a
    prefill and STEPS greedy decode steps."""
    batch = toks.shape[0]
    cache = t_zoo.init_cache(cfg, batch, L, "cpu")
    tok = {"tokens": torch.from_numpy(toks)}
    kw = dict(mesh=mesh, serve_mode=serve_mode) if mesh else {}
    pre = t_engine.make_serve_step(cfg, "prefill", "cpu", **kw)
    dec = t_engine.make_serve_step(cfg, "decode", "cpu", **kw)
    if mesh:
        params, cache, tok = t_engine.serve_placement(
            cfg, mesh, params, cache, tok, serve_mode)
    logits, cache = pre(params, tok, cache)
    out = [logits]
    traffic = [dict(pre.traffic)] if mesh else []
    for i in range(STEPS):
        nxt = out[-1].argmax(-1).to(torch.int32)
        step_in = {"tokens": nxt,
                   "t": torch.full((batch,), S + i, dtype=torch.int32)}
        if mesh:
            step_in = t_engine.serve_placement(cfg, mesh, {}, {},
                                               step_in)[2]
            before = dict(dec.traffic)
        logits, cache = dec(params, cache, step_in["tokens"], step_in["t"])
        if mesh:
            traffic.append({k: dec.traffic[k] - before[k] for k in before})
        out.append(logits)
    return out, (_joined(cache) if mesh else cache), traffic


def _run_reference(arch, toks):
    cfg_j, pj, _, _ = models(arch)
    pre = jax.jit(j_engine.make_serve_step(cfg_j, "prefill"))
    dec = jax.jit(j_engine.make_serve_step(cfg_j, "decode"))
    cache = j_zoo.init_cache(cfg_j, toks.shape[0], L)
    logits, cache = pre(pj, {"tokens": jnp.asarray(toks)}, cache)
    out = [np.asarray(logits)]
    for i in range(STEPS):
        nxt = jnp.asarray(out[-1].argmax(-1).astype(np.int32))
        logits, cache = dec(pj, cache, nxt,
                            jnp.full((toks.shape[0],), S + i, jnp.int32))
        out.append(np.asarray(logits))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_matches_unsharded_and_reference(arch):
    _, _, cfg, params = models(arch)
    toks = _tokens(cfg.vocab_size)
    ref = _run_reference(arch, toks)
    plain, cache_u, _ = _run_port(cfg, params, toks)
    sharded, cache_m, _ = _run_port(cfg, params, toks, _mesh())
    for i, (r, u, m) in enumerate(zip(ref, plain, sharded)):
        np.testing.assert_array_equal(m.argmax(-1).numpy(), r.argmax(-1),
                                      err_msg=f"step {i}")
        np.testing.assert_array_equal(u.argmax(-1).numpy(), r.argmax(-1))
        _close(m, u)
        _close(u, r)
    assert set(cache_m) == set(cache_u)
    for k in cache_u:
        assert cache_m[k].dtype == cache_u[k].dtype
        if cache_u[k].dtype.is_floating_point:
            _close(cache_m[k], cache_u[k])
        else:
            torch.testing.assert_close(cache_m[k], cache_u[k], rtol=0,
                                       atol=0)


def test_serve_replicated_layout_matches_unsharded():
    _, _, cfg, params = models("stablelm-1.6b")
    toks = _tokens(cfg.vocab_size, seed=3)
    plain, _, _ = _run_port(cfg, params, toks)
    sharded, _, _ = _run_port(cfg, params, toks, _mesh(), "serve_replicated")
    for u, m in zip(plain, sharded):
        np.testing.assert_array_equal(m.argmax(-1).numpy(),
                                      u.argmax(-1).numpy())
        _close(m, u)


def test_mesh_step_refuses_a_misplaced_state():
    _, _, cfg, params = models("stablelm-1.6b")
    mesh = _mesh()
    cache = t_zoo.init_cache(cfg, B, L, "cpu")
    tok = {"tokens": torch.from_numpy(_tokens(cfg.vocab_size))}
    p, c, x = t_engine.serve_placement(cfg, mesh, params, cache, tok,
                                       "serve_replicated")
    step = t_engine.make_serve_step(cfg, "prefill", mesh=mesh)
    with pytest.raises(ValueError, match="'serve' layout"):
        step(p, x, c)
    with pytest.raises(ValueError, match="placed on that mesh"):
        step(params, x, c)
    with pytest.raises(ValueError, match="unknown serve mode"):
        t_engine.make_serve_step(cfg, "train", "cpu")


@pytest.mark.parametrize("arch", ("rwkv6-7b", "hymba-1.5b"))
def test_one_row_runs_on_the_first_replica(arch):
    """long_500k's batch of one stays replicated over "data": one replica
    runs it, and both replicas' cache blocks receive the new entries."""
    _, _, cfg, params = models(arch)
    toks = _tokens(cfg.vocab_size, batch=1, seed=5)
    plain, cache_u, _ = _run_port(cfg, params, toks)
    sharded, cache_m, traffic = _run_port(cfg, params, toks, _mesh())
    for u, m in zip(plain, sharded):
        np.testing.assert_array_equal(m.argmax(-1).numpy(),
                                      u.argmax(-1).numpy())
        _close(m, u)
    for k in cache_u:
        _close(cache_m[k].float(), cache_u[k].float())
    assert all(t["logits"] == 0 for t in traffic)      # one replica ran


@pytest.mark.parametrize("serve_mode", ("serve", "serve_replicated"))
@pytest.mark.parametrize("arch", ARCHS)
def test_traffic_equals_closed_form(arch, serve_mode):
    _, _, cfg, params = models(arch)
    toks = _tokens(cfg.vocab_size, seed=1)
    _, _, traffic = _run_port(cfg, params, toks, _mesh(), serve_mode)
    mesh = {"data": 2, "model": 2}
    pre = serve_cost.serve_step_counts(
        cfg, mesh, t_configs.ShapeSpec("p", "prefill", S, B),
        serve_mode=serve_mode, cache_len=L)
    assert traffic[0] == pre["collective"], "prefill"
    assert sum(traffic[0].values()) == pre["collective_bytes"]
    for i, got in enumerate(traffic[1:]):
        dec = serve_cost.serve_step_counts(
            cfg, mesh, t_configs.ShapeSpec("d", "decode", L, B),
            serve_mode=serve_mode, position=S + i)
        assert got == dec["collective"], f"decode step {i}"
