"""The port's MoE family against the JAX reference, on the CPU.

``moe_ffn`` at the qwen2-moe-a2.7b (shared experts) and mixtral-8x7b
smoke widths, with capacity factor 1.25 and 0.5 (overflow): the
reference's own routing decisions are read off its run (a spy on its
``jax.lax.top_k`` and on the ``vmap`` that scatters into the expert
buffer), and the port's must equal them exactly: the gate indices, the
kept slots and their buffer rows.  Outputs and both aux losses hold to
the float32 tolerance of ``tests/test_kernels.py:17-19``.  A constructed
top-k tie takes the lower expert index first, as ``jax.lax.top_k``.

Then qwen2-moe through the serving path: paged == dense ids, a
migrated row == the unmigrated one (== the reference's), and a live
2-tier continuum through both packages (``tests/torch_live.py``) with
every output, latency, per-tick record and counter equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as j_moe
from repro.serving.engine import Endpoint as JEndpoint
from repro_torch.models import moe as t_moe
from repro_torch.models.common import apply_norm
from repro_torch.serving.engine import Endpoint as TEndpoint
from test_torch_chain import (_sequential_reference,  # noqa: F401
                              deterministic_clock)  # noqa: F401
from test_torch_migration import _port_prefill, _solo_stream
from torch_live import Pair, models, two_tier

ATOL, RTOL = 2e-5, 2e-4              # float32, tests/test_kernels.py:17-19
ARCHS = ["qwen2-moe-a2.7b", "mixtral-8x7b"]
PROMPT = np.arange(6, dtype=np.int32)


class _Spy:
    """Stands in for the ``jax`` module inside ``repro.models.moe``:
    records the top-k indices and the buffer rows every slot is
    scattered to, and otherwise is ``jax``."""

    def __init__(self):
        self.seen = {}
        spy = self

        class _Lax:
            def __getattr__(self, name):
                return getattr(jax.lax, name)

            def top_k(self, x, k):
                vals, idx = jax.lax.top_k(x, k)
                spy.seen["gate_idx"] = np.asarray(idx)
                return vals, idx

        self.lax = _Lax()

    def __getattr__(self, name):
        return getattr(jax, name)

    def vmap(self, fn):
        mapped = jax.vmap(fn)

        def run(rows, idx):
            self.seen.setdefault("dest", np.asarray(idx))
            return mapped(rows, idx)
        return run


def _layer(arch, cf, seed):
    """(reference cfg, port cfg, the layer-0 ``moe/`` params of both, x)
    with the router and the shared gate redrawn from numpy, so the
    sigmoid gate is not the initial 0.5."""
    cfg_j, pj, cfg_t, _ = models(arch)
    cfg_j = dataclasses.replace(cfg_j, capacity_factor=cf)
    cfg_t = dataclasses.replace(cfg_t, capacity_factor=cf)
    rng = np.random.default_rng(seed)
    p = {k[len("layers/"):]: np.array(v[0]) for k, v in pj.items()
         if k.startswith("layers/moe/")}
    p["moe/router"] = rng.normal(0, 0.5, p["moe/router"].shape).astype(
        np.float32)
    if "moe/shared/gate" in p:
        p["moe/shared/gate"] = rng.normal(0, 0.3, (cfg_j.d_model, 1)).astype(
            np.float32)
    x = rng.normal(0, 1, (3, 24, cfg_j.d_model)).astype(np.float32)
    return cfg_j, cfg_t, p, x


def _reference(cfg_j, p, x):
    spy = _Spy()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_moe, "jax", spy)
        y, aux = j_moe.moe_ffn(cfg_j, {k: jnp.asarray(v)
                                       for k, v in p.items()},
                               jnp.asarray(x))
    return np.asarray(y), {k: float(v) for k, v in aux.items()}, spy.seen


def _port(cfg_t, p, x):
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    xt = torch.from_numpy(x)
    y, aux = t_moe.moe_ffn(cfg_t, pt, xt)
    h = apply_norm(cfg_t, pt, "moe/norm", xt)
    _, _, _, gate_idx = t_moe._route(cfg_t, h, pt["moe/router"])
    C = t_moe._capacity(cfg_t, x.shape[1])
    dest = t_moe._slots(gate_idx, cfg_t.num_experts, C)
    return y.numpy(), {k: float(v) for k, v in aux.items()}, {
        "gate_idx": gate_idx.numpy(), "dest": dest.numpy()}, C


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(arch, cf):
    cfg_j, cfg_t, p, x = _layer(arch, cf, seed=3)
    yj, auxj, seen = _reference(cfg_j, p, x)
    yt, auxt, got, C = _port(cfg_t, p, x)
    assert C == j_moe._capacity(cfg_j, x.shape[1])
    np.testing.assert_array_equal(got["gate_idx"], seen["gate_idx"])
    np.testing.assert_array_equal(got["dest"], seen["dest"])
    E = cfg_t.num_experts
    kept = got["dest"] < E * C
    np.testing.assert_array_equal(kept, seen["dest"] < E * C)
    if cf == 0.5:
        assert not kept.all()            # the overflow case drops slots
    np.testing.assert_allclose(yt, yj, atol=ATOL, rtol=RTOL)
    for k in ("moe_aux", "router_z"):
        np.testing.assert_allclose(auxt[k], auxj[k], atol=ATOL, rtol=RTOL)


def test_top_k_tie_takes_the_lower_index():
    """A zero router makes every expert's probability 1/E: both packages
    pick experts 0..K-1 for every token, in that order, and the rest of
    the slots overflow alike.  Two equal router columns tie two experts
    at every token."""
    cfg_j, cfg_t, p, x = _layer("qwen2-moe-a2.7b", 1.25, seed=4)
    K = cfg_t.top_k
    zero = dict(p, **{"moe/router": np.zeros_like(p["moe/router"])})
    _, _, seen = _reference(cfg_j, zero, x)
    yt, _, got, _ = _port(cfg_t, zero, x)
    np.testing.assert_array_equal(got["gate_idx"], seen["gate_idx"])
    assert (got["gate_idx"] == np.arange(K)).all()
    np.testing.assert_array_equal(got["dest"], seen["dest"])
    tied = p["moe/router"].copy()
    tied[:, 5] = tied[:, 2]
    twin = dict(p, **{"moe/router": tied})
    yj, _, seen = _reference(cfg_j, twin, x)
    yt, _, got, _ = _port(cfg_t, twin, x)
    np.testing.assert_array_equal(got["gate_idx"], seen["gate_idx"])
    both = (got["gate_idx"] == 2).any(-1) & (got["gate_idx"] == 5).any(-1)
    assert both.any()
    k2 = np.argmax(got["gate_idx"] == 2, -1)[both]
    k5 = np.argmax(got["gate_idx"] == 5, -1)[both]
    assert (k2 < k5).all()
    np.testing.assert_allclose(yt, yj, atol=ATOL, rtol=RTOL)


def test_moe_layer_routes_each_row_alone():
    """Capacity is per batch row: a row's output does not depend on the
    other rows of its batch (what lets the engine repeat rows to pad a
    prefill batch and decode inactive rows beside live ones)."""
    _, cfg_t, p, x = _layer("mixtral-8x7b", 0.5, seed=5)
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    full = t_moe.moe_ffn(cfg_t, pt, torch.from_numpy(x))[0]
    for b in range(x.shape[0]):
        alone = t_moe.moe_ffn(cfg_t, pt, torch.from_numpy(x[b:b + 1]))[0]
        np.testing.assert_allclose(alone[0].numpy(), full[b].numpy(),
                                   atol=ATOL, rtol=RTOL)


# --------------------------------------------------------------------------
# qwen2-moe through the serving path
# --------------------------------------------------------------------------


def test_paged_ids_equal_dense():
    _, _, cfg_t, pt = models("qwen2-moe-a2.7b")
    eps = [TEndpoint(cfg_t, pt, slots=4, max_len=48, device="cpu", **kw)
           for kw in ({}, dict(paged=True, page_size=8,
                               prefix_cache=False))]
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg_t.vocab_size, L).astype(np.int32)
               for L in (5, 17, 17, 30)]
    streams = []
    for ep in eps:
        slots = [ep.try_claim(tokens=t, max_new=24) for t in prompts]
        toks = ep.prefill_batch(dict(zip(slots, prompts)))
        out = {s: [t] for s, t in toks.items()}
        for step in range(24):                 # wraps the 48-slot rows
            if step == 10:                     # retire one row midway
                ep.release(slots[1])
                toks.pop(slots[1])
            toks = ep.decode_all(toks)
            for s, t in toks.items():
                out[s].append(t)
        streams.append(out)
    assert streams[0] == streams[1]


def test_migrated_row_stream_equals_unmigrated():
    """Decode 4 steps, move the row into another pool beside a busy
    neighbour, decode on: the ids equal the unmigrated run, and that run
    equals the reference's."""
    cfg_j, pj, cfg_t, pt = models("qwen2-moe-a2.7b")
    solo = _solo_stream(TEndpoint(cfg_t, pt, slots=2, max_len=64,
                                  device="cpu"), PROMPT, 9, _port_prefill)
    want = _solo_stream(JEndpoint(cfg_j, pj, slots=2, max_len=64),
                        PROMPT, 9, lambda ep, s, p: ep.prefill_one(s, p))
    assert solo == want
    src = TEndpoint(cfg_t, pt, slots=2, max_len=64, device="cpu")
    dst = TEndpoint(cfg_t, pt, slots=4, max_len=64, device="cpu")
    s = src.try_claim()
    tok = src.prefill_batch({s: PROMPT})[s]
    got = [tok]
    for _ in range(4):
        tok = src.decode_all({s: tok})[s]
        got.append(tok)
    [state] = src.extract_rows([s])
    pos = int(src.slot_pos[s])
    other = dst.try_claim()
    dst.prefill_batch({other: np.arange(3, dtype=np.int32) + 7})
    d = dst.try_claim()
    dst.insert_rows([state], [d], [pos])
    for _ in range(5):
        tok = dst.decode_all({d: tok})[d]
        got.append(tok)
    assert got == solo


@pytest.mark.parametrize("paged", [False, True])
def test_live_two_tier_continuum_matches_reference(paged,
                                                   deterministic_clock):
    """qwen2-moe through both packages' live continuum under ``"auto"``
    (edge 2 slots, cloud 4), five rounds of mixed-length requests, then
    drained: every output, latency, per-tick record (routing included)
    and counter equal."""
    kw = dict(page_size=8) if paged else {}
    pair = Pair(lambda m: two_tier(m, edge_kw=kw, cloud_kw=kw),
                lambda m: "auto", arch="qwen2-moe-a2.7b")
    rng = np.random.default_rng(2)
    rid = 0
    for rnd in range(5):
        for _ in range(2 + 2 * rnd):
            L = int(rng.integers(3, 20))
            pair.submit(rid, rng.integers(0, 256, L), int(rng.integers(1, 7)))
            rid += 1
        pair.tick()
    pair.drain()
    pair.check()
    assert sum(pair.served().values()) == rid
