"""The port's kernels against the JAX reference's.

On the CPU the port's ``kernels.ops`` runs the plain PyTorch versions;
they are held against ``repro.kernels.ops`` (the Pallas kernels in
interpret mode, as ``tests/test_kernels.py`` runs them) and against
``repro.kernels.ref``, on the same inputs made with numpy from a seed.
Tolerances are the reference's own (``tests/test_kernels.py:17-19``):
2e-5 abs / 2e-4 rel in float32, 2e-2 in bfloat16; 5e-4 / 5e-3 for the
WKV6 scan, 5e-2 with bfloat16-rounded inputs (``:137-138``); 1e-4 / 1e-4
for the selective-SSM scan (``:180-183``).

The ``gpu`` tests hold each CUDA kernel against its plain version on the
card (the check ``chip_smoke.py`` runs), and the paged decode kernel K3
bitwise against the dense one K2 on the gathered view; they skip without
one.  The
reference is imported through the ``jax_ref`` fixture, so on the card,
where JAX is not installed, ``python -m pytest -m gpu
tests/test_torch_kernels.py`` runs the ``gpu`` tests alone.
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX reference: its kernel entry points (Pallas in interpret
    mode on the CPU) and its oracles."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops, ref
    return types.SimpleNamespace(jnp=jnp, ops=ops, ref=ref)


def _tol(dtype_name):
    return (dict(atol=2e-2, rtol=2e-2) if dtype_name == "bfloat16"
            else dict(atol=2e-5, rtol=2e-4))


def _both(jr, x, dtype_name):
    """One float32 numpy array as (jax, torch) arrays of the dtype (both
    round float32 -> bfloat16 to nearest even, so the bits agree)."""
    jd = jr.jnp.bfloat16 if dtype_name == "bfloat16" else jr.jnp.float32
    return (jr.jnp.asarray(x).astype(jd),
            torch.from_numpy(x).to(DTYPES[dtype_name]))


def _close(got_t, want_j, dtype_name):
    np.testing.assert_allclose(got_t.float().numpy(),
                               np.asarray(want_j, np.float32),
                               **_tol(dtype_name))


def _rolling_cache(rng, B, T):
    """kv positions of a rolling buffer: row b holds its last n_b tokens at
    slots pos % T (unordered once it wraps), empty slots are -1; one row
    is empty and one query sits before some of its row's keys."""
    kv_pos = np.full((B, T), -1, np.int32)
    q_pos = np.zeros(B, np.int32)
    for b in range(B):
        n = 0 if b == 0 else int(rng.integers(1, 2 * T))
        pos = np.arange(max(0, n - T), n, dtype=np.int32)
        kv_pos[b, pos % T] = pos
        q_pos[b] = n - 1 if b != 1 else max(n - 3, 0)
    return q_pos, kv_pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("B,S,T,Hq,Hkv,D", [
    (2, 64, 64, 4, 2, 16),       # GQA
    (1, 40, 72, 6, 3, 32),       # ragged
])
def test_flash_attention_plain_matches_reference(jax_ref, B, S, T, Hq, Hkv, D,
                                                 window, softcap, dtype):
    jr, jnp = jax_ref, jax_ref.jnp
    rng = np.random.default_rng(S * T + Hq)
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    qp = np.broadcast_to(np.arange(T - S, T, dtype=np.int32), (B, S)).copy()
    kp = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    (qj, qt), (kj, kt), (vj, vt) = (_both(jr, x, dtype) for x in (q, k, v))
    got = t_ops.flash_attention(qt, kt, vt, torch.from_numpy(qp),
                                torch.from_numpy(kp), window=window,
                                softcap=softcap)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    want_kernel = jr.ops.flash_attention(qj, kj, vj, jnp.asarray(qp),
                                        jnp.asarray(kp), True, window,
                                        softcap)
    _close(got, want_kernel, dtype)
    want_oracle = jr.ref.flash_attention(qj, kj, vj, jnp.asarray(qp),
                                        jnp.asarray(kp), window=window,
                                        softcap=softcap)
    _close(got, want_oracle, dtype)


def test_flash_attention_fully_masked_rows_are_zero(jax_ref):
    jnp = jax_ref.jnp
    rng = np.random.default_rng(1)
    B, S, H, D = 1, 8, 2, 16
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(
        np.float32)) for _ in range(3))
    pos = torch.arange(S, dtype=torch.int32)[None]
    kp = torch.full((B, S), -1, dtype=torch.int32)
    kp[0, 5:] = pos[0, 5:]                  # queries 0..4 see nothing
    out = t_ops.flash_attention(q, k, v, pos, kp)
    want = jax_ref.ref.flash_attention(jnp.asarray(q.numpy()),
                                 jnp.asarray(k.numpy()),
                                 jnp.asarray(v.numpy()),
                                 jnp.asarray(pos.numpy()),
                                 jnp.asarray(kp.numpy()))
    assert torch.count_nonzero(out[0, :5]) == 0
    _close(out, want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,softcap", [(None, None), (24, 30.0)])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (4, 2)])     # G = 1, 2
def test_decode_attention_plain_matches_reference(jax_ref, Hq, Hkv, window,
                                                  softcap, dtype):
    jr, jnp = jax_ref, jax_ref.jnp
    rng = np.random.default_rng(10 * Hq + Hkv)
    B, T, D = 4, 48, 16
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    qp, kp = _rolling_cache(rng, B, T)
    (qj, qt), (kj, kt), (vj, vt) = (_both(jr, x, dtype) for x in (q, k, v))
    got = t_ops.decode_attention(qt, kt, vt, torch.from_numpy(qp),
                                 torch.from_numpy(kp), window=window,
                                 softcap=softcap)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    assert torch.count_nonzero(got[0]) == 0          # the empty row
    want_kernel = jr.ops.decode_attention(qj, kj, vj, jnp.asarray(qp),
                                         jnp.asarray(kp), window, softcap)
    _close(got, want_kernel, dtype)
    want_oracle = jr.ref.decode_attention(qj, kj, vj, jnp.asarray(qp),
                                         jnp.asarray(kp), window=window,
                                         softcap=softcap)
    _close(got, want_oracle, dtype)


def _paged_pool(rng, B, ppr, page, Hkv, D, spare=3):
    """A paged pool in the engine's layout: row b holds its last n_b tokens
    at slots pos % W (W = ppr*page; a wrapped row uses every page), pages
    drawn from a random permutation of the pool (no row's pages are
    contiguous), short rows padded with the null page P (pos -1); row 0
    is empty and one query sits before some of its row's keys.  Returns
    (k_pages, v_pages, tables, q_pos, kv_pos_pages) as numpy arrays."""
    W = ppr * page
    ns = [0] + [int(rng.integers(1, 2 * W)) for _ in range(B - 1)]
    used = [ppr if n > W else -(-n // page) for n in ns]
    P = sum(used) + spare
    ids = iter(rng.permutation(P))
    tables = np.full((B, ppr), P, np.int32)
    kv_pos_pages = np.full((P + 1, page), -1, np.int32)
    q_pos = np.zeros(B, np.int32)
    for b, (n, u) in enumerate(zip(ns, used)):
        tables[b, :u] = [next(ids) for _ in range(u)]
        for t in range(max(0, n - W), n):
            s = t % W
            kv_pos_pages[tables[b, s // page], s % page] = t
        q_pos[b] = n - 1 if b != 1 else max(n - 3, 0)
    k = rng.standard_normal((P + 1, page, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((P + 1, page, Hkv, D)).astype(np.float32)
    return k, v, tables, q_pos, kv_pos_pages


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,softcap", [(None, None), (13, None),
                                            (None, 20.0), (13, 5.0)])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (4, 2)])     # G = 1, 2
def test_paged_decode_attention_plain_matches_reference(jax_ref, Hq, Hkv,
                                                        window, softcap,
                                                        dtype):
    """The plain K3 against the reference's paged kernel (Pallas in
    interpret mode, as tests/test_paged_cache.py runs it) and against the
    reference's dense oracle on the gathered view."""
    jr, jnp = jax_ref, jax_ref.jnp
    rng = np.random.default_rng(100 + 10 * Hq + Hkv)
    B, ppr, page, D = 4, 4, 16, 64
    k, v, tables, qp, kpp = _paged_pool(rng, B, ppr, page, Hkv, D)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_both(jr, x, dtype) for x in (q, k, v))
    got = t_ops.paged_decode_attention(qt, kt, vt, torch.from_numpy(tables),
                                       torch.from_numpy(qp),
                                       torch.from_numpy(kpp), window=window,
                                       softcap=softcap)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    assert torch.count_nonzero(got[0]) == 0          # the empty row
    want_kernel = jr.ops.paged_decode_attention(
        qj, kj, vj, jnp.asarray(tables), jnp.asarray(qp), jnp.asarray(kpp),
        window, softcap)
    _close(got, want_kernel, dtype)
    W = ppr * page
    want_oracle = jr.ref.decode_attention(
        qj, kj[tables].reshape(B, W, Hkv, D), vj[tables].reshape(B, W, Hkv, D),
        jnp.asarray(qp), jnp.asarray(kpp[tables].reshape(B, W)),
        window=window, softcap=softcap)
    _close(got, want_oracle, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_plain_equals_dense_plain_on_gathered_view(dtype):
    rng = np.random.default_rng(7)
    B, ppr, page, Hkv, D = 5, 4, 8, 2, 32
    k, v, tables, qp, kpp = (torch.from_numpy(x) for x in
                             _paged_pool(rng, B, ppr, page, Hkv, D))
    k, v = k.to(DTYPES[dtype]), v.to(DTYPES[dtype])
    q = torch.from_numpy(rng.standard_normal((B, 2 * Hkv, D)).astype(
        np.float32)).to(DTYPES[dtype])
    got = t_ref.paged_decode_attention(q, k, v, tables, qp, kpp, window=20,
                                       softcap=10.0)
    idx = tables.long()
    want = t_ref.decode_attention(
        q, k[idx].reshape(B, ppr * page, Hkv, D),
        v[idx].reshape(B, ppr * page, Hkv, D), qp,
        kpp[idx].reshape(B, ppr * page), window=20, softcap=10.0)
    assert torch.equal(got, want)


# ------------------------------------------- K2/K3 split over a cluster

from repro_torch.kernels import decode_attention as t_dec   # noqa: E402


@pytest.mark.parametrize("name,B,Hq,Hkv,T,want", [
    ("stablelm cloud", 16, 32, 32, 1024, 1),
    ("stablelm edge", 2, 32, 32, 1024, 8),
    ("hymba cloud, rolling", 16, 25, 5, 1024, 4),
    ("hymba cloud, global", 16, 25, 5, 2048, 4),
    ("hymba edge, rolling", 2, 25, 5, 1024, 8),
    ("hymba edge, global", 2, 25, 5, 2048, 8),
    ("smoke model", 4, 4, 2, 48, 1),
])
def test_decode_split_at_main_path_shapes(name, B, Hq, Hkv, T, want):
    """The cluster size the launcher picks on the main path's decode
    steps (stablelm-1.6b and hymba-1.5b, cloud B = 16 and edge B = 2)."""
    C, span = t_dec.split(B, Hkv, t_dec.head_chunks(Hq, Hkv), T)
    assert C == want, name
    assert C * span >= T and (C == 1 or -(-T // C) >= t_dec.MIN_SPAN)


def test_decode_split_bounds():
    """Over many shapes: C is a power of two <= 8, the C ranges cover T,
    every block but the last keeps >= 128 slots, boundaries fall on
    multiples of 64 slots (hence of pages of 8, 16, 32 and 64 slots), and
    C is the smallest that reaches the block target."""
    rng = np.random.default_rng(0)
    for _ in range(2000):
        B, Hkv, chunks = (int(x) for x in rng.integers(1, 40, 3))
        T = int(rng.integers(0, 4097))
        C, span = t_dec.split(B, Hkv, chunks, T)
        assert C in (1, 2, 4, 8)
        assert C * span >= T and span >= 1
        assert span % t_dec.SPAN_UNIT == 0
        assert all(span % page == 0 for page in (8, 16, 32, 64))
        if C > 1:
            assert -(-T // C) >= t_dec.MIN_SPAN
            assert B * Hkv * chunks * (C // 2) < t_dec.TARGET_BLOCKS
        if C < t_dec.MAX_CLUSTER and T >= 2 * C * t_dec.MIN_SPAN:
            assert B * Hkv * chunks * C >= t_dec.TARGET_BLOCKS
    assert t_dec.head_chunks(32, 32) == 1 and t_dec.head_chunks(25, 5) == 1
    assert t_dec.head_chunks(32, 2) == 2 and t_dec.head_chunks(12, 4) == 1


def _split_merge_decode(q, k, v, q_pos, kv_pos, C, span, window=None,
                        softcap=None):
    """Decode as the split kernel computes it, in plain float32 torch: each
    of C slot ranges [r*span, (r+1)*span) keeps its own (m, l, acc), an
    empty range (m, l, acc) = (-1e30, 0, 0); the partials are merged in
    rank order with the alive / max(l, 1e-30) guards."""
    B, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    neg = t_ref.NEG_INF
    qf = q.float().reshape(B, Hkv, G, D) * D ** -0.5
    s = torch.einsum("bkgd,btkd->bkgt", qf, k.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    d = q_pos[:, None] - kv_pos
    ok = (kv_pos >= 0) & (d >= 0)
    if window is not None:
        ok &= d < window
    s = torch.where(ok[:, None, None], s, torch.full_like(s, neg))
    parts = []
    for r in range(C):
        lo, hi = min(r * span, T), min((r + 1) * span, T)
        sr, okr = s[..., lo:hi], ok[:, None, None, lo:hi]
        m = sr.amax(-1, keepdim=True) if hi > lo else torch.full(
            s.shape[:-1] + (1,), neg)
        alive = m > neg / 2
        p = torch.where(okr & alive, torch.exp(sr - m), torch.zeros_like(sr))
        acc = torch.einsum("bkgt,btkd->bkgd", p, v[:, lo:hi].float())
        parts.append((m, p.sum(-1, keepdim=True), acc))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    alive = M > neg / 2
    L = torch.zeros_like(M)
    o = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = torch.where(alive, torch.exp(m - M), torch.zeros_like(m))
        L = L + l * w
        o = o + acc * w
    out = o / torch.clamp(L, min=1e-30)
    return out.reshape(B, Hq, D).to(q.dtype)


@pytest.mark.parametrize("window,softcap", [(None, None), (40, None),
                                            (None, 20.0)])
@pytest.mark.parametrize("C,span", [(1, 256), (2, 128), (4, 64), (8, 64)])
def test_split_merge_decode_matches_references(jax_ref, C, span, window,
                                               softcap):
    """The split kernel's algorithm (partials per slot range, merged in
    rank order) against the port's plain decode and the JAX reference's
    oracle and kernel, with empty ranges (C = 8 over 200 slots leaves four
    empty, and short rows leave more) and an all-empty row (row 0)."""
    jr, jnp = jax_ref, jax_ref.jnp
    rng = np.random.default_rng(C * 1000 + span)
    B, T, Hq, Hkv, D = 6, 200, 6, 2, 16
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    qp, kp = _rolling_cache(rng, B, T)
    kp[2, 60:] = -1                          # slots past 60 empty in row 2
    qp[2] = max(int(kp[2].max()), 0)
    tq, tk, tv, tqp, tkp = (torch.from_numpy(x) for x in (q, k, v, qp, kp))
    got = _split_merge_decode(tq, tk, tv, tqp, tkp, C, span, window,
                              softcap)
    assert torch.count_nonzero(got[0]) == 0           # the all-empty row
    want = t_ref.decode_attention(tq, tk, tv, tqp, tkp, window=window,
                                  softcap=softcap)
    torch.testing.assert_close(got, want, **_tol("float32"))
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qp),
            jnp.asarray(kp))
    _close(got, jr.ref.decode_attention(*args, window=window,
                                        softcap=softcap), "float32")
    _close(got, jr.ops.decode_attention(*args, window, softcap), "float32")


def test_cpu_tensors_take_the_plain_versions():
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((1, 4, 2, 16)).astype(np.float32))
    pos = torch.arange(4, dtype=torch.int32)[None]
    t_ops.reset_launches()
    t_ops.flash_attention(q, q, q, pos, pos)
    t_ops.decode_attention(q[:, 0], q, q, pos[:, -1], pos)
    t_ops.paged_decode_attention(q[:, 0], q[0, None], q[0, None],
                                 torch.zeros((1, 1), dtype=torch.int32),
                                 pos[:, -1], pos)
    t_ops.ssd_scan(q.abs(), q, q[:, 0])
    s0 = q[:, 0, :, :, None] * q[:, 0, :, None, :]
    t_ops.rwkv6_scan(q, q, q, -q.abs(), q[0, 0], s0)
    assert t_ops.launches == {"flash_attention": 0, "flash_attention_plain": 1,
                              "decode_attention": 0,
                              "decode_attention_plain": 1,
                              "paged_decode_attention": 0,
                              "paged_decode_attention_plain": 1,
                              "rwkv6_scan": 0, "rwkv6_scan_plain": 1,
                              "ssd_scan": 0, "ssd_scan_plain": 1}
    t_ops.reset_launches()
    assert set(t_ops.launches.values()) == {0}


def test_flash_attention_backward_recomputes_through_plain():
    """The autograd.Function's backward equals differentiating the plain
    version (the reference's custom_vjp contract)."""
    rng = np.random.default_rng(3)
    B, S, Hq, Hkv, D = 1, 16, 4, 2, 8
    xs = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for s in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))]
    pos = torch.arange(S, dtype=torch.int32)[None]
    a = [x.clone().requires_grad_() for x in xs]
    b = [x.clone().requires_grad_() for x in xs]
    t_ops.flash_attention(*a, pos, pos, window=5).square().sum().backward()
    t_ref.flash_attention(*b, pos, pos, window=5).square().sum().backward()
    for x, y in zip(a, b):
        torch.testing.assert_close(x.grad, y.grad, atol=2e-5, rtol=2e-4)


# ---------------------------------------------------------------- K4 rwkv6_scan

RWKV_TOL = {"float32": dict(atol=5e-4, rtol=5e-3),
            "bfloat16": dict(atol=5e-2, rtol=5e-2)}


def _rwkv_inputs(rng, B, S, H, D, dtype_name="float32", strong_decay=False):
    """r, k, v normal (rounded through bfloat16 for "bfloat16", then kept
    in float32, as the model feeds the scan), lw = -0.4|normal| (or
    -e^10 everywhere, the clip's strongest decay), u = 0.3 normal, s0 =
    0.1 normal, as ``tests/test_kernels.py`` draws them."""
    r, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32)
               for _ in range(3))
    if dtype_name == "bfloat16":
        r, k, v = (torch.from_numpy(x).bfloat16().float().numpy()
                   for x in (r, k, v))
    lw = (np.full((B, S, H, D), -np.exp(10.0)) if strong_decay
          else -0.4 * np.abs(rng.standard_normal((B, S, H, D))))
    u = 0.3 * rng.standard_normal((H, D))
    s0 = 0.1 * rng.standard_normal((B, H, D, D))
    return tuple(np.asarray(x, np.float32) for x in (r, k, v, lw, u, s0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,D,chunk,strong_decay", [
    (1, 32, 2, 8, 16, False),     # the shapes of test_rwkv6_scan_sweep
    (2, 128, 4, 16, 32, False),
    (2, 64, 1, 64, 64, False),
    # lw = -e^10, the state dies every step; the reference's chunked
    # closed form keeps float32 precision there only up to chunk 16 (at
    # 32 its y is off by up to 1.7: cancelling sums of -e^10 log-decays)
    (1, 64, 2, 32, 16, True),
])
def test_rwkv6_scan_plain_matches_reference(jax_ref, B, S, H, D, chunk,
                                            strong_decay, dtype):
    """ops.rwkv6_scan on CPU tensors (the plain per-token recurrence)
    against the reference's Pallas kernel in interpret mode and its own
    oracle."""
    from repro.kernels import rwkv6_scan as j_rwkv
    rng = np.random.default_rng(S + D)
    xs = _rwkv_inputs(rng, B, S, H, D, dtype, strong_decay)
    t_ops.reset_launches()
    y, sf = t_ops.rwkv6_scan(*(torch.from_numpy(x) for x in xs))
    assert t_ops.launches["rwkv6_scan_plain"] == 1
    assert y.dtype == sf.dtype == torch.float32
    assert y.shape == (B, S, H, D) and sf.shape == (B, H, D, D)
    js = [jax_ref.jnp.asarray(x) for x in xs]
    for want_y, want_s in (j_rwkv.rwkv6_scan(*js, chunk=chunk,
                                             interpret=True),
                           jax_ref.ref.rwkv6_scan(*js)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y),
                                   **RWKV_TOL[dtype])
        np.testing.assert_allclose(sf.numpy(), np.asarray(want_s),
                                   **RWKV_TOL[dtype])


def test_rwkv6_scan_state_carry_composes():
    """scan(S) == scan(S/2) then scan(S/2) from the carried state, as
    ``tests/test_kernels.py::test_rwkv6_state_carry_composes`` holds the
    reference's kernel (the plain recurrence is the same sum in the same
    order, so the two agree exactly)."""
    rng = np.random.default_rng(6)
    r, k, v, lw, u, s0 = (torch.from_numpy(x) for x in
                          _rwkv_inputs(rng, 1, 64, 2, 8))
    y_all, s_all = t_ops.rwkv6_scan(r, k, v, lw, u, s0)
    h = 32
    y1, s1 = t_ops.rwkv6_scan(r[:, :h], k[:, :h], v[:, :h], lw[:, :h], u, s0)
    y2, s2 = t_ops.rwkv6_scan(r[:, h:], k[:, h:], v[:, h:], lw[:, h:], u, s1)
    assert torch.equal(torch.cat([y1, y2], 1), y_all)
    assert torch.equal(s2, s_all)


def test_rwkv6_scan_length_rule_in_both_packages(jax_ref):
    """S = 160 is neither <= 128 nor a multiple of the reference kernel's
    128-token chunk: both packages' kernel paths refuse it, with the same
    message; S = 100 (<= 128) is admitted by both."""
    jnp = jax_ref.jnp
    xs = _rwkv_inputs(np.random.default_rng(0), 1, 160, 1, 8)
    msg = "seq len 160 is not divisible by chunk 128"
    with pytest.raises(ValueError, match=msg):
        jax_ref.ops.rwkv6_scan(*(jnp.asarray(x) for x in xs))
    t_ops.reset_launches()
    with pytest.raises(ValueError, match=msg):
        t_ops.rwkv6_scan(*(torch.from_numpy(x) for x in xs))
    assert set(t_ops.launches.values()) == {0}
    short = [x[:, :100] if x.ndim == 4 and x.shape[1] == 160 else x
             for x in xs]
    y_j, _ = jax_ref.ops.rwkv6_scan(*(jnp.asarray(x) for x in short))
    y_t, _ = t_ops.rwkv6_scan(*(torch.from_numpy(np.ascontiguousarray(x))
                                for x in short))
    assert y_t.shape == (1, 100, 1, 8) == tuple(y_j.shape)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j),
                               **RWKV_TOL["float32"])


def test_rwkv6_scan_backward_recomputes_through_plain():
    """The autograd.Function's backward equals differentiating the plain
    version (the reference's custom_vjp contract)."""
    rng = np.random.default_rng(5)
    xs = [torch.from_numpy(x) for x in _rwkv_inputs(rng, 2, 12, 2, 8)]
    a = [x.clone().requires_grad_() for x in xs]
    b = [x.clone().requires_grad_() for x in xs]
    for fn, args in ((t_ops.rwkv6_scan, a), (t_ref.rwkv6_scan, b)):
        y, sf = fn(*args)
        (y.square().sum() + sf.sum()).backward()
    for x, y in zip(a, b):
        torch.testing.assert_close(x.grad, y.grad, atol=1e-6, rtol=1e-6)


def test_rwkv6_scan_launcher_refuses_what_the_kernel_does_not_take():
    from repro_torch.kernels import rwkv6_scan as k4
    xs = [torch.from_numpy(x) for x in
          _rwkv_inputs(np.random.default_rng(1), 1, 8, 2, 8)]
    with pytest.raises(ValueError, match="CUDA"):
        k4.rwkv6_scan(*xs)
    with pytest.raises(ValueError, match="no kernel for device"):
        t_ops.rwkv6_scan(*(x.to("meta") for x in xs))


# --------------------------------------- K4's order of rounding, modelled


def _fma(a, b, c):
    """a * b + c rounded once to float32 (through float64, where the
    product of two float32 values is exact), as the kernel's fmaf."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _k4_order_scan(r, k, v, lw, u, s0):
    """The WKV6 scan in the order in which K4 (``csrc/rwkv6_scan.cu``)
    rounds, in numpy float32.  Rows i = (n4 * kTpc + q) * 4 + e of a head
    fall to row group q (kTpc = D / 8 groups); per token, each group sums
    its bonus partial sum_i (r_i u_i) k_i and then, per column j, a
    partial v_j * bonus_q + sum_i r_i S[i, j], both over its rows in
    ascending order with fused multiply-adds; the kTpc partials are
    summed as a tree, halves first (the lane reduction); the state update
    is S[i, j] <- fma(e^{lw_i}, S[i, j], k_i v_j)."""
    B, S, H, D = r.shape
    tpc = D // 8

    def groups(x):              # (..., D) -> (..., n4, q, e) -> (..., q, n4*e)
        x = x.reshape(*x.shape[:-1], 2, tpc, 4)
        return np.moveaxis(x, -2, -3).reshape(*x.shape[:-3], tpc, 8)

    st = s0.copy()
    ys = np.empty_like(r)
    ru = (r * u).astype(np.float32)
    for t in range(S):
        rt, kt, vt = r[:, t], k[:, t], v[:, t]               # (B, H, D)
        w = np.exp(lw[:, t])
        g_ru, g_k, g_r = groups(ru[:, t]), groups(kt), groups(rt)
        bonus = np.zeros((B, H, tpc), np.float32)
        for m in range(8):
            bonus = _fma(g_ru[..., m], g_k[..., m], bonus)
        g_st = groups(np.swapaxes(st, -1, -2))            # (B, H, j, q, m)
        acc = (vt[..., :, None] * bonus[..., None, :]).astype(np.float32)
        for m in range(8):
            acc = _fma(g_r[..., None, :, m], g_st[..., m], acc)
        while acc.shape[-1] > 1:
            half = acc.shape[-1] // 2
            acc = acc[..., :half] + acc[..., half:]
        ys[:, t] = acc[..., 0]
        kv = (kt[..., :, None] * vt[..., None, :]).astype(np.float32)
        st = _fma(w[..., :, None], st, kv)
    return ys, st


@pytest.mark.parametrize("B,S,H,D,strong_decay", [
    # rwkv6-7b's head dim at every prompt length of the rwkv6 main path
    (1, 64, 2, 64, False), (1, 100, 2, 64, False), (1, 128, 2, 64, False),
    (1, 256, 2, 64, False), (1, 384, 2, 64, False), (1, 512, 2, 64, False),
    (1, 1024, 2, 64, False), (2, 384, 2, 64, False),
    (3, 77, 5, 64, False),                     # chip_smoke's ragged case
    # lw = -e^10: the state dies every step
    (1, 64, 2, 64, True), (1, 100, 2, 64, True), (1, 512, 2, 64, True),
    # the other head dims: 1, 2 and 4 row groups
    (1, 77, 2, 8, False), (1, 77, 2, 16, False), (1, 77, 2, 32, False),
    (1, 64, 2, 8, True), (1, 64, 2, 16, True), (1, 64, 2, 32, True),
])
def test_rwkv6_kernel_order_matches_references(jax_ref, B, S, H, D,
                                               strong_decay):
    """K4 rounds y in another order than its plain version (the bonus
    summed per row group, the lane reduction a tree): that order, modelled
    on the CPU, against the port's plain scan and the JAX reference's
    oracle within the reference's WKV tolerance."""
    rng = np.random.default_rng(S * D + B)
    xs = _rwkv_inputs(rng, B, S, H, D, strong_decay=strong_decay)
    y, sf = _k4_order_scan(*xs)
    want_y, want_s = t_ops.rwkv6_scan(*(torch.from_numpy(x) for x in xs))
    np.testing.assert_allclose(y, want_y.numpy(), **RWKV_TOL["float32"])
    np.testing.assert_allclose(sf, want_s.numpy(), **RWKV_TOL["float32"])
    jy, js = jax_ref.ref.rwkv6_scan(*(jax_ref.jnp.asarray(x) for x in xs))
    np.testing.assert_allclose(y, np.asarray(jy), **RWKV_TOL["float32"])
    np.testing.assert_allclose(sf, np.asarray(js), **RWKV_TOL["float32"])
    if strong_decay:
        # e^{-e^10} is 0 in float32: the state is the last token's k v^T
        np.testing.assert_array_equal(sf, want_s.numpy())


# ---------------------------------------------------------------- K5 ssd_scan


def _ssd_inputs(rng, B, S, I, N, strong_decay=False):
    """a in (0, 1) (sigmoid of a scaled normal, or 0.01 everywhere: the
    regime where a cumprod closed form underflows), b and h0 normal, as
    ``tests/test_kernels.py`` draws them."""
    if strong_decay:
        a = np.full((B, S, I, N), 0.01, np.float32)
    else:
        a = 1.0 / (1.0 + np.exp(-2.0 * rng.standard_normal((B, S, I, N))))
    b = 0.5 * rng.standard_normal((B, S, I, N))
    h0 = 0.2 * rng.standard_normal((B, I, N))
    return tuple(np.asarray(x, np.float32) for x in (a, b, h0))


@pytest.mark.parametrize("B,S,I,N,strong_decay", [
    (1, 32, 16, 8, False),        # the shapes of test_ssd_scan_sweep
    (2, 128, 40, 16, False),
    (1, 64, 256, 16, False),
    (1, 128, 8, 4, True),         # test_ssd_strong_decay_stable
    (2, 256, 24, 16, False),      # two 128-step chunks of the reference
])
def test_ssd_scan_plain_matches_reference(jax_ref, B, S, I, N, strong_decay):
    """ops.ssd_scan on CPU tensors (the plain sequential scan) against the
    reference's Pallas kernel in interpret mode and its own oracle."""
    from repro.kernels import ssd_scan as j_ssd
    rng = np.random.default_rng(S + I)
    a, b, h0 = _ssd_inputs(rng, B, S, I, N, strong_decay)
    t_ops.reset_launches()
    hs, hf = t_ops.ssd_scan(*(torch.from_numpy(x) for x in (a, b, h0)))
    assert t_ops.launches["ssd_scan_plain"] == 1
    assert hs.dtype == hf.dtype == torch.float32
    assert hs.shape == (B, S, I, N) and hf.shape == (B, I, N)
    ja, jb, jh = (jax_ref.jnp.asarray(x) for x in (a, b, h0))
    for want_hs, want_hf in (j_ssd.ssd_scan(ja, jb, jh, interpret=True),
                             jax_ref.ref.ssd_scan(ja, jb, jh)):
        np.testing.assert_allclose(hs.numpy(), np.asarray(want_hs),
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(hf.numpy(), np.asarray(want_hf),
                                   atol=1e-4, rtol=1e-4)


def test_ssd_scan_length_rule_raises_in_both_packages(jax_ref):
    """S = 200 is neither <= 128 nor a multiple of the reference kernel's
    128-step chunk: both packages refuse it, with the same message."""
    a, b, h0 = _ssd_inputs(np.random.default_rng(0), 1, 200, 8, 4)
    msg = "seq len 200 is not divisible by chunk 128"
    with pytest.raises(ValueError, match=msg):
        jax_ref.ops.ssd_scan(*(jax_ref.jnp.asarray(x) for x in (a, b, h0)))
    t_ops.reset_launches()
    with pytest.raises(ValueError, match=msg):
        t_ops.ssd_scan(*(torch.from_numpy(x) for x in (a, b, h0)))
    assert set(t_ops.launches.values()) == {0}


def test_ssd_scan_backward_recomputes_through_plain():
    """The autograd.Function's backward equals differentiating the plain
    version (the reference's custom_vjp contract)."""
    rng = np.random.default_rng(4)
    xs = [torch.from_numpy(x) for x in _ssd_inputs(rng, 2, 16, 6, 4)]
    a = [x.clone().requires_grad_() for x in xs]
    b = [x.clone().requires_grad_() for x in xs]
    for fn, args in ((t_ops.ssd_scan, a), (t_ref.ssd_scan, b)):
        hs, hf = fn(*args)
        (hs.square().sum() + hf.sum()).backward()
    for x, y in zip(a, b):
        torch.testing.assert_close(x.grad, y.grad, atol=1e-6, rtol=1e-6)


def test_ssd_scan_launcher_refuses_what_the_kernel_does_not_take():
    from repro_torch.kernels import ssd_scan as k5
    a, b, h0 = (torch.from_numpy(x) for x in
                _ssd_inputs(np.random.default_rng(1), 1, 8, 4, 2))
    with pytest.raises(ValueError, match="CUDA"):
        k5.ssd_scan(a, b, h0)
    with pytest.raises(ValueError, match="no kernel for device"):
        t_ops.ssd_scan(a.to("meta"), b.to("meta"), h0.to("meta"))


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels compile and run only "
                    "there (chip_smoke.py runs the same check)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,T,Hq,Hkv,D,window,softcap", [
    (4, 512, 512, 32, 32, 64, None, None),
    (2, 200, 200, 32, 32, 64, None, None),
    (2, 512, 512, 32, 32, 64, 128, None),
    (2, 512, 512, 32, 32, 64, None, 30.0),
    (2, 512, 512, 32, 8, 64, None, None),
    (1, 40, 72, 6, 3, 32, 8, 30.0),
])
def test_flash_attention_kernel_matches_plain(cuda, B, S, T, Hq, Hkv, D,
                                              window, softcap, dtype):
    td = DTYPES[dtype]
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(s, generator=gen, device=cuda).to(td)
               for s in ((B, S, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D)))
    kp = torch.arange(T, dtype=torch.int32, device=cuda)[None].expand(
        B, T).contiguous()
    qp = kp[:, T - S:].contiguous()
    t_ops.reset_launches()
    got = t_ops.flash_attention(q, k, v, qp, kp, window=window,
                                softcap=softcap)
    torch.cuda.synchronize()
    assert t_ops.launches["flash_attention"] == 1
    want = t_ref.flash_attention(q, k, v, qp, kp, window=window,
                                 softcap=softcap)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,Hq,Hkv,D", [
    (16, 1024, 32, 32, 64), (16, 1024, 32, 8, 64), (4, 48, 4, 2, 16)])
def test_decode_attention_kernel_matches_plain(cuda, B, T, Hq, Hkv, D, dtype):
    td = DTYPES[dtype]
    rng = np.random.default_rng(B + T)
    qp, kp = _rolling_cache(rng, B, T)
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(s, generator=gen, device=cuda).to(td)
               for s in ((B, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D)))
    qp, kp = torch.from_numpy(qp).to(cuda), torch.from_numpy(kp).to(cuda)
    t_ops.reset_launches()
    got = t_ops.decode_attention(q, k, v, qp, kp)
    torch.cuda.synchronize()
    assert t_ops.launches["decode_attention"] == 1
    want = t_ref.decode_attention(q, k, v, qp, kp)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,ppr,page,Hq,Hkv,D,window,softcap", [
    (16, 64, 16, 32, 32, 64, None, None),     # the paged serve's shape
    (16, 64, 16, 32, 8, 64, None, None),
    (5, 4, 16, 12, 4, 64, 13, 5.0),
    (4, 8, 8, 4, 2, 16, None, 20.0),
    (3, 6, 16, 8, 2, 128, 40, None),
])
def test_paged_decode_kernel_matches_plain_and_dense_kernel(
        cuda, B, ppr, page, Hq, Hkv, D, window, softcap, dtype):
    """K3 against its plain version, and bitwise against K2 on the
    gathered contiguous view."""
    td = DTYPES[dtype]
    rng = np.random.default_rng(B * ppr + D)
    k, v, tables, qp, kpp = (torch.from_numpy(x).to(cuda) for x in
                             _paged_pool(rng, B, ppr, page, Hkv, D))
    k, v = k.to(td), v.to(td)
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((B, Hq, D), generator=gen, device=cuda).to(td)
    t_ops.reset_launches()
    got = t_ops.paged_decode_attention(q, k, v, tables, qp, kpp,
                                       window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert t_ops.launches["paged_decode_attention"] == 1
    want = t_ref.paged_decode_attention(q, k, v, tables, qp, kpp,
                                        window=window, softcap=softcap)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    idx = tables.long()
    W = ppr * page
    dense = t_ops.decode_attention(
        q, k[idx].reshape(B, W, Hkv, D).contiguous(),
        v[idx].reshape(B, W, Hkv, D).contiguous(), qp,
        kpp[idx].reshape(B, W).contiguous(), window=window, softcap=softcap)
    assert torch.equal(got, dense)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,I,N,strong_decay", [
    (1, 512, 3200, 16, False),    # hymba-1.5b's prefill
    (1, 128, 3200, 16, True),
    (2, 1, 3200, 16, False),
    (3, 77, 40, 16, False),       # ragged: the unroll's tail, I*N % 256
])
def test_ssd_scan_kernel_matches_plain(cuda, B, S, I, N, strong_decay):
    """K5 against its plain version (bitwise equality is expected: both
    round the product and the sum separately), and the launcher's
    refusals of a wrong dtype or shape."""
    from repro_torch.kernels import ssd_scan as k5
    rng = np.random.default_rng(S + I)
    a, b, h0 = (torch.from_numpy(x).to(cuda) for x in
                _ssd_inputs(rng, B, S, I, N, strong_decay))
    t_ops.reset_launches()
    hs, hf = t_ops.ssd_scan(a, b, h0)
    torch.cuda.synchronize()
    assert t_ops.launches["ssd_scan"] == 1
    want_hs, want_hf = t_ref.ssd_scan(a, b, h0)
    torch.testing.assert_close(hs, want_hs, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(hf, want_hf, atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="float32"):
        k5.ssd_scan(a.double(), b.double(), h0.double())
    with pytest.raises(ValueError, match="shapes"):
        k5.ssd_scan(a, b[..., :1].contiguous(), h0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,D,strong_decay", [
    (1, 512, 64, 64, False),      # rwkv6-7b's prefill
    (1, 100, 64, 64, False),      # main-path lengths: a ragged span
    (1, 1024, 64, 64, False),
    (4, 256, 64, 64, False),
    (1, 1, 64, 64, False),
    (1, 128, 64, 64, True),
    (3, 77, 5, 64, False),        # ragged: a partial chunk of tokens
    (2, 128, 4, 16, False),       # the reference's sweep shapes
    (1, 32, 2, 8, False),
    (2, 64, 3, 32, False),
])
def test_rwkv6_scan_kernel_matches_plain(cuda, B, S, H, D, strong_decay,
                                         dtype):
    """K4 against its plain version within the reference's WKV tolerance
    (5e-2 for bfloat16-rounded inputs), and the launcher's refusals of a
    wrong dtype, shape, head dim or device."""
    from repro_torch.kernels import rwkv6_scan as k4
    rng = np.random.default_rng(S + D)
    xs = [torch.from_numpy(x).to(cuda) for x in
          _rwkv_inputs(rng, B, S, H, D, dtype, strong_decay)]
    t_ops.reset_launches()
    y, sf = t_ops.rwkv6_scan(*xs)
    torch.cuda.synchronize()
    assert t_ops.launches["rwkv6_scan"] == 1
    want_y, want_s = t_ref.rwkv6_scan(*xs)
    torch.testing.assert_close(y, want_y, **RWKV_TOL[dtype])
    torch.testing.assert_close(sf, want_s, **RWKV_TOL[dtype])
    with pytest.raises(ValueError, match="float32"):
        k4.rwkv6_scan(*(x.double() for x in xs))
    with pytest.raises(ValueError, match="shapes"):
        k4.rwkv6_scan(xs[0], xs[1][..., :1].contiguous(), *xs[2:])
    with pytest.raises(ValueError, match="CUDA"):
        k4.rwkv6_scan(xs[0].cpu(), *xs[1:])
    r, k, v, lw = (torch.zeros((1, 4, 2, 24), device=cuda) for _ in range(4))
    with pytest.raises(ValueError, match="head_dim"):
        k4.rwkv6_scan(r, k, v, lw, torch.zeros((2, 24), device=cuda),
                      torch.zeros((1, 2, 24, 24), device=cuda))


@pytest.mark.gpu
def test_rwkv6_scan_kernel_state_carry_composes(cuda):
    """scan(512) against scan(256) then scan(256) from the carried state,
    on the card."""
    rng = np.random.default_rng(7)
    r, k, v, lw, u, s0 = (torch.from_numpy(x).to(cuda) for x in
                          _rwkv_inputs(rng, 1, 512, 64, 64))
    y_all, s_all = t_ops.rwkv6_scan(r, k, v, lw, u, s0)
    halves = [tuple(t[:, sl].contiguous() for t in (r, k, v, lw))
              for sl in (slice(0, 256), slice(256, 512))]
    y1, s1 = t_ops.rwkv6_scan(*halves[0], u, s0)
    y2, s2 = t_ops.rwkv6_scan(*halves[1], u, s1)
    torch.cuda.synchronize()
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_all,
                               **RWKV_TOL["float32"])
    torch.testing.assert_close(s2, s_all, **RWKV_TOL["float32"])


@pytest.mark.gpu
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("case", [
    "ragged", "short", "noncausal", "window-edge", "shuffled", "masked-rows"])
def test_flash_attention_tensor_core_cases(cuda, case, D):
    """K1's bfloat16 path (wgmma + TMA) against its plain version at every
    head dim: S and T off the 64-row tile, fewer rows than a tile, a
    window edge inside a fragment, kv positions out of slot order, and
    fully masked rows (exactly zero)."""
    B, S, T, Hq, Hkv, causal, window = 2, 77, 77, 4, 2, True, None
    if case == "short":
        S = T = 5
    elif case == "noncausal":
        S, T, causal = 100, 130, False
    elif case == "window-edge":
        S = T = 200
        window = 37                   # ends mid-way through an 8-col block
    elif case == "shuffled":
        S = T = 150
    gen = torch.Generator(device=cuda).manual_seed(D)
    q, k, v = (torch.randn(sh, generator=gen, device=cuda).to(torch.bfloat16)
               for sh in ((B, S, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D)))
    kp = torch.arange(T, dtype=torch.int32)[None].repeat(B, 1)
    qp = kp[:, T - S:].clone()
    if case == "shuffled":            # slots hold positions in any order
        cpu = torch.Generator().manual_seed(D)
        for b in range(B):
            kp[b] = kp[b, torch.randperm(T, generator=cpu)]
        kp[1, ::7] = -1
    if case == "masked-rows":
        kp[:, :40] = -1               # queries 0..39 see no valid key
    qp, kp = qp.to(cuda), kp.to(cuda)
    t_ops.reset_launches()
    got = t_ops.flash_attention(q, k, v, qp, kp, causal=causal,
                                window=window)
    torch.cuda.synchronize()
    assert t_ops.launches["flash_attention"] == 1
    want = t_ref.flash_attention(q, k, v, qp, kp, causal=causal,
                                 window=window)
    torch.testing.assert_close(got.float(), want.float(),
                               **_tol("bfloat16"))
    if case == "masked-rows":
        assert torch.count_nonzero(got[:, :40]) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,T,C", [
    (16, 32, 32, 1024, 1),        # stablelm's cloud step
    (16, 10, 10, 512, 2),
    (16, 25, 5, 1024, 4),         # hymba's cloud step
    (2, 25, 5, 1024, 8),          # hymba's edge step
])
def test_decode_split_over_cluster_matches_plain(cuda, B, Hq, Hkv, T, C,
                                                 dtype):
    """K2 and K3 at shapes the launcher splits over clusters of 1, 2, 4 and
    8 blocks: each against its plain version (row 0 is empty and must come
    out zero), and K3 bitwise equal to K2 on the gathered view."""
    D, page = 64, 16
    assert t_dec.split(B, Hkv, t_dec.head_chunks(Hq, Hkv), T)[0] == C
    td = DTYPES[dtype]
    rng = np.random.default_rng(B + Hq + T)
    k, v, tables, qp, kpp = (torch.from_numpy(x).to(cuda) for x in
                             _paged_pool(rng, B, T // page, page, Hkv, D))
    k, v = k.to(td), v.to(td)
    q = torch.from_numpy(rng.standard_normal((B, Hq, D)).astype(
        np.float32)).to(cuda).to(td)
    idx = tables.long()
    kd, vd = (x[idx].reshape(B, T, Hkv, D).contiguous() for x in (k, v))
    kpd = kpp[idx].reshape(B, T).contiguous()
    t_ops.reset_launches()
    dense = t_ops.decode_attention(q, kd, vd, qp, kpd)
    paged = t_ops.paged_decode_attention(q, k, v, tables, qp, kpp)
    torch.cuda.synchronize()
    assert t_ops.launches["decode_attention"] == 1
    assert t_ops.launches["paged_decode_attention"] == 1
    assert t_dec.last_split["decode_attention"][0] == C
    assert t_dec.last_split["paged_decode_attention"][0] == C
    want = t_ref.decode_attention(q, kd, vd, qp, kpd)
    torch.testing.assert_close(dense.float(), want.float(), **_tol(dtype))
    assert torch.count_nonzero(dense[0]) == 0
    assert torch.equal(paged, dense)
