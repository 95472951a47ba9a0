"""The count functions against hand-worked cases: the byte bounds that
the kernel table of ``PERF.md`` gives at its shapes (K1, K2 at
stablelm's and qwen2-moe's heads), operations, the roofline's term, and
``mfu``'s active parameters against the port's own parameter table."""

import json

import pytest

from pbench import counts, spec

PEAKS = spec.peaks()


def conf(name):
    return json.loads((spec.BENCH_DIR / "configs" / f"{name}.json").read_text())


def bound_ms(f_b):
    return counts.roofline_s(*f_b, PEAKS)[0] * 1e3


@pytest.mark.parametrize("name, lengths, want", [
    ("stablelm-1.6b", [512], 0.0025053),     # K1, S = T = 512
    ("stablelm-1.6b", [256], 0.0012526),
    ("stablelm-1.6b", [128], 0.00062632),
    ("qwen2-moe-a2.7b", [512], 0.0025053),   # Hq = Hkv = 16, D = 128
])
def test_k1_bytes_bound_matches_the_kernel_table(name, lengths, want):
    f, b = counts.k1_counts(conf(name), lengths)
    assert counts.roofline_s(f, b, PEAKS)[1] == "bytes"
    assert bound_ms((f, b)) == pytest.approx(want, rel=5e-5)


@pytest.mark.parametrize("name, rows, live, want", [
    ("stablelm-1.6b", 16, 3927, 0.0096617),
    ("stablelm-1.6b", 2, 527, 0.0012961),
    ("qwen2-moe-a2.7b", 16, 4154, 0.010217),
    ("qwen2-moe-a2.7b", 2, 663, 0.0016286),
])
def test_k2_bytes_bound_matches_the_kernel_table(name, rows, live, want):
    # the table's rows hold ``live`` keys in all; the split over rows
    # does not change a byte count
    per = [live // rows] * rows
    per[0] += live - sum(per)
    f, b = counts.k2_counts(conf(name), rows, 1024, per)
    assert bound_ms((f, b)) == pytest.approx(want, rel=5e-5)


def test_k1_operations_by_hand():
    c = conf("stablelm-1.6b")
    f, _ = counts.k1_counts(c, [3])
    # 3 queries, causal: 1 + 2 + 3 = 6 pairs, 4 * D ops per pair per head
    assert f == 4 * 64 * 32 * 6
    f2, b2 = counts.k1_counts(c, [3, 5])
    assert f2 == f + 4 * 64 * 32 * 15
    assert b2 == (3 + 5) * (2 * 32 + 2 * 32) * 64 * 2 + 2 * (3 + 5) * 4


def test_k2_counts_dead_rows_read_q_and_positions_only():
    c = conf("qwen2-moe-a2.7b")
    f, b = counts.k2_counts(c, 4, 100, [10])
    assert f == 4 * 128 * 16 * 10
    assert b == (2 * 4 * 16 * 128 * 2 + 4 * 4 + 4 * 100 * 4
                 + 2 * 10 * 16 * 128 * 2)


def test_roofline_names_the_larger_term():
    peaks = {"flops_per_s": {"bfloat16": 1e12}, "hbm_bytes_per_s": 1e9}
    assert counts.roofline_s(2e12, 1e9, peaks) == (2.0, "operations")
    assert counts.roofline_s(1e12, 3e9, peaks) == (3.0, "bytes")


@pytest.mark.parametrize("name", ["stablelm-1.6b", "qwen2-moe-a2.7b"])
def test_active_params_match_the_ports_table(name):
    from pbench import model
    c = conf(name)
    cfg = model.model_config(c)
    p = counts.active_params(c)
    d, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    # the port's count adds the embedding, norms and biases
    norms = 2 * L + 1
    extra = V * d + norms * d * (2 if cfg.norm_type == "layernorm" else 1)
    if cfg.qkv_bias:
        extra += L * (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    assert p["body"] + p["head"] + extra == cfg.active_param_count()


def test_step_flops_by_hand():
    c = conf("stablelm-1.6b")
    p = counts.active_params(c)
    one = counts.step_flops(c, [], [5])
    assert one == 2 * p["body"] + 2 * p["head"] + 24 * 4 * 64 * 32 * 5
    pre = counts.step_flops(c, [4], [])
    assert pre == (2 * p["body"] * 4 + 2 * p["head"]
                   + 24 * 4 * 64 * 32 * 10)
