"""The benchmark's own CPU tests: ``python -m pytest port_bench/tests``
from the repository root.  A test that needs the card is marked ``gpu``
and skips without one."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "port_bench", ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import pytest  # noqa: E402

#: a configuration's widths cut to what a CPU test holds (float32)
TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=4, head_dim=16, intermediate_size=128,
            vocab_size=256, torch_dtype="float32",
            tiers={"edge_slots": 2, "cloud_slots": 4, "max_len": 1024,
                   "kpa_scale": 2, "kpa_target_concurrency": 2.0})
TINY_MOE = dict(num_experts=8, num_experts_per_tok=2,
                moe_intermediate_size=32, shared_expert_intermediate_size=64)


def tiny(name: str):
    """Cell ``name`` of ``BENCHMARK.json`` with its traffic scaled to a CPU
    run (short pre-roll, a few clients, prompts of at most 512 tokens and
    outputs of at most 64) and the overrides that shrink its model."""
    from pbench import spec
    cell = spec.Cell(spec.load_benchmark(), name)
    (p_lo, p_hi), (lo, hi) = cell.traffic["prompt_len"], cell.traffic["max_new"]
    cell.traffic = dict(cell.traffic, preroll_s=1.0, drain_cap_s=60.0,
                        stagger_s=0.5, clients=6,
                        prompt_len=[min(p_lo, 256), min(p_hi, 512)],
                        max_new=[min(lo, 64), min(hi, 64)],
                        sample_tokens=min(cell.traffic["sample_tokens"], 240))
    over = dict(TINY)
    if cell.config["family"] == "moe":
        over.update(TINY_MOE)
    return cell, over


@pytest.fixture
def tiny_cell():
    return tiny


@pytest.fixture(autouse=True)
def few_threads():
    """One process, few threads: a rehearsal's clock-driven loop keeps
    time on a shared CPU."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 4))
    yield
    torch.set_num_threads(before)
