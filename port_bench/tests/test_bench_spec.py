"""The harness finds every cell, mix, configuration, limit and per-layer
metric of ``BENCHMARK.json`` by name, and its generator gives every seed
the same work."""

import json

import pytest

from pbench import spec, traffic

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_its_files(name):
    cell = spec.Cell(BENCH, name)
    assert cell.config["name"] == cell.entry["config"]
    assert cell.traffic["clients"] > 0
    from pbench import correct
    compared = [k for k in cell.limits if k in correct.COMPARED]
    assert compared and all(cell.limits[k] > 0 for k in compared)
    assert cell.limits["control"] == "fp8"
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader(name):
    assert callable(spec.load_reader(name))


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        spec.Cell(BENCH, "no-such.cell")
    with pytest.raises(FileNotFoundError):
        spec.load_reader("no_such_metric.batch")


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_match_their_entries(cfg):
    conf = json.loads((spec.ROOT / cfg["file"]).read_text())
    assert conf["name"] == cfg["name"] and conf["source"] == cfg["source"]
    for key in cfg["reduced"]:
        assert key in conf["changed_from_source"]


def test_max_len_holds_the_longest_request():
    cell = spec.Cell(BENCH, "stablelm-1.6b.batch-long")
    assert cell.max_len() == 2112 and cell.max_len() % 64 == 0
    assert spec.Cell(BENCH, "qwen2-moe-a2.7b.batch-decode").max_len() == 1024


def test_closed_loop_seeds_share_the_work():
    mix = {"clients": 5, "prompt_len": [1024, 2048], "max_new": [32, 32],
           "base_seed": 4, "stagger_s": 5.0}
    a = traffic.closed_sizes(mix, 1, per_client=8)
    b = traffic.closed_sizes(mix, 2, per_client=8)
    assert sorted(map(sorted, a)) == sorted(map(sorted, b))
    assert a != b
    assert traffic.client_start(mix, 4) == 4.0


def test_prompt_tokens_follow_the_seed_only():
    x = traffic.prompt_tokens(2**31 + 3, 7, 50, 1000)
    assert (x == traffic.prompt_tokens(2**31 + 3, 7, 50, 1000)).all()
    assert not (x == traffic.prompt_tokens(2**31 + 4, 7, 50, 1000)).all()
    assert x.min() >= 0 and x.max() < 1000 and len(x) == 50
