"""A rehearsal of the harness on the CPU: each cell end to end at a tiny
size (the port's plain kernel versions, float32), traced, with the
last line's keys checked, and every per-layer reader over the traced
run.  A CPU run prints no device metric."""

import json

import pytest

from pbench import bench


@pytest.mark.parametrize("name", ["stablelm-1.6b.batch-long",
                                  "qwen2-moe-a2.7b.batch-decode"])
def test_cpu_rehearsal(tiny_cell, name):
    cell, over = tiny_cell(name)
    lines = []
    stash = {}
    out = bench.run_cell(cell, 2**31 + 9, 6.0, True, device="cpu",
                         overrides=over, stash=stash,
                         log=lambda *a, **k: lines.append(a[0]))
    json.dumps(out)
    assert list(out)[:3] == ["correct", "attempted", "failed"]
    assert list(out)[-1] == "checks"
    assert set(out) >= {"correct", "attempted", "failed", "metrics",
                        "device"}
    assert out["metrics"] == {}                       # no device numbers
    assert out["device"]["platform"] == "cpu"
    assert "busy_s" not in out["device"] and "breakdown" not in out
    assert out["correct"] is True and out["attempted"] > 0, out["checks"]
    from pbench import correct
    compared = [k for k in out["checks"] if k in correct.COMPARED]
    assert compared == [k for k in correct.COMPARED if k in cell.limits]
    assert all(out["checks"][k]["value"] == 0.0 for k in compared)
    assert lines[-1].startswith("check malformed_outputs")
    # the per-layer readers ran over the CPU trace
    assert {k.split(".")[0] for k in out["cpu_metrics"]} >= {
        "device_idle", "mfu"}
    _every_reader_reads(stash["run"])
    picked = stash["picked"]
    assert picked and sum(len(s.req.output) for s in picked) >= min(
        cell.traffic["sample_tokens"], sum(s.plan.max_new for s in picked))


def _every_reader_reads(run):
    """Every reader file of ``port_bench/metrics`` runs over ``run`` and
    gives a number or nothing."""
    from pbench import spec
    got = {}
    for path in sorted((spec.BENCH_DIR / "metrics").glob("*.py")):
        v = spec.load_reader(path.name[:-3])(run)
        assert v is None or isinstance(v, float), (path.name, v)
        got[path.name[:-3]] = v
    return got
