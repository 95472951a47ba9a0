"""The harness, with the timed path broken underneath, decides
``correct`` false: each fault a served cell can have
(:mod:`pbench.faults`), planted in the port's decode path of a CPU
rehearsal (the look for a card skipped), against the cell's committed
limit."""

import numpy as np
import pytest

from pbench import bench, correct, faults, spec


@pytest.mark.parametrize("name", ["stablelm-1.6b.batch-long",
                                  "qwen2-moe-a2.7b.batch-decode"])
@pytest.mark.parametrize("fault", ["token", "half_batch", "state"])
def test_a_broken_path_is_not_correct(tiny_cell, name, fault):
    cell, over = tiny_cell(name)
    # the mix's own output lengths: a state left unchanged drifts from the
    # reference with every step, and a tiny model's short outputs hide it
    mix = spec.Cell(spec.load_benchmark(), name).traffic
    cell.traffic = dict(cell.traffic, max_new=mix["max_new"], drain_cap_s=180.0,
                        sample_tokens=mix["sample_tokens"])
    with faults.planted(fault) as plant:
        out = bench.run_cell(cell, 2**31 + 21, 3.0, False, device="cpu",
                             overrides=over, fault=plant,
                             log=lambda *a, **k: None)
    failed = [k for k in correct.COMPARED if k in out["checks"]
              and np.isfinite(out["checks"][k]["value"])
              and out["checks"][k]["value"] > out["checks"][k]["limit"]]
    assert failed, out["checks"]
    assert out["correct"] is False
