"""The control comes out as not correct: the plain reference in fp8
(e4m3 weights, per output channel), put in the program's place, judged
on the same prompts and served tokens as the program.

On the CPU, at a size a test run holds (two layers, width 256, bf16
program), its readings must lie well above the program's; on the card
(``gpu``), at the cell's own size, it must fail the cell's committed
limit while the program passes it.  ``port_bench/calibrate.py`` reads
both over many seeds; these keep the check alive."""

import pytest

from pbench import bench, correct

SMALL = dict(torch_dtype="bfloat16", hidden_size=256, head_dim=64,
             intermediate_size=512, vocab_size=4096)
SMALL_MOE = dict(moe_intermediate_size=128, shared_expert_intermediate_size=256)


@pytest.mark.parametrize("name", ["stablelm-1.6b.batch-long",
                                  "qwen2-moe-a2.7b.batch-decode"])
def test_control_reads_far_above_the_program_on_cpu(tiny_cell, name):
    cell, over = tiny_cell(name)
    # outputs a CPU finishes in a few seconds at this width
    cell.traffic = dict(cell.traffic, max_new=[24, 48], sample_tokens=240)
    over = {**over, **SMALL}
    if "moe_intermediate_size" in over:
        over.update(SMALL_MOE)
    st = {}
    bench.run_cell(cell, 2**31 + 31, 3.0, False, device="cpu",
                   overrides=over, stash=st, log=lambda *a, **k: None)
    ctl = correct.control_gaps(st["conf"], st["params"], st["picked"], "cpu",
                               quant="fp8")
    prog = st["gaps"]
    for k in [k for k in cell.limits if k in correct.COMPARED]:
        assert ctl[k] > 3 * prog[k], (k, ctl, prog)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["stablelm-1.6b.batch-long",
                                  "qwen2-moe-a2.7b.batch-decode"])
def test_control_fails_the_cells_limit_on_the_card(card, name):
    from pbench import spec
    cell = spec.Cell(spec.load_benchmark(), name)
    st = {}
    out = bench.run_cell(cell, 2**31 + 41, 10.0, False, stash=st,
                         log=lambda *a, **k: None)
    assert out["correct"] is True
    ctl = correct.control_gaps(st["conf"], st["params"], st["picked"], card,
                               quant=cell.limits["control"])
    assert any(ctl[k] > v for k, v in cell.limits.items()
               if k in correct.COMPARED)
