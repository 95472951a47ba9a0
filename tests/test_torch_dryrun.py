"""The port's dry run (``launch/dryrun.py``, ``launch/train_cost.py``)
against the reference's, on the CPU.

* ``model_flops``, ``input_specs``, ``SHAPES`` and ``valid_cells`` equal
  the reference's for every architecture and shape.
* The closed-form counts against a live lowering of the reference's
  sharded train step: the reduced qwen2.5 config of
  ``tests/test_sharding_dryrun.py:158-199`` (2 layers, d_model 64, 4/2
  heads, head_dim 16, d_ff 128, vocab 256, batch (8, 32)) on a (2, 2)
  mesh with ``Auto`` axes (``jax.sharding.Mesh`` over 4 forced host
  devices; ``jax.make_mesh``'s ``Explicit`` axes refuse the reference's
  sharding constraints on this jax), compiled in a subprocess.  The
  per-device argument bytes equal the reference's exactly (323,972),
  the matmul FLOPs of the reference's schedule equal its
  ``mxu_flops_per_device`` exactly (46,170,112), ``model_flops / 4``
  equals its 42,688,512, and the port's eager step runs 9.0 % more
  matmul FLOPs (each layer's last product and the CE head's logits
  recomputed by ``torch.utils.checkpoint``, less the one-hot
  contraction the port gathers instead).
* The launcher prints the reference's line for every train cell of both
  production meshes and writes their JSON.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro import configs as j_configs
from repro.launch import hlo_analysis
from repro_torch import configs as t_configs
from repro_torch.launch import dryrun, train_cost
from repro_torch.training import train_loop as t_loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REDUCED = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
               head_dim=16, d_ff=128, vocab_size=256)


def test_shapes_and_cells_match_reference():
    assert sorted(t_configs.ARCHS) == sorted(j_configs.ARCHS)
    assert {k: dataclasses.astuple(v) for k, v in t_configs.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in j_configs.SHAPES.items()}
    assert t_configs.LONG_CONTEXT_ARCHS == j_configs.LONG_CONTEXT_ARCHS
    assert sorted(t_configs.valid_cells()) == sorted(j_configs.valid_cells())


@pytest.mark.parametrize("arch", t_configs.ARCHS)
def test_model_flops_and_input_specs_match_reference(arch):
    cfg_j, cfg_t = j_configs.get_config(arch), t_configs.get_config(arch)
    for name, sh in t_configs.SHAPES.items():
        tokens = sh.global_batch * (sh.seq_len if sh.kind != "decode" else 1)
        assert train_cost.model_flops(
            cfg_t, sh.kind, tokens, seq_len=sh.seq_len,
            batch=sh.global_batch) == hlo_analysis.model_flops(
            cfg_j, sh.kind, tokens, seq_len=sh.seq_len,
            batch=sh.global_batch), name
        got = t_configs.input_specs(cfg_t, sh)
        want = j_configs.input_specs(cfg_j, j_configs.SHAPES[name])
        assert list(got) == list(want), name
        for k, v in got.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(want[k].shape), (name, k)
            assert str(v.dtype).replace("torch.", "") == str(
                np.dtype(want[k].dtype)), (name, k)


_LOWER = textwrap.dedent("""\
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, json
    import jax, jax.numpy as jnp, numpy as np
    from repro import configs, sharding as shlib
    from repro.launch import hlo_analysis, sharding as rules_lib
    from repro.training import train_loop

    # Auto axes: jax.make_mesh's Explicit ones refuse shd's constraints
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 2),
                             ("data", "model"))
    cfg = dataclasses.replace(configs.get_smoke_config("qwen2.5-14b"),
                              **REDUCED)
    tcfg = train_loop.TrainConfig()
    state = train_loop.abstract_state(cfg, tcfg)
    state_sh = rules_lib.train_state_shardings(cfg, mesh)
    batch = {"tokens": jax.ShapeDtypeStruct((8, 32), jnp.int32),
             "labels": jax.ShapeDtypeStruct((8, 32), jnp.int32)}
    batch_sh = rules_lib.batch_shardings(batch, mesh)
    arules = rules_lib.act_rules(mesh, "train")
    step = train_loop.make_train_step(cfg, tcfg,
                                      grad_shardings=state_sh.params)

    def wrapped(s, b):
        with shlib.use_rules(arules):
            return step(s, b)

    with mesh:
        compiled = jax.jit(wrapped, in_shardings=(state_sh, batch_sh),
                           out_shardings=(state_sh, None),
                           donate_argnums=(0,)).lower(state, batch).compile()
    roof, detail = hlo_analysis.roofline_from_compiled(compiled, 4)
    mf = hlo_analysis.model_flops(cfg, "train", 8 * 32, seq_len=32, batch=8)
    print(json.dumps({
        "args": compiled.memory_analysis().argument_size_in_bytes,
        "mxu": roof.mxu_flops_per_device, "mf": mf / 4,
        "coll": detail["collectives"]["total"]}))
""")


def test_counts_match_reference_lowering():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run(
        [sys.executable, "-c", _LOWER.replace("**REDUCED",
                                              f"**{REDUCED!r}")],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    ref = json.loads(res.stdout.strip().splitlines()[-1])
    assert ref["args"] == 323_972 and ref["mxu"] == 46_170_112

    cfg = dataclasses.replace(t_configs.get_smoke_config("qwen2.5-14b"),
                              **REDUCED)
    c = train_cost.train_step_counts(
        cfg, t_loop.TrainConfig(), {"data": 2, "model": 2},
        t_configs.ShapeSpec("reduced", "train", 32, 8))
    assert c["argument_bytes"] == ref["args"]
    assert c["mxu_flops_per_device"] == ref["mxu"]
    assert c["model_flops_per_device"] == ref["mf"] == 42_688_512
    # the eager step: + each layer's mlp/wo (2 x 4,194,304) and the CE
    # head (8,388,608) recomputed, - the one-hot contraction (131,072)
    assert c["port_mxu_flops_per_device"] * 4 == (
        ref["mxu"] * 4 + 2 * 4_194_304 + 8_388_608 - 131_072)
    gap = c["port_mxu_flops_per_device"] / ref["mxu"] - 1
    assert round(gap, 4) == 0.0901


def test_dryrun_prints_every_train_cell(tmp_path, capsys):
    out = dryrun.main(["--all", "--out-dir", str(tmp_path)])
    train = [a for a, s in t_configs.valid_cells() if s == "train_4k"]
    assert [(r["mesh"], r["arch"]) for r in out] == (
        [("single", a) for a in train] + [("multi", a) for a in train])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 * len(train)
    assert all(": OK closed-form mem/dev=" in l and "dominant=" in l
               for l in lines)
    for r in out:
        saved = json.loads((tmp_path / r["mesh"] /
                            f"{r['arch']}__train_4k.json").read_text())
        assert saved["counts"] == "closed-form"
        assert saved["chips"] == (256 if r["mesh"] == "single" else 512)
        assert saved["hardware"] == "NVIDIA H100 SXM5 80GB, 700 W"
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "qwen2.5-14b", "--shape", "decode_32k",
                     "--out-dir", str(tmp_path)])
