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
* The closed-form serve counts against a live lowering of the
  reference's prefill and decode serve steps (its dry run's
  ``make_serve_step`` under the ``"serve"`` activation rules): the same
  reduced config, batch 8, prompt 32, cache 64, on the same (2, 2)
  ``Auto`` mesh, params under ``"serve"`` and ``"serve_replicated"``.
  The argument bytes (params, cache, inputs) and the matmul FLOPs a
  device equal the lowering's exactly in all four programs.
* The launcher prints the reference's line for every valid cell of both
  production meshes (train, prefill and decode) and writes their JSON;
  each decode record has ``decode_step_ms``; ``--serve-mode auto``,
  ``--set``, ``--accum`` and ``--tag`` act as the reference's do.
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
from repro_torch.launch import dryrun, serve_cost, train_cost
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


_LOWER_SERVE = textwrap.dedent("""\
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, json
    import jax, jax.numpy as jnp, numpy as np
    from repro import configs, sharding as shlib
    from repro.launch import hlo_analysis, sharding as rules_lib
    from repro.models import model_zoo
    from repro.serving import engine

    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 2),
                             ("data", "model"))
    cfg = dataclasses.replace(configs.get_smoke_config("qwen2.5-14b"),
                              **REDUCED)
    B, S, T = 8, 32, 64
    arules = rules_lib.act_rules(mesh, "serve")
    params = model_zoo.abstract_params(cfg)
    cache = model_zoo.init_cache(cfg, B, T, abstract=True)
    cache_sh = rules_lib.cache_shardings(cfg, cache, mesh, "serve")
    batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    batch_sh = rules_lib.batch_shardings(batch, mesh)
    tok = jax.ShapeDtypeStruct((B,), jnp.int32)
    tok_sh = rules_lib.batch_shardings({"tokens": tok}, mesh)["tokens"]
    pre = engine.make_serve_step(cfg, "prefill")
    dec = engine.make_serve_step(cfg, "decode")

    def p_step(p, b, c):
        with shlib.use_rules(arules):
            return pre(p, b, c)

    def d_step(p, c, tk, t):
        with shlib.use_rules(arules):
            return dec(p, c, tk, t)

    out = {}
    for mode in ("serve", "serve_replicated"):
        params_sh = rules_lib.param_shardings(cfg, mesh, mode)
        with mesh:
            progs = {
                "prefill": jax.jit(
                    p_step, in_shardings=(params_sh, batch_sh, cache_sh),
                    out_shardings=(None, cache_sh), donate_argnums=(2,)
                ).lower(params, batch, cache).compile(),
                "decode": jax.jit(
                    d_step, in_shardings=(params_sh, cache_sh, tok_sh,
                                          tok_sh),
                    out_shardings=(None, cache_sh), donate_argnums=(1,)
                ).lower(params, cache, tok, tok).compile()}
        for kind, c in progs.items():
            roof, _ = hlo_analysis.roofline_from_compiled(c, 4)
            out[mode + "/" + kind] = {
                "args": c.memory_analysis().argument_size_in_bytes,
                "mxu": roof.mxu_flops_per_device}
    print(json.dumps(out))
""")


def test_serve_counts_match_reference_lowering():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run(
        [sys.executable, "-c", _LOWER_SERVE.replace("**REDUCED",
                                                    f"**{REDUCED!r}")],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    ref = json.loads(res.stdout.strip().splitlines()[-1])

    cfg = dataclasses.replace(t_configs.get_smoke_config("qwen2.5-14b"),
                              **REDUCED)
    mesh = {"data": 2, "model": 2}
    shapes = {"prefill": (t_configs.ShapeSpec("p", "prefill", 32, 8),
                          dict(cache_len=64)),
              "decode": (t_configs.ShapeSpec("d", "decode", 64, 8), {})}
    for mode in ("serve", "serve_replicated"):
        for kind, (shape, kw) in shapes.items():
            c = serve_cost.serve_step_counts(cfg, mesh, shape,
                                             serve_mode=mode, **kw)
            want = ref[f"{mode}/{kind}"]
            assert c["argument_bytes"] == want["args"], (mode, kind)
            assert c["mxu_flops_per_device"] == want["mxu"], (mode, kind)
            # nothing recomputed in a serve step: the port runs the
            # products the reference schedules
            assert c["port_mxu_flops_per_device"] == want["mxu"]
    # float32 reduced weights: the "serve" layout splits every weight
    # four ways, "serve_replicated" only over "model"; the cache (k, v
    # (2, 8, 64, 2, 16) float32 and pos) splits rows over "data" and
    # positions over "model"
    assert ref["serve/prefill"]["args"] == 107_648 + 66_560 + 512
    assert ref["serve_replicated/prefill"]["args"] == (214_784 + 66_560
                                                        + 512)
    assert ref["serve/decode"]["mxu"] == 425_984


def test_dryrun_prints_every_train_cell(tmp_path, capsys):
    out = dryrun.main(["--all", "--out-dir", str(tmp_path)])
    cells = t_configs.valid_cells()
    assert [(r["mesh"], r["arch"], r["shape"]) for r in out] == (
        [("single", a, s) for a, s in cells]
        + [("multi", a, s) for a, s in cells])
    train = [a for a, s in cells if s == "train_4k"]
    assert sum(r["kind"] == "train" for r in out) == 2 * len(train)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 * len(cells)
    assert all(": OK closed-form mem/dev=" in l and "dominant=" in l
               for l in lines)
    for r in out:
        saved = json.loads((tmp_path / r["mesh"] /
                            f"{r['arch']}__{r['shape']}.json").read_text())
        assert saved["counts"] == "closed-form"
        assert saved["chips"] == (256 if r["mesh"] == "single" else 512)
        assert saved["hardware"] == "NVIDIA H100 SXM5 80GB, 700 W"
        assert saved["kind"] == t_configs.SHAPES[r["shape"]].kind
        if saved["kind"] == "decode":
            assert saved["decode_step_ms"] == pytest.approx(
                saved["roofline"]["step_s"] * 1e3)
            assert saved["decode_step_ms"] > 0
        if saved["kind"] != "train":
            assert saved["serve_mode"] == "serve"
            assert saved["argument_bytes"] == (
                saved["params_bytes"] + saved["cache_bytes"]
                + saved["input_bytes"])


def test_dryrun_serve_options(tmp_path, capsys):
    """``--serve-mode auto`` takes the reference's rule (stablelm's 16th
    of 3.3 GB replicates, llama3-405b's shards); ``--set`` coerces as the
    reference does; ``--tag`` suffixes the file; ``--accum`` reaches a
    train cell."""
    for arch, want in (("stablelm-1.6b", "serve_replicated"),
                       ("llama3-405b", "serve")):
        r, = dryrun.main(["--arch", arch, "--shape", "decode_32k", "--mesh",
                          "single", "--serve-mode", "auto", "--out-dir",
                          str(tmp_path)])
        assert r["serve_mode"] == want
    r, = dryrun.main(["--arch", "stablelm-1.6b", "--shape", "prefill_32k",
                      "--mesh", "single", "--set", "num_layers=2",
                      "--set", "remat=False", "--tag", "two",
                      "--out-dir", str(tmp_path)])
    full, = dryrun.main(["--arch", "stablelm-1.6b", "--shape", "prefill_32k",
                         "--mesh", "single", "--out-dir", str(tmp_path)])
    assert (tmp_path / "single" / "stablelm-1.6b__prefill_32k__two.json"
            ).exists()
    assert r["cache_bytes"] * 12 == full["cache_bytes"]     # 2 of 24 layers
    cfg = dryrun.apply_sets(t_configs.get_config("stablelm-1.6b"),
                            ["num_layers=2", "rope_theta=5e4",
                             "remat=False", "name=x"])
    assert (cfg.num_layers, cfg.rope_theta, cfg.remat, cfg.name) == (
        2, 50000.0, False, "x")
    r, = dryrun.main(["--arch", "stablelm-1.6b", "--shape", "train_4k",
                      "--mesh", "single", "--accum", "4", "--out-dir",
                      str(tmp_path)])
    assert r["accum_steps"] == 4
    long_cells = [s for a, s in t_configs.valid_cells()
                  if a == "rwkv6-7b"]
    assert "long_500k" in long_cells
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "qwen2.5-14b", "--shape", "long_500k",
                     "--out-dir", str(tmp_path)])
