"""Package rules of the PyTorch port.

* ``repro_torch`` (and ``chip_smoke.py``) import neither JAX nor anything
  of the reference package ``repro``;
* entry points default to ``device="cuda"`` and raise without a card
  instead of falling back to the CPU; ``device="cpu"`` works;
* the CUDA kernel launchers refuse CPU tensors, and ``chip_smoke.py``
  fails without a card or without the package beside it.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _modules():
    out = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(REPO / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_importing_every_module_pulls_in_no_jax_and_no_repro():
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(repr(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, cwd=REPO)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in
    list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]))
def test_no_source_imports_jax_or_repro(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for n in names:
            assert not _forbidden(n), f"{path}:{node.lineno} imports {n}"


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA card")


def _smoke():
    from repro_torch import configs
    from repro_torch.models import model_zoo
    cfg = configs.get_smoke_config("stablelm-1.6b")
    return cfg, model_zoo.init(cfg, torch.Generator().manual_seed(0))


def test_default_device_raises_without_a_card(no_card):
    from repro_torch.device import resolve
    from repro_torch.platform import Continuum, TierConfig
    from repro_torch.serving.engine import Endpoint
    from repro_torch.serving.tiers import Tier
    cfg, params = _smoke()
    with pytest.raises(RuntimeError, match="cuda"):
        resolve()
    with pytest.raises(RuntimeError, match="cuda"):
        Endpoint(cfg, params)
    with pytest.raises(RuntimeError, match="cuda"):
        Continuum(edge=TierConfig(), cloud=TierConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        Tier("edge", TierConfig())


def test_cpu_device_works_when_asked(no_card):
    from repro_torch.platform import Continuum, FunctionSpec, Request, \
        TierConfig
    from repro_torch.serving.engine import Endpoint
    cfg, params = _smoke()
    ep = Endpoint(cfg, params, slots=2, max_len=16, device="cpu")
    s = ep.try_claim()
    first = ep.prefill_batch({s: np.arange(5, dtype=np.int32)})[s]
    assert 0 <= first < cfg.vocab_size
    cc = Continuum(edge=TierConfig(slots=1, max_len=16),
                   cloud=TierConfig(slots=2, max_len=16), device="cpu")
    cc.deploy(FunctionSpec(name="fn", arch="stablelm-1.6b"), cfg, params)
    req = Request(rid=0, tokens=np.arange(4, dtype=np.int32), max_new=3)
    cc.submit("fn", req)
    cc.drain()
    assert req.output is not None and req.output.shape == (3,)


def test_serve_launcher_runs_on_cpu_and_refuses_missing_card(no_card):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--rounds", "3"]
    res = subprocess.run(cmd + ["--device", "cpu"], capture_output=True,
                         text=True, env=env, timeout=300, cwd=REPO)
    assert res.returncode == 0, res.stderr
    assert "served edge=" in res.stdout and "device=cpu" in res.stdout
    res = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         timeout=300, cwd=REPO)
    assert res.returncode != 0 and "device='cuda'" in res.stderr


def test_train_launcher_runs_on_cpu_and_refuses_missing_card(no_card):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "stablelm-1.6b", "--smoke", "--steps", "3", "--batch", "4",
           "--seq", "32"]
    res = subprocess.run(cmd + ["--device", "cpu"], capture_output=True,
                         text=True, env=env, timeout=300, cwd=REPO)
    assert res.returncode == 0, res.stderr
    assert "steps=3 first_loss=" in res.stdout
    res = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         timeout=300, cwd=REPO)
    assert res.returncode != 0 and "device='cuda'" in res.stderr


def test_sharded_training_defaults_to_the_card(no_card, tmp_path):
    """The sharded step's mesh is the host's cards unless devices are
    given: without a card it cannot be built; the dry run needs no
    device at all."""
    from repro_torch.launch import dryrun, mesh
    from repro_torch.launch import sharding as shd
    from repro_torch.training import train_loop
    with pytest.raises(ValueError, match="needs 4 devices, got 0"):
        mesh.make_mesh((2, 2), ("data", "model"))
    with mesh.forced_devices(4):
        with pytest.raises(ValueError, match="got 0"):
            mesh.make_mesh((2, 2), ("data", "model"))
        cpu = mesh.make_mesh((2, 2), ("data", "model"),
                             mesh.host_devices("cpu"))
    cfg, _ = _smoke()
    tcfg = train_loop.TrainConfig()
    state = train_loop.place_state(
        train_loop.init_state(torch.Generator().manual_seed(0), cfg, tcfg),
        shd.train_state_shardings(cfg, cpu), cpu)
    assert {p.pieces.flat[0].device.type
            for p in state.params.values()} == {"cpu"}
    with pytest.raises(RuntimeError, match="cuda"):
        train_loop.make_train_step(cfg, tcfg)
    out = dryrun.main(["--mesh", "single", "--arch", "stablelm-1.6b",
                       "--shape", "train_4k", "--out-dir", str(tmp_path)])
    assert out[0]["chips"] == 256


def test_serve_step_defaults_to_the_card(no_card, tmp_path):
    """``make_serve_step`` runs on the card unless told otherwise: without
    one it raises; ``device="cpu"`` and a CPU mesh work; the serve cells
    of the dry run need no device."""
    from repro_torch.launch import dryrun, mesh
    from repro_torch.models import model_zoo
    from repro_torch.serving import engine
    cfg, params = _smoke()
    for mode in ("prefill", "decode"):
        with pytest.raises(RuntimeError, match="cuda"):
            engine.make_serve_step(cfg, mode)
    step = engine.make_serve_step(cfg, "prefill", "cpu")
    cache = model_zoo.init_cache(cfg, 2, 16, "cpu")
    batch = {"tokens": torch.zeros((2, 4), dtype=torch.int32)}
    logits, _ = step(params, batch, cache)
    with mesh.forced_devices(4):
        cpu = mesh.make_mesh((2, 2), ("data", "model"),
                             mesh.host_devices("cpu"))
    placed = engine.serve_placement(cfg, cpu, params,
                                    model_zoo.init_cache(cfg, 2, 16, "cpu"),
                                    batch)
    p, c, x = placed
    got, _ = engine.make_serve_step(cfg, "prefill", mesh=cpu)(p, x, c)
    assert torch.equal(got.argmax(-1), logits.argmax(-1))
    out = dryrun.main(["--mesh", "single", "--arch", "stablelm-1.6b",
                       "--shape", "decode_32k", "--out-dir", str(tmp_path)])
    assert out[0]["decode_step_ms"] > 0


def test_endpoint_refuses_params_on_another_device():
    from repro_torch.serving.engine import Endpoint
    cfg, params = _smoke()
    params = dict(params)
    params["embed"] = params["embed"].to("meta")
    with pytest.raises(ValueError, match="lives on"):
        Endpoint(cfg, params, device="cpu")


def test_kernel_launchers_refuse_cpu_tensors():
    from repro_torch.kernels import decode_attention, flash_attention
    q = torch.zeros(1, 4, 2, 16)
    pos = torch.arange(4, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention(q, q, q, pos, pos)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention.decode_attention(q[:, 0], q, q, pos[:, 0], pos)


def test_kernel_build_raises_without_nvcc(no_card, monkeypatch, tmp_path):
    if shutil.which("nvcc"):
        pytest.skip("checks the behaviour on a machine without nvcc")
    from repro_torch.kernels import _build
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("a CUDA toolkit is installed")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


def test_chip_smoke_fails_without_card_or_package(no_card, tmp_path):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path, env=env)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(REPO / "chip_smoke.py", alone)
    res = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, timeout=300,
                         cwd=alone, env=env)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
