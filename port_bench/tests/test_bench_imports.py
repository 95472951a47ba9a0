"""Nothing the harness loads is JAX or the JAX package: every module in
``sys.modules`` after a rehearsal run (a fresh interpreter, the harness's
modules and the port it drives), compared by its whole top-level name
(``repro_torch`` is the port; ``repro`` is the JAX package).  And the
reference imports nothing of the port."""

import ast
import json
import subprocess
import sys

from pbench import bench, spec

SCRIPT = r"""
import json, sys
sys.path[0:0] = [{bench!r}, {src!r}, {tests!r}]
from conftest import tiny
from pbench import bench, spec
cell, over = tiny("qwen2-moe-a2.7b.batch-decode")
bench.run_cell(cell, 3, 2.0, True, device="cpu", overrides=over,
               log=lambda *a, **k: None)
for m in spec.load_benchmark()["per_layer"]:
    spec.load_reader(m["name"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_no_module_of_jax_or_the_jax_package_is_loaded():
    code = SCRIPT.format(bench=str(spec.BENCH_DIR), src=str(spec.ROOT / "src"),
                         tests=str(spec.BENCH_DIR / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(spec.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top and "pbench" in top
    assert not top & set(bench.BANNED), top & set(bench.BANNED)


def test_banned_names_compare_whole():
    assert bench.BANNED == ("jax", "jaxlib", "flax", "repro")
    assert "repro_torch" not in bench.BANNED


def test_the_reference_imports_nothing_of_the_port():
    path = spec.BENCH_DIR / "pbench" / "reference.py"
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "math", "typing", "numpy", "torch"}, names
