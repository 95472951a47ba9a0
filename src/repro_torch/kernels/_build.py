"""Build and load the hand-written CUDA kernels (nvcc + ctypes).

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use, by ``nvcc`` alone, into its own shared library::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v --split-compile=0 \\
         -o <name>.so csrc/<name>.cu

The libraries go to ``build/repro_torch_kernels/`` at the repository root
(listed in ``.gitignore``), named by a hash of the source and the flags,
so an edited source rebuilds and an unchanged one is reused.  Sources
build in parallel, one ``nvcc`` each, all started together; the ptxas
report (registers, shared memory, spills) is kept beside each library as
``<name>.log``.  There is no fallback: a missing ``nvcc`` or a failed
build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES: Tuple[str, ...] = ("flash_attention", "decode_attention",
                            "rwkv6_scan", "ssd_scan")
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    "--split-compile=0")     # optimise a source's kernels on every core

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default
    location.  Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of repro_torch are compiled at first use")


def library_path(name: str, csrc: Path = CSRC) -> Path:
    """Where ``<csrc>/<name>.cu`` builds to (keyed by source and flags)."""
    src = (csrc / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + "\0".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{key[:16]}.so"


def build(names: Iterable[str] = SOURCES,
          csrc: Path = CSRC) -> Dict[str, Path]:
    """Compile every named source of ``csrc`` that is not built yet, in
    parallel (one ``nvcc`` per source, all started together).  Returns
    name -> library path; raises with the compiler's output if any build
    fails."""
    names = list(names)
    out = {n: library_path(n, csrc) for n in names}
    todo = [n for n in names if not out[n].is_file()]
    if not todo:
        return out
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List[Tuple[str, Path, subprocess.Popen]] = []
    for n in todo:
        tmp = out[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(csrc / f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for n, tmp, proc in procs:
        log, _ = proc.communicate()
        text = log.decode(errors="replace")
        out[n].with_suffix(".log").write_text(text)
        if proc.returncode != 0:
            failed.append(f"--- {n}.cu (nvcc exit {proc.returncode})\n{text}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out[n])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build([name])[name]
            lib = ctypes.CDLL(str(path))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise unless a C entry point returned cudaSuccess (0)."""
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
