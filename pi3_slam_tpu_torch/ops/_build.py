"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Libraries are built at first use into
``pi3_slam_tpu_torch/_build/``, keyed by a hash of the sources and flags, so a
changed source rebuilds and an unchanged one is reused. Only sources in this
package are compiled.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check_launch` turns a non-zero code into an
exception (a refused launch never runs, and a later synchronise would not
report it).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v", "-lineinfo",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return str(path)


def _sources(name: str) -> list[Path]:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(src)
    return [src] + sorted(CSRC.glob("*.cuh"))


def _library_path(name: str) -> Path:
    """Where the built library for ``csrc/<name>.cu`` lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources(name):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> tuple[Path, float]:
    """Compile ``csrc/<name>.cu`` unless an up-to-date build exists.

    Returns (library path, seconds spent compiling; 0.0 when reused). The
    compiler's output (ptxas register / shared-memory report) is kept next to
    the library as ``<lib>.log``.
    """
    so = _library_path(name)
    if so.exists():
        return so, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    so.with_suffix(".so.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, so)  # atomic: concurrent builders never load a partial file
    return so, seconds


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` as a ctypes library."""
    so, _ = build(name)
    return ctypes.CDLL(str(so))


def check_launch(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {code}")
