"""Build the port's CUDA sources into shared libraries with a plain C
interface, loaded with ctypes.

``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
compiles ``tpat_tpu_torch/csrc/<name>.cu`` into ``build/tpat_tpu_torch/`` at
the repository root.  The library name carries a hash of the source, the
headers in ``csrc/`` (``*.cuh``) and the flags, so an edited source or
header rebuilds and an unchanged one is reused.  The
compiler's report (``-Xptxas -v``: registers, shared memory, spills) is kept
beside the library as ``.log``.

Nothing here runs at import: the CPU-only tests import every module, and
only a call on a CUDA tensor builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpat_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc() -> str:
    """The nvcc on PATH, else the one under CUDA_HOME (default
    /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: put it on PATH or set CUDA_HOME"
        )
    return path


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless this source is already built;
    returns the library's path.  Raises with nvcc's output on failure."""
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(
        src + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()
    lib = BUILD_DIR / f"lib{name}.{key[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True,
    )
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n"
            f"{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` once per process."""
    return ctypes.CDLL(str(build(name)))
