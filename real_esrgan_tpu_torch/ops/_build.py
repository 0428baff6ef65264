"""Builds the port's CUDA sources (``csrc/*.cu``) and loads them with ctypes.

Each source has a plain C interface and is compiled by ``nvcc`` for
``sm_90a`` into a shared library under ``real_esrgan_tpu_torch/_build/``
(listed in ``.gitignore``) on first use.  The library's name carries a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source is rebuilt and never mixed up with an old build.  Nothing is built at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build wall time, "log": nvcc output incl. ptxas -v}
BUILD_LOG: Dict[str, dict] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to "
                           "build the port's CUDA kernels")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> None:
    """Compiles ``csrc/<name>.cu`` unless a current build exists.  Raises
    with nvcc's output on error."""
    lib = library_path(name)
    if lib.exists():
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    BUILD_LOG[name] = {"seconds": time.perf_counter() - t0, "log": proc.stdout}
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
    os.replace(tmp, lib)  # atomic: a concurrent process never loads half a file


def build_all(names: Sequence[str]) -> None:
    """Builds several sources at once, one nvcc process each."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(build, names))  # list() re-raises a failed build


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
