"""Builds a C++ source of the port into a shared library with ``g++``, at
first use, for ctypes.

The library lands in ``real_esrgan_tpu_torch/_build/`` (listed in
``.gitignore``) under a name that carries a hash of the source, the flags
and the host, so an edited source or another machine's build is never
loaded.  The build runs under an ``fcntl`` lock on ``<stem>.lock`` and
writes a temporary file that ``os.replace`` moves into place, so processes
that start at once compile once and never load half a file.  A failed
build raises ``RuntimeError`` with the compiler's first error line and its
whole output.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import platform
import subprocess
from pathlib import Path
from typing import Sequence

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"


def library_path(source: Path, build_dir: Path, stem: str, flags: Sequence[str]) -> Path:
    digest = hashlib.sha256(Path(source).read_bytes())
    # -march=native: a library built on another host may not run on this one
    digest.update(" ".join((*flags, platform.machine(), platform.node())).encode())
    return Path(build_dir) / f"{stem}-{digest.hexdigest()[:16]}.so"


def build(source: Path, build_dir: Path, stem: str, cxxflags: Sequence[str],
          ldlibs: Sequence[str] = ()) -> Path:
    """Compiles ``source`` unless a current build exists; returns the
    library's path."""
    lib = library_path(source, build_dir, stem, (*cxxflags, *ldlibs))
    if lib.exists():
        return lib
    build_dir = Path(build_dir)
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / f"{stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not lib.exists():  # another process may have built it meanwhile
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            proc = subprocess.run([os.environ.get("CXX", "g++"), *cxxflags, str(source),
                                   *ldlibs, "-o", str(tmp)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                  timeout=300)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                first = next((line for line in proc.stdout.splitlines() if "error" in line),
                             f"exit code {proc.returncode}")
                raise RuntimeError(f"g++ failed for {Path(source).name}: {first.strip()}\n"
                                   f"{proc.stdout}")
            os.replace(tmp, lib)
    return lib
