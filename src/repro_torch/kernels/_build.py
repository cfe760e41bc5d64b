"""Builds and loads the port's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds).  The build happens at
first use, into ``build/repro_torch/`` under the repository root, and is
reused while the library is newer than its source.  There is no fallback:
a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers, shared memory and spills, into the build log
]

#: library name → source file under csrc/
LIBRARIES = {"crossbar": "crossbar_reduce.cu"}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default."""
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of repro_torch are compiled "
            "at first use and need the CUDA toolkit"
        )
    return found


def build(name: str) -> tuple[Path, float, str]:
    """Compiles library ``name`` if it is missing or older than its source.

    Returns ``(path, seconds spent compiling, nvcc's output)`` — 0.0 and
    ``""`` when the library was reused.  The
    library is written to a temporary file and renamed into place, so a
    cut-off build never leaves a partial library behind.
    """
    src = CSRC / LIBRARIES[name]
    out = BUILD_DIR / f"lib{name}.so"
    if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {src.name}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out, seconds, proc.stdout + proc.stderr


@functools.cache
def load_crossbar() -> ctypes.CDLL:
    """The crossbar-reduce library, built on first call, with its C
    signatures declared (every pointer and the stream as ``c_void_p``)."""
    path, _, _ = build("crossbar")
    lib = ctypes.CDLL(str(path))
    lib.crossbar_reduce_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.crossbar_reduce_launch.restype = ctypes.c_int
    lib.crossbar_error_string.argtypes = [ctypes.c_int]
    lib.crossbar_error_string.restype = ctypes.c_char_p
    return lib
