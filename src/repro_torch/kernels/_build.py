"""Builds and loads the port's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds).  The build happens at
first use, into ``build/repro_torch/`` under the repository root, and is
reused while the library is newer than its source.  There is no fallback:
a missing ``nvcc``, a failed build or a failed launch raises
:class:`KernelError`.  The loaders are cached under a lock
(:func:`locked_cache`), so two threads that make a first launch together
(a server's driver thread and a caller's) start one build, not two.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
import threading
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
LIBRARIES = {
    "crossbar": "crossbar_reduce.cu",
    "embedding_bag": "embedding_bag.cu",
    "decode_attention": "decode_attention.cu",
}


class KernelError(RuntimeError):
    """A kernel library could not be built or queried, or a kernel could
    not be launched: a fault of the installation or the card, not of the
    batch being served, so a serving engine re-raises it rather than
    retrying or quarantining the batch."""


def locked_cache(fn):
    """``functools.cache`` whose first call per arguments runs under a
    lock: ``cache`` alone lets two threads both miss and both run ``fn``
    (two ``nvcc`` builds into one path)."""
    cached = functools.cache(fn)
    lock = threading.Lock()

    @functools.wraps(fn)
    def wrapper(*args):
        with lock:
            return cached(*args)

    return wrapper


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default."""
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise KernelError(
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
        raise KernelError(
            f"nvcc failed ({proc.returncode}) building {src.name}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out, seconds, proc.stdout + proc.stderr


@locked_cache
def load_crossbar() -> ctypes.CDLL:
    """The crossbar-reduce library, built on first call, with its C
    signatures declared (every pointer and the stream as ``c_void_p``),
    and the kernel's occupancy, which the split rule reads."""
    path, _, _ = build("crossbar")
    lib = ctypes.CDLL(str(path))
    lib.crossbar_reduce_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,   # tiles, rows, dim, nb
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,   # S, q_block, q_chunk, n_split
        ctypes.c_int, ctypes.c_int,                               # dtype, dynamic_switch
        ctypes.c_void_p,
    ]
    lib.crossbar_reduce_launch.restype = ctypes.c_int
    lib.crossbar_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.crossbar_blocks_per_sm.restype = ctypes.c_int
    lib.crossbar_error_string.argtypes = [ctypes.c_int]
    lib.crossbar_error_string.restype = ctypes.c_char_p
    return lib


@locked_cache
def load_embedding_bag() -> ctypes.CDLL:
    """The embedding-bag library, built on first call, with its C
    signatures declared (every pointer and the stream as ``c_void_p``),
    and the kernel's occupancy, which the split rule reads."""
    path, _, _ = build("embedding_bag")
    lib = ctypes.CDLL(str(path))
    lib.embedding_bag_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # rows, dim, batch, bag, dtype
        ctypes.c_int, ctypes.c_int, ctypes.c_int,   # n_split, bags_per_block, threads
        ctypes.c_void_p,
    ]
    lib.embedding_bag_launch.restype = ctypes.c_int
    lib.embedding_bag_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.embedding_bag_blocks_per_sm.restype = ctypes.c_int
    lib.embedding_bag_error_string.argtypes = [ctypes.c_int]
    lib.embedding_bag_error_string.restype = ctypes.c_char_p
    return lib


@locked_cache
def load_decode_attention() -> ctypes.CDLL:
    """The int8 flash-decode attention library, built on first call, with
    its C signatures declared (every pointer and the stream as
    ``c_void_p``, the softmax scale as ``c_float``) and the card's SM
    count, which the split rule reads."""
    path, _, _ = build("decode_attention")
    lib = ctypes.CDLL(str(path))
    lib.decode_attention_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int,                       # q, q dtype
        ctypes.c_void_p, ctypes.c_void_p,                    # k_q, k_s
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,      # v_q, v_s, scale dtype
        ctypes.c_void_p,                                     # length (device int32)
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # out, m, l
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # split partials: out, m, l
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,                                        # n_split
        ctypes.c_float, ctypes.c_void_p,
    ]
    lib.decode_attention_launch.restype = ctypes.c_int
    lib.decode_attention_sm_count.argtypes = [ctypes.c_int]
    lib.decode_attention_sm_count.restype = ctypes.c_int
    lib.decode_attention_error_string.argtypes = [ctypes.c_int]
    lib.decode_attention_error_string.restype = ctypes.c_char_p
    return lib
