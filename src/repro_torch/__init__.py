"""repro_torch — the PyTorch/CUDA port of ``repro`` for an NVIDIA H100.

Mirrors ``repro``'s layout (``core``, ``data``, ``kernels``, ``dist``,
``serve``, ``launch``) so each module's counterpart is easy to find.  It
imports torch and numpy, never jax and nothing of ``repro``: the NumPy
modules it needs are its own copies.  Entry points take ``device=``,
defaulting to ``"cuda"``; the CUDA kernels under ``kernels/csrc`` are
compiled with nvcc at first use.
"""

__version__ = "0.1.0"
