"""repro_torch — the PyTorch/CUDA port of ``repro`` for an NVIDIA H100.

Mirrors ``repro``'s layout (``core``, ``data``, ``kernels``, ``dist``,
``models``, ``configs``, ``serve``, ``launch``) so each module's
counterpart is easy to find.  Ported so far: the sharded ReCross
embedding server, DLRM forward and SGD training, and LM decode serving
of the dense family over bf16 and int8 KV caches.  It
imports torch and numpy, never jax and nothing of ``repro``: the NumPy
modules it needs are its own copies.  Entry points take ``device=``,
defaulting to ``"cuda"``; the CUDA kernels under ``kernels/csrc`` are
compiled with nvcc at first use.
"""

__version__ = "0.1.0"
