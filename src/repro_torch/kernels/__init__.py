"""The port's kernels: hand-written CUDA C++ for Hopper (``csrc/``), their
ctypes wrappers, plain PyTorch versions (``ref``) and autograd ops."""

from repro_torch.kernels.crossbar_reduce import crossbar_reduce_cuda
from repro_torch.kernels.ops import crossbar_reduce, crossbar_reduce_blocked
from repro_torch.kernels.ref import crossbar_reduce_blocked_ref, crossbar_reduce_ref
from repro_torch.kernels.sharded import (
    combine_bytes_per_batch,
    crossbar_reduce_sharded,
    crossbar_reduce_tables,
    dispatch_cache_stats,
)

__all__ = [
    "crossbar_reduce_cuda", "crossbar_reduce", "crossbar_reduce_blocked",
    "crossbar_reduce_blocked_ref", "crossbar_reduce_ref",
    "combine_bytes_per_batch", "crossbar_reduce_sharded",
    "crossbar_reduce_tables", "dispatch_cache_stats",
]
