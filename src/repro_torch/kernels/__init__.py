"""The port's kernels: hand-written CUDA C++ for Hopper (``csrc/``), their
ctypes wrappers, plain PyTorch versions (``ref``) and autograd ops."""

from repro_torch.kernels.crossbar_reduce import crossbar_reduce_cuda
from repro_torch.kernels.decode_attention import fused_decode_attention_cuda
from repro_torch.kernels.embedding_bag import embedding_bag_cuda
from repro_torch.kernels.ops import crossbar_reduce, crossbar_reduce_blocked, embedding_bag
from repro_torch.kernels.ref import (
    crossbar_reduce_blocked_ref,
    crossbar_reduce_ref,
    embedding_bag_ref,
    fused_decode_attention_ref,
)
from repro_torch.kernels.sharded import (
    combine_bytes_per_batch,
    crossbar_reduce_sharded,
    crossbar_reduce_tables,
    dispatch_cache_stats,
    patch_shard_images,
)

__all__ = [
    "crossbar_reduce_cuda", "crossbar_reduce", "crossbar_reduce_blocked",
    "crossbar_reduce_blocked_ref", "crossbar_reduce_ref",
    "embedding_bag_cuda", "embedding_bag", "embedding_bag_ref",
    "fused_decode_attention_cuda", "fused_decode_attention_ref",
    "combine_bytes_per_batch", "crossbar_reduce_sharded",
    "crossbar_reduce_tables", "dispatch_cache_stats", "patch_shard_images",
]
