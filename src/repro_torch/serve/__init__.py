"""Embedding serving.  Unlike ``repro.serve``, importing this package
pulls in no LM decode path."""

from repro_torch.serve.sharded import ShardedEmbeddingServer, ShardedServeStats

__all__ = ["ShardedEmbeddingServer", "ShardedServeStats"]
