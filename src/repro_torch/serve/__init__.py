"""Embedding serving.  Unlike ``repro.serve``, importing this package
pulls in no LM decode path."""

from repro_torch.serve.drift import DriftTracker, LoadObservationCache, ReplanConfig
from repro_torch.serve.faults import ErrorLedger, FlushTimeout, RetryPolicy
from repro_torch.serve.producers import (
    DEFAULT_PRODUCER,
    SEQ_STRIDE,
    ProducerRegistry,
)
from repro_torch.serve.scheduler import POOL, FlushPolicy, FlushScheduler
from repro_torch.serve.sharded import ShardedEmbeddingServer, ShardedServeStats

__all__ = [
    "ShardedEmbeddingServer", "ShardedServeStats",
    "FlushPolicy", "FlushScheduler", "POOL",
    "ProducerRegistry", "DEFAULT_PRODUCER", "SEQ_STRIDE",
    "RetryPolicy", "ErrorLedger", "FlushTimeout",
    "ReplanConfig", "DriftTracker", "LoadObservationCache",
]
