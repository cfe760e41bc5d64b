"""Embedding serving.  Unlike ``repro.serve``, importing this package
pulls in no LM decode path."""

from repro_torch.serve.drift import DriftTracker, LoadObservationCache, ReplanConfig
from repro_torch.serve.faults import (
    ErrorLedger,
    FaultInjector,
    FaultPlan,
    FaultSpec,
    FlushTimeout,
    InjectedFault,
    PoisonedQueryError,
    RetryPolicy,
)
from repro_torch.serve.producers import (
    DEFAULT_PRODUCER,
    SEQ_STRIDE,
    ProducerRegistry,
)
from repro_torch.serve.scheduler import POOL, FlushPolicy, FlushScheduler
from repro_torch.serve.sharded import ShardedEmbeddingServer, ShardedServeStats
from repro_torch.serve.tiers import HostFetchQueue, ResidencyIndex, TierConfig

__all__ = [
    "ShardedEmbeddingServer", "ShardedServeStats",
    "FlushPolicy", "FlushScheduler", "POOL",
    "ProducerRegistry", "DEFAULT_PRODUCER", "SEQ_STRIDE",
    "TierConfig", "ResidencyIndex", "HostFetchQueue",
    "FaultPlan", "FaultSpec", "FaultInjector", "RetryPolicy",
    "ErrorLedger", "FlushTimeout", "InjectedFault", "PoisonedQueryError",
    "ReplanConfig", "DriftTracker", "LoadObservationCache",
]
