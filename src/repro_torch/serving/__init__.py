"""Serving: batched keyword search (the paper's app), the sharded
scatter-gather tier + admission-controlled frontend, and the self-tuning
control plane (telemetry + controllers). RAG decoding is not ported yet
(ROADMAP queue 1, item 8)."""

from .cluster import (ClusterConflict, ClusterSearcher, ScatterReport,
                      ShardedIndex, collect_cluster_garbage,
                      partition_by_slots, partition_corpus, shard_of_ref,
                      slot_of_ref)
from .control import (BatchController, ControlConfig, DeadlineShedder,
                      LeastLoaded, PowerOfTwoChoices,
                      PredictedDeadlineMiss, as_picker)
from .frontend import (DeadlineExceeded, Frontend, FrontendConfig,
                       FrontendStats, Overloaded)
from .notify import GenerationBus, GenerationEvent, Subscription
from .search_service import LatencyStats, SearchService
from .telemetry import Counter, Gauge, Telemetry, WindowedHistogram

__all__ = [
    "LatencyStats", "SearchService",
    "ShardedIndex", "ClusterSearcher", "ScatterReport", "ClusterConflict",
    "partition_corpus", "partition_by_slots", "shard_of_ref",
    "slot_of_ref", "collect_cluster_garbage",
    "Frontend", "FrontendConfig", "FrontendStats",
    "Overloaded", "DeadlineExceeded",
    "GenerationBus", "GenerationEvent", "Subscription",
    "Telemetry", "Counter", "Gauge", "WindowedHistogram",
    "BatchController", "ControlConfig", "DeadlineShedder",
    "PredictedDeadlineMiss", "LeastLoaded", "PowerOfTwoChoices",
    "as_picker",
]
