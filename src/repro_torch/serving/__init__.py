"""Serving stack: continuous-batching engine over the paged KV plane, radix
prefix reuse and the MRM memory plane."""
from repro_torch.serving.engine import (ComputeBackend, EngineConfig, MemoryPlane,
                                        PrefillChunk, ServeEngine, StepPlan,
                                        StepReport, choose_hot_tier,
                                        latency_percentiles)
from repro_torch.serving.events import NonQuiescentError
from repro_torch.serving.kv_cache import PagedKVManager, PressureStats, RadixStats
from repro_torch.serving.radix import PrefixMatch, RadixKVIndex, RadixNode
from repro_torch.serving.retention_lifecycle import LifecycleStats, RetentionLifecycle
from repro_torch.serving.scheduler import ContinuousBatchScheduler, Request

__all__ = ["EngineConfig", "ServeEngine", "ComputeBackend", "MemoryPlane",
           "StepPlan", "StepReport", "PrefillChunk", "PagedKVManager",
           "PressureStats", "RadixStats", "LifecycleStats",
           "RetentionLifecycle", "ContinuousBatchScheduler", "Request",
           "RadixKVIndex", "RadixNode", "PrefixMatch", "choose_hot_tier",
           "latency_percentiles", "NonQuiescentError"]
