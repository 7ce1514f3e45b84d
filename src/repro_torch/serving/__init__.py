"""Serving stack: continuous-batching engine over the paged KV plane, radix
prefix reuse and the MRM memory plane, with the fleet above it: the cluster
frontend over torch engine replicas, the event clock, the sharded prefix
directory, the shared fabric and the analytic fleet simulator."""
from repro_torch.serving.cluster import ClusterFrontend, PrefixDirectory
from repro_torch.serving.engine import (ComputeBackend, EngineConfig, MemoryPlane,
                                        PrefillChunk, ServeEngine, SnapshotHandle,
                                        StepPlan, StepReport, choose_hot_tier,
                                        latency_percentiles)
from repro_torch.serving.directory import DirectoryShard, ShardedDirectory
from repro_torch.serving.events import (Event, EventKind, EventQueue, EventTrace,
                                        NonQuiescentError)
from repro_torch.serving.fabric import Fabric
from repro_torch.serving.fleet_sim import (FleetConfig, FleetRequest, FleetSim,
                                           latency_slo)
from repro_torch.serving.kv_cache import PagedKVManager, PressureStats, RadixStats
from repro_torch.serving.radix import PrefixMatch, RadixKVIndex, RadixNode
from repro_torch.serving.retention_lifecycle import LifecycleStats, RetentionLifecycle
from repro_torch.serving.scheduler import ContinuousBatchScheduler, Request

__all__ = ["EngineConfig", "ServeEngine", "ComputeBackend", "MemoryPlane",
           "StepPlan", "StepReport", "PrefillChunk", "PagedKVManager",
           "PressureStats", "RadixStats", "LifecycleStats",
           "RetentionLifecycle", "ContinuousBatchScheduler",
           "Request", "ClusterFrontend", "PrefixDirectory", "RadixKVIndex",
           "RadixNode", "PrefixMatch", "SnapshotHandle", "choose_hot_tier",
           "latency_percentiles", "Event", "EventKind", "EventQueue",
           "EventTrace", "NonQuiescentError", "FleetConfig", "FleetRequest",
           "FleetSim", "latency_slo", "Fabric", "ShardedDirectory",
           "DirectoryShard"]
