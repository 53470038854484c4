"""Graph query service: batched multi-query execution over the GraVF-M
engine, with a compiled-plan cache and a deadline-aware scheduler —
bucketed (run each batch to completion) or continuous (per-superstep
slot array with mid-flight retirement and admission of new roots).
The port's copy of ``repro.service``, over the port's engines: on the
card unless ``device="cpu"`` is given.

    from repro_torch.service import GraphQueryService, QueryRequest

    svc = GraphQueryService(num_shards=4, max_batch=32,
                            scheduling="continuous")  # or device='cpu'
    svc.add_graph("social", graph)
    svc.warm("social", "bfs")                 # optional: pre-trace plans
    res = svc.query("social", "bfs", root=7)  # one EngineResult
    print(svc.stats_snapshot())               # qps / p95 / TEPS / cache
"""
from ..store import (GraphLease, GraphStore, StoreError, TenantPolicy,
                     TenantRegistry, TokenBucket)
from .batching import (BATCH_BUCKETS, AdmissionError, Batcher, QueryClass,
                       QueryRequest, bucket_for)
from .continuous import ContinuousScheduler, class_key
from .metrics import (Alert, MetricsRegistry, Watchdog, WatchdogConfig,
                      feed_service_snapshot)
from .plans import CompiledPlan, PlanCache, PlanKey, StepperPlan
from .server import GraphQueryService
from .stats import ServiceStats, percentile
from .trace import (EVENT_KINDS, QuerySpan, TraceBus, TraceEvent,
                    assemble_spans, chrome_trace)

__all__ = [
    "BATCH_BUCKETS", "AdmissionError", "Batcher", "QueryClass",
    "QueryRequest", "bucket_for",
    "CompiledPlan", "PlanCache", "PlanKey", "StepperPlan",
    "ContinuousScheduler", "class_key",
    "GraphQueryService", "ServiceStats", "percentile",
    "GraphLease", "GraphStore", "StoreError",
    "TenantPolicy", "TenantRegistry", "TokenBucket",
    "EVENT_KINDS", "QuerySpan", "TraceBus", "TraceEvent",
    "assemble_spans", "chrome_trace",
    "Alert", "MetricsRegistry", "Watchdog", "WatchdogConfig",
    "feed_service_snapshot",
]
