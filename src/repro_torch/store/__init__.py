"""Multi-tenant graph residency + fair-share policy.

The port's copy of ``repro.store``.

:class:`GraphStore` is the versioned, memory-budgeted registry of
device-resident partitioned graphs (LRU eviction, query-pinning,
transparent refault, atomic version publish);
:class:`TenantRegistry` holds per-tenant quotas (token-bucket admission)
and fair-share weights the continuous scheduler enforces.

    from repro_torch.store import GraphStore
    store = GraphStore(budget_bytes=2 * pg.device_nbytes)
    v1 = store.publish("tenant-a", graph_a)
    with store.acquire("tenant-a") as lease:   # pinned while in use
        run_queries(lease.pg)
"""
from .registry import GraphLease, GraphStore, StoreError
from .tenancy import (DEFAULT_TENANT, TenantPolicy, TenantRegistry,
                      TokenBucket)

__all__ = [
    "GraphLease", "GraphStore", "StoreError",
    "DEFAULT_TENANT", "TenantPolicy", "TenantRegistry", "TokenBucket",
]
