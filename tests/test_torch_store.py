"""The port's twin of ``tests/test_store.py``, over ``repro_torch`` on
the CPU (``device="cpu"``), plus parity with the JAX package.

Multi-tenant GraphStore: versioned residency under a memory budget.

Covers the store's contract (LRU eviction, query pins, transparent
refault, atomic version publish), the host-spill residency tier
(device -> host spill -> discard; refault = re-upload, bit-identical,
zero re-traces; spill_budget overflow degrades to discard), the
out-of-lock fault path (double-faulting threads share one
materialization; a fault in progress blocks neither other entries'
store operations nor other tenants' submits), the tenancy policy layer
(token buckets, fair-share weights), and the service-level integration:
re-register-as-publish semantics, eviction/pin races (a query in flight
on a graph chosen for eviction completes bit-identically), version-swap
isolation (old-version results unaffected by publish), stale-plan
invalidation scoped to the discarded version, and weighted fair share.
A shard-engine variant runs the port's ``ShardEngine`` on
``LocalMesh(8, "cpu")``; the reference's shard_map variant runs in a
subprocess with 8 forced host devices, and the port is held to its
answers.

Parity: one budgeted publish/acquire/pin sequence through both stores
(every counter and residency equal), a three-tenant service stream under
a memory budget (answers and the store counters), weighted fair share
(the completions after every poll) and rate quotas (the sheds of
``TokenBucket`` under injected time, and of the service).
"""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from repro_torch.core import algorithms as ALG
from repro_torch.core import graph as G
from repro_torch.core import partition as PT
from repro_torch.core.engine import Engine
from repro_torch.service import (AdmissionError, GraphQueryService, PlanCache,
                           QueryRequest)
from repro_torch.store import (GraphStore, StoreError, TenantRegistry,
                               TokenBucket)

from _torch_twins import (COUNTERS, assert_same_result, jax_graph,
                          jax_service, serve_waves)


@pytest.fixture(scope="module")
def g_a():
    return G.uniform(300, 6.0, seed=1).symmetrized()


@pytest.fixture(scope="module")
def g_b():
    return G.uniform(300, 6.0, seed=2).symmetrized()


@pytest.fixture(scope="module")
def g_c():
    return G.uniform(300, 6.0, seed=3).symmetrized()


@pytest.fixture(scope="module")
def deep_graph():
    # ladder: BFS from rank-0 takes ~30 supersteps, so a query is still
    # in flight while we evict/publish around it
    return G.ladder(2, 30, 1, seed=0)


def _budget_for(graph, k: float, pad_multiple=16, num_shards=4) -> float:
    """A budget that fits ``k`` layouts the size of ``graph``'s."""
    pg = PT.partition_graph(graph, num_shards, pad_multiple=pad_multiple)
    return k * pg.device_nbytes


# ---------------------------------------------------------------------------
# store unit behavior
# ---------------------------------------------------------------------------

def test_publish_acquire_idempotent(g_a):
    store = GraphStore(num_shards=4, pad_multiple=16)
    v = store.publish("a", g_a)
    assert v == 1
    assert store.publish("a", g_a) == 1          # identical -> no-op
    assert store.latest_version("a") == 1
    with store.acquire("a") as lease:
        assert lease.pg.num_vertices == g_a.num_vertices
    assert store.snapshot()["resident_graphs"] == 1
    assert store.faults == 0


def test_partitioned_graph_byte_accounting(g_a):
    pg = PT.partition_graph(g_a, 4, pad_multiple=16)
    assert pg.device_nbytes > 0
    assert pg.nbytes > pg.device_nbytes          # + the stats edge list
    expected = sum(getattr(pg, f).nbytes for f in (
        "part_of", "local_of", "vert_gid", "vert_valid", "out_deg",
        "in_src_slot", "in_src_gid", "in_src_outdeg", "in_dst_local",
        "in_w", "in_valid", "pair_src_local", "pair_src_gid",
        "pair_src_outdeg", "pair_dst_local", "pair_w", "pair_valid",
        "nbr_filter"))
    assert pg.device_nbytes == expected


def test_lru_eviction_order(g_a, g_b, g_c):
    budget = _budget_for(g_a, 2.5)
    store = GraphStore(budget_bytes=budget, num_shards=4, pad_multiple=16)
    store.publish("a", g_a)
    store.publish("b", g_b)
    # touch "a" so "b" is the LRU victim when "c" arrives
    store.acquire("a").release()
    store.publish("c", g_c)
    snap = store.snapshot()
    assert snap["evictions"] == 1
    desc = {e["graph_id"]: e for e in store.describe()}
    assert desc["b"]["resident"] is False
    assert desc["a"]["resident"] and desc["c"]["resident"]


def test_fault_rematerializes_bit_identical(g_a, g_b):
    budget = _budget_for(g_a, 1.5)
    store = GraphStore(budget_bytes=budget, num_shards=4, pad_multiple=16)
    store.publish("a", g_a)
    with store.acquire("a") as lease:
        before = {f: np.array(getattr(lease.pg, f))
                  for f in ("part_of", "in_src_slot", "in_dst_local",
                            "vert_gid", "in_w")}
    store.publish("b", g_b)                       # evicts idle "a"
    assert not {e["graph_id"]: e for e in store.describe()}["a"]["resident"]
    with store.acquire("a") as lease:             # transparent refault
        for f, arr in before.items():
            assert np.array_equal(np.asarray(getattr(lease.pg, f)), arr), f
    assert store.faults == 1


def test_pinned_graph_never_evicted(g_a, g_b):
    budget = _budget_for(g_a, 1.5)
    store = GraphStore(budget_bytes=budget, num_shards=4, pad_multiple=16)
    store.publish("a", g_a)
    lease_a = store.acquire("a")                  # pin
    store.publish("b", g_b)       # over budget; "a" pinned -> "b" evicted
    desc = {e["graph_id"]: e for e in store.describe()}
    assert desc["a"]["resident"]                  # pin held
    lease_b = store.acquire("b")  # fault "b" back; BOTH pinned now
    desc = {e["graph_id"]: e for e in store.describe()}
    assert desc["a"]["resident"] and desc["b"]["resident"]
    assert store.snapshot()["budget_overcommits"] >= 1
    assert store.evict("a") is False              # explicit evict refused
    lease_a.release()                             # now evictable
    lease_b.release()             # sweep: LRU "a" goes, "b" stays
    desc = {e["graph_id"]: e for e in store.describe()}
    assert not desc["a"]["resident"]
    assert desc["b"]["resident"]


def test_version_publish_supersedes_and_drains(g_a, g_b):
    store = GraphStore(num_shards=4, pad_multiple=16)
    assert store.publish("a", g_a) == 1
    lease_v1 = store.acquire("a", 1)              # in-flight query on v1
    assert store.publish("a", g_b) == 2
    assert store.latest_version("a") == 2
    # v1 stays resident for its drain ...
    desc = {e["version"]: e for e in store.describe()
            if e["graph_id"] == "a"}
    assert desc[1]["resident"] and desc[1]["superseded"]
    assert np.array_equal(lease_v1.pg.part_of,
                          PT.partition_graph(g_a, 4,
                                             pad_multiple=16).part_of)
    # ... and is evicted the moment the last pin drops
    lease_v1.release()
    desc = {e["version"]: e for e in store.describe()
            if e["graph_id"] == "a"}
    assert not desc[1]["resident"]
    assert desc[2]["resident"]


def test_unversioned_store_rejects_republish(g_a, g_b):
    store = GraphStore(versioned=False, num_shards=4, pad_multiple=16)
    store.publish("a", g_a)
    store.publish("a", g_a)                       # identical: fine
    with pytest.raises(StoreError):
        store.publish("a", g_b)


def test_peek_requires_residency_and_remove_refuses_pins(g_a, g_b):
    budget = _budget_for(g_a, 1.5)
    store = GraphStore(budget_bytes=budget, num_shards=4, pad_multiple=16)
    store.publish("a", g_a)
    store.publish("b", g_b)                       # "a" evicted
    with pytest.raises(StoreError):
        store.peek("a")
    lease = store.acquire("b")
    with pytest.raises(StoreError):
        store.remove("b")
    lease.release()
    store.remove("b")
    with pytest.raises(KeyError):
        store.latest_version("b")


# ---------------------------------------------------------------------------
# host-spill residency tier
# ---------------------------------------------------------------------------

def test_eviction_spills_to_host_and_refaults_cheaply(g_a, g_b):
    """A budget eviction demotes to the host tier; the next acquire is a
    spilled refault (no partitioner re-run) that is array-for-array the
    original layout."""
    budget = _budget_for(g_a, 1.5)
    store = GraphStore(budget_bytes=budget, num_shards=4, pad_multiple=16)
    store.publish("a", g_a)
    with store.acquire("a") as lease:
        before = lease.pg
    store.publish("b", g_b)                       # evicts idle "a" -> spill
    desc = {e["graph_id"]: e for e in store.describe()}
    assert not desc["a"]["resident"] and desc["a"]["spilled"]
    snap = store.snapshot()
    assert snap["spills"] == 1 and snap["discards"] == 0
    assert snap["spilled_graphs"] == 1 and snap["spilled_bytes"] > 0
    with store.acquire("a") as lease:             # refault from host tier
        assert lease.pg is before     # the spilled arrays survive verbatim
    snap = store.snapshot()
    assert snap["faults"] == 1
    assert snap["refault_upload_ms"] >= 0.0


def test_spill_budget_overflow_discards_lru(g_a, g_b, g_c):
    """Host-tier overflow degrades to the pre-spill behavior: the LRU
    spilled layout is discarded and its next fault is cold."""
    budget = _budget_for(g_a, 1.5)
    store = GraphStore(budget_bytes=budget, num_shards=4, pad_multiple=16,
                       spill_budget_bytes=budget)   # host tier fits one
    store.publish("a", g_a)
    store.publish("b", g_b)                       # "a" spilled
    store.publish("c", g_c)                       # "b" spilled -> "a" out
    snap = store.snapshot()
    assert snap["spills"] == 2
    assert snap["discards"] == 1
    desc = {e["graph_id"]: e for e in store.describe()}
    assert not desc["a"]["resident"] and not desc["a"]["spilled"]
    assert desc["b"]["spilled"]
    with store.acquire("a") as lease:             # cold fault re-partitions
        assert lease.pg.num_vertices == g_a.num_vertices
    assert store.faults == 1


def test_spill_disabled_restores_discard_on_evict(g_a, g_b):
    """spill_budget_bytes=0 turns the host tier off entirely."""
    budget = _budget_for(g_a, 1.5)
    store = GraphStore(budget_bytes=budget, num_shards=4, pad_multiple=16,
                       spill_budget_bytes=0)
    store.publish("a", g_a)
    store.publish("b", g_b)
    snap = store.snapshot()
    assert snap["evictions"] == 1
    assert snap["spills"] == 0 and snap["discards"] == 1
    assert snap["spilled_graphs"] == 0


def test_spill_refault_keeps_plans_zero_retrace(g_a, g_b):
    """The acceptance invariant: spill -> refault round-trips
    bit-identically AND re-traces nothing — the plan cache keeps the
    spilled version's engines/plans and only re-uploads their arrays."""
    budget = _budget_for(g_a, 1.5)
    svc = GraphQueryService(num_shards=4, max_batch=4, slots=4,
                            scheduling="continuous",
                            memory_budget=budget, result_cache_size=0,
                                device="cpu")
    svc.add_graph("a", g_a, pad_multiple=16)
    svc.add_graph("b", g_b, pad_multiple=16)
    res_a0 = svc.query("a", "bfs", root=0, deadline_ms=60_000)
    svc.query("b", "bfs", root=0, deadline_ms=60_000)   # spills "a"
    snap0 = svc.stats_snapshot()
    assert snap0["plan_traces"] > 0
    assert snap0["store_spills"] >= 1
    assert {e["graph_id"]: e for e in svc.store.describe()}["a"]["spilled"]
    res_a1 = svc.query("a", "bfs", root=0, deadline_ms=60_000)  # refault
    snap1 = svc.stats_snapshot()
    assert snap1["plan_traces"] == snap0["plan_traces"]   # ZERO re-traces
    assert snap1["store_faults"] >= snap0["store_faults"] + 1
    assert snap1["store_discards"] == 0
    pg_a = PT.partition_graph(g_a, 4, pad_multiple=16)
    ref = Engine(ALG.bfs(0), pg_a, mode="gravfm", backend="ref",
                 device="cpu").run()
    for res in (res_a0, res_a1):
        assert np.array_equal(res.state["parent"], ref.state["parent"])
        assert res.supersteps == ref.supersteps
        assert res.messages == ref.messages


def test_engine_tier_bytes_replace_layout_proxy(g_a):
    """The store charges each version's TRUE engine-tier device bytes
    (Engine.device_nbytes — what offload() actually demotes) once
    engines exist, replacing the partition-layout proxy estimate; a
    version serving several engines is charged all of them. Budget
    conservation: resident_bytes equals the sum of the live engines'
    bytes."""
    svc = GraphQueryService(num_shards=4, max_batch=4, device="cpu")
    svc.add_graph("a", g_a, pad_multiple=16)
    store = svc.store
    proxy = PT.partition_graph(g_a, 4, pad_multiple=16).device_nbytes
    assert store.resident_bytes == proxy        # no engines yet: proxy
    svc.query("a", "bfs", root=0)               # builds the bfs engine
    true1 = sum(e.device_nbytes for e in svc.plans._engines.values())
    assert true1 > 0
    assert store.resident_bytes == true1
    assert store.resident_bytes != proxy
    # conservation check against what offload() would actually free
    eng = next(iter(svc.plans._engines.values()))
    assert eng.device_nbytes == eng.offload()
    eng.upload()
    # a second engine (other mode) against the same version adds ON TOP
    svc.query("a", "bfs", root=0, mode="gravf")
    true2 = sum(e.device_nbytes for e in svc.plans._engines.values())
    assert true2 > true1
    assert store.resident_bytes == true2
    assert store.snapshot()["resident_bytes"] == float(true2)


def test_engine_tier_budget_conservation_with_eviction(g_a, g_b):
    """With the true engine-tier charge, a budget sized for ~1.5 engine
    footprints forces an eviction when the second graph's engine lands,
    and the final (unpinned) resident bytes respect the budget. The
    evicted graph still answers bit-identically after its refault."""
    pg = PT.partition_graph(g_a, 4, pad_multiple=16)
    eb = Engine(ALG.bfs(), pg, mode="gravfm", backend="ref",
                device="cpu").device_nbytes
    budget = 1.5 * eb
    svc = GraphQueryService(num_shards=4, max_batch=4,
                            memory_budget=budget, device="cpu")
    svc.add_graph("a", g_a, pad_multiple=16)
    svc.add_graph("b", g_b, pad_multiple=16)
    svc.query("a", "bfs", root=0)
    svc.query("b", "bfs", root=0)               # pushes over budget
    store = svc.store
    assert store.snapshot()["evictions"] >= 1
    assert store.resident_bytes <= budget       # conservation, unpinned
    res = svc.query("a", "bfs", root=1)         # fault back in
    assert store.resident_bytes <= budget
    ref = Engine(ALG.bfs(1), pg, mode="gravfm", backend="ref",
                 device="cpu").run()
    assert np.array_equal(res.state["parent"], ref.state["parent"])


def test_engine_offload_upload_roundtrip_zero_retrace(g_a):
    """The engine tier of the spill: offload demotes the graph arrays to
    host copies, upload promotes them back, and neither move re-traces
    or changes results."""
    pg = PT.partition_graph(g_a, 4, pad_multiple=16)
    eng = Engine(ALG.bfs(), pg, mode="gravfm", backend="ref", device="cpu")
    before = eng.run(root=0)
    traces0 = eng.traces
    freed = eng.offload()
    assert freed > 0 and not eng.device_resident
    assert eng.offload() == 0                     # idempotent
    mid = eng.run(root=0)                         # offloaded still works
    assert eng.upload() >= 0.0 and eng.device_resident
    assert eng.upload() == 0.0                    # idempotent
    after = eng.run(root=0)
    assert eng.traces == traces0                  # no re-trace either way
    for res in (mid, after):
        assert np.array_equal(res.state["parent"], before.state["parent"])


# ---------------------------------------------------------------------------
# out-of-lock faulting
# ---------------------------------------------------------------------------

def test_concurrent_faults_share_one_materialization(g_a, g_b, monkeypatch):
    """Two threads faulting the same discarded entry: the first claims
    the build, the second waits on the ENTRY's condvar, and exactly one
    partitioner run happens."""
    from repro_torch.store import registry as reg
    budget = _budget_for(g_a, 1.5)
    store = GraphStore(budget_bytes=budget, num_shards=4, pad_multiple=16,
                       spill_budget_bytes=0)      # force a cold fault
    store.publish("a", g_a)
    store.publish("b", g_b)                       # "a" discarded
    real = reg.partition_graph
    calls = []

    def counting(graph, *args, **kwargs):
        calls.append(graph)
        time.sleep(0.05)                          # widen the race window
        return real(graph, *args, **kwargs)

    monkeypatch.setattr(reg, "partition_graph", counting)
    leases = [None, None]

    def fault(i):
        leases[i] = store.acquire("a")

    threads = [threading.Thread(target=fault, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert len(calls) == 1                        # one build, shared
    assert leases[0].pg is leases[1].pg
    assert store.faults == 1
    desc = {e["graph_id"]: e for e in store.describe()}
    assert desc["a"]["pins"] == 2
    for lease in leases:
        lease.release()


def test_fault_in_progress_does_not_block_other_entries(g_a, g_b, g_c,
                                                        monkeypatch):
    """While tenant A's cold fault materializes (store lock RELEASED),
    tenant B can acquire its resident graph and a third tenant can
    publish — no head-of-line blocking on the registry."""
    from repro_torch.store import registry as reg
    budget = _budget_for(g_a, 1.5)
    store = GraphStore(budget_bytes=budget, num_shards=4, pad_multiple=16,
                       spill_budget_bytes=0)
    store.publish("a", g_a)
    store.publish("b", g_b)                       # "a" discarded
    real = reg.partition_graph
    entered, gate = threading.Event(), threading.Event()

    def gated(graph, *args, **kwargs):
        if graph is g_a:                          # block only A's build
            entered.set()
            assert gate.wait(30)
        return real(graph, *args, **kwargs)

    monkeypatch.setattr(reg, "partition_graph", gated)
    done = {}

    def fault_a():
        done["a"] = store.acquire("a")

    t = threading.Thread(target=fault_a)
    t.start()
    try:
        assert entered.wait(30)                   # A's build is in flight
        lease_b = store.acquire("b")              # resident: returns at once
        assert lease_b.pg is not None
        assert store.publish("c", g_c) == 1       # full publish+materialize
        assert store.snapshot()["graphs"] == 3
        assert "a" not in done                    # A genuinely still faulting
        lease_b.release()
    finally:
        gate.set()
        t.join(30)
    assert done["a"].pg.num_vertices == g_a.num_vertices
    done["a"].release()


def test_tenant_fault_does_not_block_other_tenant_queries(g_a, g_b,
                                                          monkeypatch):
    """Service-level head-of-line check: a tenant-A fault in progress
    must not block a tenant-B submit/flush round-trip."""
    from repro_torch.store import registry as reg
    budget = _budget_for(g_a, 1.5)
    svc = GraphQueryService(num_shards=4, max_batch=4, slots=4,
                            scheduling="continuous", memory_budget=budget,
                            spill_budget=0, result_cache_size=0, device="cpu")
    svc.add_graph("a", g_a, pad_multiple=16)
    svc.add_graph("b", g_b, pad_multiple=16)      # "a" discarded
    svc.query("b", "bfs", root=0, deadline_ms=60_000)   # warm B's plans
    real = reg.partition_graph
    entered, gate = threading.Event(), threading.Event()

    def gated(graph, *args, **kwargs):
        if graph is g_a:
            entered.set()
            assert gate.wait(60)
        return real(graph, *args, **kwargs)

    monkeypatch.setattr(reg, "partition_graph", gated)
    res_holder = {}

    def tenant_a():
        res_holder["a"] = svc.query("a", "bfs", root=0, tenant="A",
                                    deadline_ms=600_000)

    t = threading.Thread(target=tenant_a)
    t.start()
    try:
        assert entered.wait(30)                   # A blocked mid-fault
        res_b = svc.query("b", "bfs", root=1, tenant="B",
                          deadline_ms=60_000)     # full submit->result
        assert res_b.supersteps > 0
        assert "a" not in res_holder
    finally:
        gate.set()
        t.join(60)
    pg_a = PT.partition_graph(g_a, 4, pad_multiple=16)
    ref = Engine(ALG.bfs(0), pg_a, mode="gravfm", backend="ref",
                 device="cpu").run()
    assert np.array_equal(res_holder["a"].state["parent"],
                          ref.state["parent"])


def test_publish_during_fault_does_not_resurrect_retired_version(
        g_a, g_b, g_c, monkeypatch):
    """A publish landing while an unpinned version's fault materializes
    retires that version (pins==0); the materializer must then DROP its
    build — not install into the tombstone and lease a superseded
    version."""
    from repro_torch.store import registry as reg
    budget = _budget_for(g_a, 1.5)
    store = GraphStore(budget_bytes=budget, num_shards=4, pad_multiple=16,
                       spill_budget_bytes=0)
    store.publish("a", g_a)
    store.publish("b", g_b)                       # "a" v1 discarded
    real = reg.partition_graph
    entered, gate = threading.Event(), threading.Event()

    def gated(graph, *args, **kwargs):
        if graph is g_a:
            entered.set()
            assert gate.wait(30)
        return real(graph, *args, **kwargs)

    monkeypatch.setattr(reg, "partition_graph", gated)
    result = {}

    def fault_v1():
        try:
            result["lease"] = store.acquire("a", 1)
        except StoreError as exc:
            result["err"] = exc

    t = threading.Thread(target=fault_v1)
    t.start()
    try:
        assert entered.wait(30)                   # v1's build in flight
        assert store.publish("a", g_c) == 2       # v1 (pins==0) retires
    finally:
        gate.set()
        t.join(30)
    assert "lease" not in result
    assert "superseded" in str(result["err"])
    desc = {e["version"]: e for e in store.describe()
            if e["graph_id"] == "a"}
    assert not desc[1]["resident"]                # tombstone stayed dead
    with store.acquire("a") as lease:
        assert lease.version == 2


def test_explicit_discard_refused_while_refault_in_flight(g_a, g_b):
    """evict(spill=False) during an in-progress refault must refuse (the
    build is reading the spilled layout; discarding would also drop the
    version's plans mid-refault)."""
    budget = _budget_for(g_a, 1.5)
    store = GraphStore(budget_bytes=budget, num_shards=4, pad_multiple=16)
    store.publish("a", g_a)
    store.publish("b", g_b)                       # "a" spilled
    entered, gate = threading.Event(), threading.Event()

    def gated_refault(graph_id, version):
        entered.set()
        assert gate.wait(30)

    store.add_refault_listener(gated_refault)
    result = {}

    def fault():
        result["lease"] = store.acquire("a")

    t = threading.Thread(target=fault)
    t.start()
    try:
        assert entered.wait(30)                   # refault mid-build
        assert store.evict("a", spill=False) is False
        assert store.snapshot()["discards"] == 0
    finally:
        gate.set()
        t.join(30)
    assert result["lease"].pg.num_vertices == g_a.num_vertices
    result["lease"].release()


# ---------------------------------------------------------------------------
# publish validation + superseded-acquire guard (bugfix regressions)
# ---------------------------------------------------------------------------

def test_publish_rejects_nonpositive_spec(g_a):
    """Explicit zeros must raise, not silently take the defaults."""
    store = GraphStore(num_shards=4, pad_multiple=16)
    with pytest.raises(StoreError, match="num_shards"):
        store.publish("g", g_a, num_shards=0)
    with pytest.raises(StoreError, match="num_shards"):
        store.publish("g", g_a, num_shards=-2)
    with pytest.raises(StoreError, match="pad_multiple"):
        store.publish("g", g_a, pad_multiple=0)
    with pytest.raises(StoreError, match="method"):
        store.publish("g", g_a, method="nope")
    assert store.known_version("g") == 0          # nothing registered


def test_acquire_superseded_nonresident_raises(g_a, g_b):
    """A superseded version whose retirement is pending must not be
    re-materialized by a late acquire — only re-pinning the
    still-resident drain is legal."""
    store = GraphStore(num_shards=4, pad_multiple=16)
    store.publish("g", g_a)
    lease = store.acquire("g", 1)
    store.publish("g", g_b)                       # v1 superseded, draining
    # re-pinning the resident draining version is the dispatch path
    store.acquire("g", 1).release()
    # the un-drained window: v1 loses device residency while registered
    store._versions[("g", 1)].pg = None
    with pytest.raises(StoreError, match="superseded"):
        store.acquire("g", 1)
    lease.release()                               # drain completes
    assert store.latest_version("g") == 2
    with store.acquire("g") as lease2:
        assert lease2.version == 2


# ---------------------------------------------------------------------------
# tenancy policy
# ---------------------------------------------------------------------------

def test_token_bucket_injected_time():
    b = TokenBucket(rate=2.0, burst=2, now=0.0)
    assert b.try_take(now=0.0) and b.try_take(now=0.0)
    assert not b.try_take(now=0.0)                # burst exhausted
    assert b.try_take(now=0.5)                    # 0.5s * 2/s = 1 token
    assert not b.try_take(now=0.5)
    assert b.try_take(now=10.0)                   # refill caps at burst
    assert b.try_take(now=10.0)
    assert not b.try_take(now=10.0)


def test_tenant_registry_defaults_and_quota():
    reg = TenantRegistry()
    assert reg.weight("anon") == 1.0
    assert reg.admit("anon")                      # unlimited by default
    reg.configure("paid", weight=4.0, rate_qps=2.0, burst=2, now=0.0)
    assert reg.weight("paid") == 4.0
    assert reg.admit("paid", now=0.0) and reg.admit("paid", now=0.0)
    assert not reg.admit("paid", now=0.0)
    assert reg.admit("paid", now=1.0)


# ---------------------------------------------------------------------------
# service integration
# ---------------------------------------------------------------------------

def test_add_graph_republish_is_version_publish(g_a, g_b):
    svc = GraphQueryService(num_shards=4, max_batch=4, device="cpu")
    svc.add_graph("g", g_a, pad_multiple=16)
    svc.add_graph("g", g_a, pad_multiple=16)      # idempotent
    assert svc.store.latest_version("g") == 1
    res_v1 = svc.query("g", "bfs", root=0)
    assert svc.publish("g", g_b, pad_multiple=16) == 2
    res_v2 = svc.query("g", "bfs", root=0)
    pg_b = PT.partition_graph(g_b, 4, pad_multiple=16)
    ref = Engine(ALG.bfs(0), pg_b, mode="gravfm", backend="ref",
                 device="cpu").run()
    assert np.array_equal(res_v2.state["parent"], ref.state["parent"])
    # the two versions genuinely differ
    assert not np.array_equal(res_v1.state["parent"],
                              res_v2.state["parent"])


def test_add_graph_unversioned_service_raises(g_a, g_b):
    svc = GraphQueryService(num_shards=4, max_batch=4, versioned=False,
                            device="cpu")
    svc.add_graph("g", g_a, pad_multiple=16)
    with pytest.raises(StoreError):
        svc.add_graph("g", g_b, pad_multiple=16)


def test_result_cache_is_version_scoped(g_a, g_b):
    svc = GraphQueryService(num_shards=4, max_batch=4, device="cpu")
    svc.add_graph("g", g_a, pad_multiple=16)
    svc.query("g", "bfs", root=0)
    svc.publish("g", g_b, pad_multiple=16)
    res = svc.query("g", "bfs", root=0)           # must NOT hit v1's cache
    assert svc.stats_snapshot()["result_cache_hits"] == 0
    pg_b = PT.partition_graph(g_b, 4, pad_multiple=16)
    ref = Engine(ALG.bfs(0), pg_b, mode="gravfm", backend="ref",
                 device="cpu").run()
    assert np.array_equal(res.state["parent"], ref.state["parent"])
    svc.query("g", "bfs", root=0)                 # same version: hit
    assert svc.stats_snapshot()["result_cache_hits"] == 1
    # v1's entries were purged when its drained version retired — dead
    # keys must not squeeze live ones out of the bounded LRU
    assert all(k[1] != 1 for k in svc._result_cache)


def test_eviction_pin_race_query_completes_bit_identical(deep_graph, g_b):
    """A graph chosen for eviction while a query is in flight must stay
    pinned until the query retires, and the result must be bit-identical
    to a solo run."""
    budget = _budget_for(deep_graph, 1.2)
    svc = GraphQueryService(num_shards=4, max_batch=4, slots=4,
                            scheduling="continuous",
                            memory_budget=budget, result_cache_size=0,
                                device="cpu")
    svc.add_graph("deep", deep_graph, pad_multiple=16)
    svc.add_graph("other", g_b, pad_multiple=16)  # evicts idle "deep"
    assert svc.store.evictions >= 1
    fut = svc.submit(QueryRequest("deep", "bfs", {"root": 0},
                                  deadline_ms=60_000))   # faults it back
    for _ in range(3):
        svc.poll()                                # in flight, pinned
    assert not fut.done()
    # pressure from the other tenant while "deep" is pinned
    f2 = svc.submit(QueryRequest("other", "bfs", {"root": 0},
                                 deadline_ms=60_000))
    svc.flush()
    assert svc.store.snapshot()["budget_overcommits"] >= 1
    pg_deep = PT.partition_graph(deep_graph, 4, pad_multiple=16)
    ref = Engine(ALG.bfs(0), pg_deep, mode="gravfm", backend="ref",
                 device="cpu").run()
    res = fut.result()
    assert np.array_equal(res.state["parent"], ref.state["parent"])
    assert res.supersteps == ref.supersteps
    assert res.messages == ref.messages
    assert f2.result() is not None
    assert svc.store.faults >= 1


def test_version_swap_isolation_inflight_drains_on_old(deep_graph, g_a,
                                                       g_b):
    """publish() while queries are in flight: they drain on version N
    bit-identically; new arrivals bind N+1; N's plans are dropped after
    the drain without touching other graphs' cache entries."""
    svc = GraphQueryService(num_shards=4, max_batch=4, slots=4,
                            scheduling="continuous", result_cache_size=0,
                                device="cpu")
    svc.add_graph("g", deep_graph, pad_multiple=16)
    svc.add_graph("bystander", g_b, pad_multiple=16)
    f_by = svc.submit(QueryRequest("bystander", "bfs", {"root": 0},
                                   deadline_ms=60_000))
    f_old = svc.submit(QueryRequest("g", "bfs", {"root": 0},
                                    deadline_ms=60_000))
    for _ in range(3):
        svc.poll()
    assert not f_old.done()                       # mid-flight on v1
    assert svc.publish("g", g_a, pad_multiple=16) == 2
    f_new = svc.submit(QueryRequest("g", "bfs", {"root": 0},
                                    deadline_ms=60_000))
    svc.flush()
    pg_v1 = PT.partition_graph(deep_graph, 4, pad_multiple=16)
    ref_v1 = Engine(ALG.bfs(0), pg_v1, mode="gravfm", backend="ref",
                    device="cpu").run()
    res_old = f_old.result()
    assert np.array_equal(res_old.state["parent"], ref_v1.state["parent"])
    assert res_old.supersteps == ref_v1.supersteps
    assert res_old.messages == ref_v1.messages
    pg_v2 = PT.partition_graph(g_a, 4, pad_multiple=16)
    ref_v2 = Engine(ALG.bfs(0), pg_v2, mode="gravfm", backend="ref",
                    device="cpu").run()
    assert np.array_equal(f_new.result().state["parent"],
                          ref_v2.state["parent"])
    assert f_by.result() is not None
    # stale-plan invalidation: v1's stepper plans are gone (its drain
    # released the last pin -> superseded version evicted), v2's and the
    # bystander's survive
    versions = {(k.graph_id, k.version) for k in svc.plans._steppers}
    assert ("g", 1) not in versions
    assert ("g", 2) in versions
    assert ("bystander", 1) in versions
    desc = {(e["graph_id"], e["version"]): e for e in svc.store.describe()}
    assert not desc[("g", 1)]["resident"]


def test_fair_share_weighted_slots(g_a):
    """Two flooding tenants at weights 2:1 on one class retire queries
    in ~2:1 ratio while contended."""
    svc = GraphQueryService(num_shards=4, max_batch=6, slots=6,
                            scheduling="continuous", result_cache_size=0,
                                device="cpu")
    svc.add_graph("g", g_a, pad_multiple=16)
    svc.set_tenant("heavy", weight=2.0)
    svc.set_tenant("light", weight=1.0)
    n_each = 24
    rng = np.random.default_rng(0)
    roots = iter(int(r) for r in
                 rng.integers(0, g_a.num_vertices, size=2 * n_each))
    futs = {"heavy": [], "light": []}
    for _ in range(n_each):
        for t in ("heavy", "light"):
            futs[t].append(svc.submit(QueryRequest(
                "g", "bfs", {"root": next(roots)},
                tenant=t, deadline_ms=600_000)))
    # pump while contended: stop as soon as either side's queue could
    # run dry (half the work done), then compare completion counts
    for _ in range(200):
        svc.poll()
        done_h = sum(f.done() for f in futs["heavy"])
        done_l = sum(f.done() for f in futs["light"])
        if done_h + done_l >= n_each:
            break
    assert done_h + done_l >= n_each
    ratio = done_h / max(done_l, 1)
    assert 2.0 * 0.8 <= ratio <= 2.0 * 1.25, (done_h, done_l)
    svc.flush()
    for fs in futs.values():
        for f in fs:
            assert f.result() is not None
    snap = svc.stats_snapshot()
    assert snap["tenants"]["heavy"]["completed"] == n_each
    assert snap["tenants"]["light"]["completed"] == n_each


def test_tenant_rate_quota_sheds(g_a):
    svc = GraphQueryService(num_shards=4, max_batch=4, device="cpu")
    svc.add_graph("g", g_a, pad_multiple=16)
    svc.set_tenant("capped", rate_qps=0.001, burst=2)
    f1 = svc.submit(QueryRequest("g", "bfs", {"root": 0}, tenant="capped"))
    f2 = svc.submit(QueryRequest("g", "bfs", {"root": 1}, tenant="capped"))
    f3 = svc.submit(QueryRequest("g", "bfs", {"root": 2}, tenant="capped"))
    with pytest.raises(AdmissionError, match="rate quota"):
        f3.result(timeout=0)
    svc.flush()
    assert f1.result() is not None and f2.result() is not None
    snap = svc.stats_snapshot()
    assert snap["tenants"]["capped"]["shed"] == 1
    assert snap["queries_shed"] == 1
    # other tenants are unaffected by the capped tenant's dry bucket
    f4 = svc.submit(QueryRequest("g", "bfs", {"root": 3}))
    svc.flush()
    assert f4.result() is not None


def test_publish_while_bucketed_queries_queued_drains_on_old(g_a, g_b):
    """A queued-but-undispatched bucketed request pins its version from
    submit, so a publish() in the queue-wait window cannot retire the
    version out from under the waiting batch."""
    svc = GraphQueryService(num_shards=4, max_batch=8,
                            device="cpu")   # bucketed
    svc.add_graph("g", g_a, pad_multiple=16)
    f_old = svc.submit(QueryRequest("g", "bfs", {"root": 0},
                                    deadline_ms=60_000))
    assert not f_old.done()                    # waiting in the batcher
    assert svc.publish("g", g_b, pad_multiple=16) == 2
    f_new = svc.submit(QueryRequest("g", "bfs", {"root": 0},
                                    deadline_ms=60_000))
    svc.flush()
    pg_a = PT.partition_graph(g_a, 4, pad_multiple=16)
    ref_a = Engine(ALG.bfs(0), pg_a, mode="gravfm", backend="ref",
                   device="cpu").run()
    assert np.array_equal(f_old.result().state["parent"],
                          ref_a.state["parent"])
    pg_b = PT.partition_graph(g_b, 4, pad_multiple=16)
    ref_b = Engine(ALG.bfs(0), pg_b, mode="gravfm", backend="ref",
                   device="cpu").run()
    assert np.array_equal(f_new.result().state["parent"],
                          ref_b.state["parent"])
    # v1 drained -> retired: host payloads released, tombstone remains
    desc = {(e["graph_id"], e["version"]): e for e in svc.store.describe()}
    assert not desc[("g", 1)]["resident"]


def test_plan_cache_conflicts_with_budget_args(g_a):
    cache = PlanCache(device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        GraphQueryService(plan_cache=cache, memory_budget=1e9, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        GraphQueryService(plan_cache=cache, versioned=False, device="cpu")


def test_plan_cache_version_zero_resolves_latest(g_a, g_b):
    """PlanKey(version=0) — the pre-store API — binds the store's latest
    published version at lookup time."""
    from repro_torch.service import PlanKey
    cache = PlanCache(device="cpu")
    cache.register_graph("g", g_a, num_shards=4, pad_multiple=16)
    key = PlanKey(graph_id="g", kernel="bfs", mode="gravfm",
                  num_shards=4, batch_size=2, backend="ref")
    plan1 = cache.get_plan(key)
    assert plan1.key.version == 1
    cache.register_graph("g", g_b, num_shards=4, pad_multiple=16)
    plan2 = cache.get_plan(key)
    assert plan2.key.version == 2
    assert plan2 is not plan1


def test_store_counters_in_stats_endpoint(g_a):
    svc = GraphQueryService(num_shards=4, max_batch=4, device="cpu")
    svc.add_graph("g", g_a, pad_multiple=16)
    snap = svc.stats_snapshot()
    assert snap["store_resident_graphs"] == 1
    assert snap["store_resident_bytes"] > 0
    assert snap["store_evictions"] == 0
    assert "tenants" in snap


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

_PARITY_KEYS = ("graphs", "versions", "resident_graphs", "resident_bytes",
                "spilled_graphs", "spilled_bytes", "pinned_graphs",
                "budget_bytes", "spill_budget_bytes", "publishes",
                "evictions", "spills", "discards", "faults",
                "budget_overcommits", "parked_bytes", "lane_parks")


def _store_sequence(store_cls, graphs, budget):
    """Publish three graphs under a budget that holds one and a half and
    a host tier that holds one; refault, pin, publish a version under the
    pin, overcommit, release. The snapshot and residency after each
    step."""
    store = store_cls(budget_bytes=budget, num_shards=4, pad_multiple=16,
                      spill_budget_bytes=budget)
    a, b, c = graphs
    seen = []

    def look():
        snap = store.snapshot()
        seen.append(([snap[k] for k in _PARITY_KEYS],
                     sorted((e["graph_id"], e["version"], e["resident"],
                             e["spilled"], e["pins"], e["superseded"])
                            for e in store.describe())))

    for gid, g in (("a", a), ("b", b), ("c", c)):
        store.publish(gid, g)
        look()
    lease = store.acquire("b")            # spilled: refault
    look()
    lease_a = store.acquire("a")          # discarded: cold fault, pinned
    look()
    store.publish("b", c)                 # a version under b's pin
    look()
    lease.release()
    look()
    lease_a.release()
    with store.acquire("c"):
        look()
    look()
    return seen


def test_store_sequence_matches_jax(g_a, g_b, g_c):
    from repro.store import GraphStore as JaxStore
    budget = _budget_for(g_a, 1.5)
    port = _store_sequence(GraphStore, (g_a, g_b, g_c), budget)
    ref = _store_sequence(JaxStore, tuple(jax_graph(g) for g in
                                          (g_a, g_b, g_c)), budget)
    assert port == ref
    counters = dict(zip(_PARITY_KEYS, port[-1][0]))
    assert counters["evictions"] >= 1 and counters["spills"] >= 1
    assert counters["faults"] >= 2 and counters["discards"] >= 1


def _engine_bytes(svc_cls, graph, **kw):
    """What a service's store charges one graph once its engine is built
    (the engine tier)."""
    svc = svc_cls(num_shards=4, max_batch=4, **kw)
    svc.add_graph("g", graph, pad_multiple=16)
    svc.query("g", "bfs", root=0)
    return svc.store.snapshot()["resident_bytes"]


def test_budgeted_tenants_stream_matches_jax(g_a, g_b, g_c):
    """Three tenants, each with its graph, under a memory budget of 2.5
    graphs' engines, one BFS wave per tenant in turn: the answers and
    the store's counters equal the JAX service's. Each package's budget
    is 2.5 of its own engine's bytes: the port's engines hold int64
    gather indices and the kernel's work list, so they are larger than
    the JAX engines (ROADMAP section 3)."""
    from repro.service import GraphQueryService as JaxService
    from repro.service import QueryRequest as JaxRequest
    unit = {"jax": _engine_bytes(JaxService, jax_graph(g_a), backend="ref"),
            "torch": _engine_bytes(GraphQueryService, g_a, device="cpu")}
    assert unit["torch"] > unit["jax"]
    kw = dict(num_shards=4, max_batch=4, result_cache_size=0)
    svcs = {"jax": JaxService(backend="ref",
                              memory_budget=2.5 * unit["jax"], **kw),
            "torch": GraphQueryService(device="cpu",
                                       memory_budget=2.5 * unit["torch"],
                                       **kw)}
    graphs = {"a": g_a, "b": g_b, "c": g_c}
    rng = np.random.default_rng(7)
    order = ["a", "b", "c", "a", "c", "b"]
    roots = rng.integers(0, 300, size=(len(order), 3))
    out = {}
    for tag, svc in svcs.items():
        for gid, g in graphs.items():
            svc.add_graph(gid, jax_graph(g) if tag == "jax" else g,
                          pad_multiple=16)
        Req = JaxRequest if tag == "jax" else QueryRequest
        res = []
        for gid, rs in zip(order, roots):
            futs = [svc.submit(Req(gid, "bfs", {"root": int(r)},
                                   tenant=f"tenant-{gid}",
                                   deadline_ms=600_000)) for r in rs]
            svc.flush()
            res += [f.result(timeout=0) for f in futs]
        snap = svc.stats_snapshot()
        out[tag] = (res, {k: v for k, v in snap.items()
                          if k.startswith("store_")
                          and not k.endswith(("_ms", "_bytes"))},
                    {t: (v["completed"], v["shed"])
                     for t, v in snap["tenants"].items()})
    for t, j in zip(out["torch"][0], out["jax"][0]):
        assert_same_result(t, j)
    assert out["torch"][1] == out["jax"][1]
    assert out["torch"][2] == out["jax"][2]
    store = out["torch"][1]
    assert store["store_evictions"] >= 1 and store["store_faults"] >= 1


def test_fair_share_matches_jax(g_a):
    """Two flooding tenants at weights 2:1: the same completions after
    every poll as the JAX service (the same stride scheduling), with one
    injected arrival time."""
    from repro.service import QueryRequest as JaxRequest
    kw = dict(num_shards=4, max_batch=6, slots=6, scheduling="continuous",
              result_cache_size=0)
    jsvc = jax_service(g_a, **kw)
    tsvc = GraphQueryService(device="cpu", **kw)
    tsvc.add_graph("g", g_a, pad_multiple=16)
    for svc in (jsvc, tsvc):
        svc.set_tenant("heavy", weight=2.0)
        svc.set_tenant("light", weight=1.0)
    rng = np.random.default_rng(0)
    roots = iter(int(r) for r in rng.integers(0, g_a.num_vertices, size=48))
    wave = [("bfs", {"root": next(roots)},
             {"tenant": t, "deadline_ms": 600_000.0})
            for _ in range(24) for t in ("heavy", "light")]
    t0 = time.perf_counter()
    jf, jdone = serve_waves(jsvc, JaxRequest, [wave], polls=12,
                            arrival_s=t0)
    tf, tdone = serve_waves(tsvc, QueryRequest, [wave], polls=12,
                            arrival_s=t0)
    assert tdone == jdone
    heavy = sum(tdone[-1][0::2])
    light = sum(tdone[-1][1::2])
    assert heavy > light > 0              # contended: 2:1 slot shares
    jsvc.flush()
    tsvc.flush()
    for j, t in zip(jf, tf):
        assert_same_result(t.result(timeout=0), j.result(timeout=0))
    jsnap, tsnap = jsvc.stats_snapshot(), tsvc.stats_snapshot()
    for name in COUNTERS:
        assert tsnap[name] == jsnap[name], name


def test_rate_quota_sheds_match_jax(g_a):
    """The same admissions under ``TokenBucket`` with injected time, and
    the same sheds of a capped tenant's burst through each service."""
    from repro.service import QueryRequest as JaxRequest
    from repro.store import TenantRegistry as JaxRegistry
    from repro.store import TokenBucket as JaxBucket
    times = np.cumsum(np.random.default_rng(1).exponential(0.2, size=64))
    got = {}
    for tag, bucket_cls, reg_cls in (("jax", JaxBucket, JaxRegistry),
                                     ("torch", TokenBucket,
                                      TenantRegistry)):
        b = bucket_cls(rate=3.0, burst=4, now=0.0)
        reg = reg_cls()
        reg.configure("paid", weight=2.0, rate_qps=2.0, burst=2, now=0.0)
        got[tag] = ([b.try_take(now=float(t)) for t in times],
                    [reg.admit("paid", now=float(t)) for t in times],
                    reg.weight("paid"), reg.weight("anon"))
    assert got["torch"] == got["jax"]
    assert 0 < sum(got["torch"][0]) < len(times)
    sheds = {}
    for tag in ("jax", "torch"):
        svc = (jax_service(g_a, num_shards=4, max_batch=4) if tag == "jax"
               else GraphQueryService(device="cpu", num_shards=4,
                                      max_batch=4))
        if tag == "torch":
            svc.add_graph("g", g_a, pad_multiple=16)
        Req = JaxRequest if tag == "jax" else QueryRequest
        svc.set_tenant("capped", rate_qps=0.001, burst=3)
        futs = [svc.submit(Req("g", "bfs", {"root": r}, tenant="capped"))
                for r in range(8)]
        futs.append(svc.submit(Req("g", "bfs", {"root": 9})))
        svc.flush()
        outcome = []
        for f in futs:
            try:
                f.result(timeout=0)
                outcome.append("ok")
            except Exception as exc:     # noqa: BLE001 — the shed
                outcome.append(type(exc).__name__)
        snap = svc.stats_snapshot()
        sheds[tag] = (outcome, snap["queries_shed"],
                      {t: v["shed"] for t, v in snap["tenants"].items()})
    assert sheds["torch"] == sheds["jax"]
    assert sheds["torch"][1] == 5


# ---------------------------------------------------------------------------
# shard-engine variant: the port on LocalMesh(8, "cpu"), the JAX
# shard_map engine in a subprocess with 8 forced host devices
# ---------------------------------------------------------------------------

_SHARDMAP_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
sys.path.insert(0, {src!r})
import numpy as np
from repro.core import graph as G, partition as PT, algorithms as ALG
from repro.core.engine_shardmap import ShardEngine
from repro.launch.mesh import compat_make_mesh
from repro.store import GraphStore

mesh = compat_make_mesh((8,), ("graph",))
deep = G.ladder(2, 30, 1, seed=0)
other = G.uniform(300, 6.0, seed=2).symmetrized()
budget = 1.2 * PT.partition_graph(deep, 8, pad_multiple=16).device_nbytes
store = GraphStore(budget_bytes=budget, num_shards=8, pad_multiple=16)
store.publish("deep", deep)
store.publish("other", other)
lease = store.acquire("deep")
se = ShardEngine(ALG.bfs(), lease.pg, mesh=mesh, exchange="allgather",
                 backend="ref")
st = se.make_stepper(2)
carry, act, steps = st.init({{"root": np.zeros(2, np.int32)}})
occ = np.zeros(2, bool); occ[0] = True
for _ in range(3):
    carry, act, steps = st.step(carry, occ)
lease2 = store.acquire("other")
store.publish("deep", other)
for _ in range(1000):
    occ &= act
    if not occ.any():
        break
    carry, act, steps = st.step(carry, occ)
res = se.lane_result(st.fetch(carry), 0)
lease.release()
lease2.release()
snap = store.snapshot()
print("JAX-STORE-SHARD " + json.dumps({{
    "parent": np.asarray(res["state"]["parent"]).tolist(),
    "supersteps": int(res["supersteps"]),
    "messages": int(res["messages"]),
    "counters": [snap[k] for k in {keys!r}]}}))
"""

_STORE_KEYS = ("publishes", "evictions", "spills", "discards", "faults",
               "budget_overcommits", "resident_graphs", "spilled_graphs",
               "pinned_graphs", "versions")


def test_store_shardmap_eviction_pin_and_version_swap():
    from repro_torch.core.engine_shardmap import ShardEngine
    from repro_torch.core.mesh import LocalMesh
    mesh = LocalMesh(8, "cpu")
    deep = G.ladder(2, 30, 1, seed=0)
    other = G.uniform(300, 6.0, seed=2).symmetrized()
    budget = 1.2 * PT.partition_graph(deep, 8, pad_multiple=16).device_nbytes
    store = GraphStore(budget_bytes=budget, num_shards=8, pad_multiple=16)
    store.publish("deep", deep)
    store.publish("other", other)        # idle "deep" evicted

    # fault "deep" back and start an in-flight shard continuous query
    lease = store.acquire("deep")
    assert store.faults == 1
    se = ShardEngine(ALG.bfs(), lease.pg, mesh=mesh, exchange="allgather",
                     backend="ref")
    st = se.make_stepper(2)
    carry, act, steps = st.init({"root": np.zeros(2, np.int32)})
    occ = np.zeros(2, bool)
    occ[0] = True
    for _ in range(3):
        carry, act, steps = st.step(carry, occ)

    # eviction pressure while pinned: "deep" must survive (overcommit)
    lease2 = store.acquire("other")
    assert {e["graph_id"]: e for e in store.describe()}["deep"]["resident"]
    assert store.snapshot()["budget_overcommits"] >= 1

    # version publish mid-flight: v1 pinned for its drain, v2 is latest
    store.publish("deep", other)
    assert store.latest_version("deep") == 2
    assert {(e["graph_id"], e["version"]): e["resident"]
            for e in store.describe()}[("deep", 1)]

    # finish the in-flight query on v1: bit-identical to a solo run
    for _ in range(1000):
        occ &= act
        if not occ.any():
            break
        carry, act, steps = st.step(carry, occ)
    res = se.lane_result(st.fetch(carry), 0)
    ref = Engine(ALG.bfs(0), PT.partition_graph(deep, 8, pad_multiple=16),
                 mode="gravfm", backend="ref", device="cpu").run()
    assert np.array_equal(res.state["parent"], ref.state["parent"])
    assert res.supersteps == ref.supersteps
    assert res.messages == ref.messages

    # drain: releasing the last pin evicts the superseded v1
    lease.release()
    assert not {(e["graph_id"], e["version"]): e["resident"]
                for e in store.describe()}[("deep", 1)]
    lease2.release()

    # the JAX shard_map engine, the same sequence: the same answer and
    # the same store counters
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    script = _SHARDMAP_SCRIPT.format(src=os.path.abspath(src),
                                     keys=_STORE_KEYS)
    proc = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("JAX-STORE-SHARD ")]
    assert line, proc.stdout[-2000:]
    want = json.loads(line[-1].split(" ", 1)[1])
    assert np.asarray(res.state["parent"]).tolist() == want["parent"]
    assert (res.supersteps, res.messages) == (want["supersteps"],
                                              want["messages"])
    snap = store.snapshot()
    assert [snap[k] for k in _STORE_KEYS] == want["counters"]
