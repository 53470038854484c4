"""Request admission and batch formation.

The port's own copy of ``repro.service.batching`` (numpy only): the
port imports nothing of the JAX package.

Incoming single queries are grouped by :class:`QueryClass` (everything
that must match for two queries to share one compiled plan: graph,
kernel, mode, shard count, backend). Within a class the batcher fills a
batch until either

  * it reaches ``max_batch`` (dispatch immediately — throughput bound), or
  * the oldest member's latency deadline minus ``slack_ms`` arrives
    (dispatch partially full — latency bound).

Dispatched batches are padded up to the next *bucket* size (powers of
two up to ``max_batch``) so the plan cache holds O(log max_batch) traced
programs per class instead of one per occupancy; padding lanes repeat
the first query's parameters and are dropped before results are
returned.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["QueryRequest", "QueryClass", "Batcher", "bucket_for",
           "BATCH_BUCKETS", "AdmissionError"]

BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


class AdmissionError(RuntimeError):
    """Raised (via the request's Future) when admission control sheds a
    query whose deadline is already infeasible given the backlog and the
    class's observed per-superstep cost — failing fast instead of
    burning a slot on an answer nobody will wait for."""

_qid_counter = itertools.count(1)


def bucket_for(n: int, max_batch: int) -> int:
    """Smallest power-of-two bucket >= n, capped at max_batch."""
    for b in BATCH_BUCKETS:
        if b >= n:
            return min(b, max_batch)
    return max_batch


@dataclasses.dataclass
class QueryRequest:
    """One user query. ``query_kwargs`` maps the kernel's declared
    ``query_params`` (e.g. ``{"root": 7}``) to scalars; ``deadline_ms``
    is the end-to-end latency budget the scheduler batches under;
    ``tenant`` selects the quota/fair-share policy the request is
    admitted and scheduled under; ``priority`` (higher = more urgent)
    feeds the continuous scheduler's deadline-priority ordering — each
    level is worth :data:`~repro_torch.core.stepper.PRIORITY_BOOST_S` (60 s)
    of deadline urgency, so it dominates ordinary deadline spreads but
    stays finite: deadlines more than 60 s apart (and long-parked
    lanes' aging credit) can still outrank it."""

    graph_id: str
    kernel: str
    query_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    mode: str = "gravfm"
    deadline_ms: float = 50.0
    tenant: str = "default"
    priority: int = 0
    exchange: str = ""   # shard exchange schedule ("" = service default)
    overlap: bool = False  # pipelined exchange schedule (shard classes)
    qid: int = dataclasses.field(default_factory=lambda: next(_qid_counter))
    arrival_s: float = dataclasses.field(default_factory=time.perf_counter)

    @property
    def deadline_s(self) -> float:
        return self.arrival_s + self.deadline_ms / 1e3


@dataclasses.dataclass(frozen=True)
class QueryClass:
    """Plan-compatibility key: requests in the same class can share one
    batched engine invocation. ``version`` is the published graph
    version the request bound at submit time — arrivals after a
    ``publish`` land in a fresh class (N+1) while the old class drains
    on N."""
    graph_id: str
    kernel: str
    mode: str
    num_shards: int
    backend: str
    version: int = 0
    exchange: str = ""   # "" = single-host Engine; else a ShardEngine mode
    # overlapped (pipelined) exchange schedule: a plan dimension like
    # ``exchange`` — overlapped and synchronous requests trace distinct
    # steppers but share one engine (and its device-resident graph), so
    # the toggle is free at steady state. Meaningful only for shard
    # classes (``exchange`` set); normalized off otherwise.
    overlap: bool = False

    @classmethod
    def of(cls, req: QueryRequest, num_shards: int,
           backend: str, version: int = 0,
           exchange: str = "", overlap: bool = False) -> "QueryClass":
        ex = req.exchange or exchange
        return cls(req.graph_id, req.kernel, req.mode, num_shards, backend,
                   version, ex, bool((req.overlap or overlap) and ex))


class Batcher:
    """Deadline-aware accumulator. Not thread-safe by itself — the server
    serializes access under its scheduler lock."""

    def __init__(self, *, max_batch: int = 32, slack_ms: float = 5.0):
        assert max_batch >= 1
        self.max_batch = max_batch
        self.slack_ms = slack_ms
        self._pending: Dict[QueryClass, List[Any]] = {}

    def __len__(self) -> int:
        return sum(len(v) for v in self._pending.values())

    def add(self, qclass: QueryClass, item: Any,
            batchable: bool) -> Optional[Tuple[QueryClass, List[Any]]]:
        """Enqueue one (request, future) item. Returns a full batch ready
        for dispatch, or None. Non-batchable classes (kernels with no
        query_params) dispatch immediately as singletons."""
        if not batchable:
            return qclass, [item]
        q = self._pending.setdefault(qclass, [])
        q.append(item)
        if len(q) >= self.max_batch:
            del self._pending[qclass]
            return qclass, q
        return None

    def _flush_time(self, items: List[Any]) -> float:
        """Latest time this batch can leave and still meet every member's
        deadline (minus dispatch slack)."""
        return min(it[0].deadline_s for it in items) - self.slack_ms / 1e3

    def due(self, now_s: Optional[float] = None
            ) -> List[Tuple[QueryClass, List[Any]]]:
        """Pop every class whose flush time has arrived."""
        now_s = time.perf_counter() if now_s is None else now_s
        out = []
        for qc in list(self._pending):
            items = self._pending[qc]
            if items and self._flush_time(items) <= now_s:
                out.append((qc, items))
                del self._pending[qc]
        return out

    def next_flush_s(self) -> Optional[float]:
        """Earliest pending flush time (None when idle) — what the
        scheduler thread sleeps until."""
        times = [self._flush_time(items)
                 for items in self._pending.values() if items]
        return min(times) if times else None

    def pop_class(self, qclass: QueryClass) -> List[Any]:
        """Remove and return one class's pending items ([] when none)."""
        return self._pending.pop(qclass, [])

    def pending_in_class(self, qclass: QueryClass) -> int:
        """Queued depth for one class (admission control's backlog)."""
        return len(self._pending.get(qclass, ()))

    def flush_all(self) -> List[Tuple[QueryClass, List[Any]]]:
        out = [(qc, items) for qc, items in self._pending.items() if items]
        self._pending.clear()
        return out
