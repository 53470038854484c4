"""Per-tenant quotas and fair-share policy for the query service.

The port's own copy of ``repro.store.tenancy``: the port imports
nothing of the JAX package.

Two mechanisms, both opt-in per tenant (unconfigured tenants get weight
1.0 and no rate limit):

  * **Token-bucket admission** — ``rate_qps`` sustained queries/sec with
    ``burst`` headroom. A tenant that exhausts its bucket is shed at
    submit time with :class:`~repro_torch.service.batching.AdmissionError`
    before it can occupy a scheduler slot.
  * **Weighted fair share** — ``weight`` drives stride scheduling in the
    continuous scheduler's admission window: each admitted query
    advances its tenant's virtual pass by ``1/weight``, and free lanes
    always go to the eligible tenant with the smallest pass. Over any
    contended interval tenants therefore retire queries in proportion
    to their weights (a 2.0-weight tenant gets ~2x the slots of a
    1.0-weight tenant), and one tenant's deep queries cannot starve
    another's shallow ones.

Time is injectable everywhere (``now`` parameters) so tests and the
deterministic benchmarks don't race the wall clock.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional

__all__ = ["TokenBucket", "TenantPolicy", "TenantRegistry",
           "DEFAULT_TENANT"]

DEFAULT_TENANT = "default"


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/sec refill, ``burst`` cap.
    ``try_take`` is non-blocking — admission control sheds, it never
    queues."""

    def __init__(self, rate: float, burst: float,
                 now: Optional[float] = None):
        assert rate > 0 and burst >= 1
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._stamp = time.perf_counter() if now is None else now

    def _refill(self, now: Optional[float]) -> None:
        now = time.perf_counter() if now is None else now
        if now > self._stamp:
            self._tokens = min(self.burst,
                               self._tokens + (now - self._stamp) * self.rate)
        self._stamp = now

    def try_take(self, n: float = 1.0, now: Optional[float] = None) -> bool:
        self._refill(now)
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False

    @property
    def tokens(self) -> float:
        return self._tokens


@dataclasses.dataclass
class TenantPolicy:
    """One tenant's serving contract."""
    name: str
    weight: float = 1.0
    rate_qps: Optional[float] = None    # None = unlimited
    burst: Optional[float] = None       # defaults to max(1, rate_qps)

    def __post_init__(self):
        assert self.weight > 0, "tenant weight must be positive"
        if self.rate_qps is not None and self.burst is None:
            self.burst = max(1.0, self.rate_qps)


class TenantRegistry:
    """Thread-safe tenant policy table + per-tenant token buckets."""

    def __init__(self):
        self._lock = threading.Lock()  # lock: tenancy
        self._policies: Dict[str, TenantPolicy] = {}
        self._buckets: Dict[str, TokenBucket] = {}

    def configure(self, name: str, *, weight: float = 1.0,
                  rate_qps: Optional[float] = None,
                  burst: Optional[float] = None,
                  now: Optional[float] = None) -> TenantPolicy:
        pol = TenantPolicy(name, weight=weight, rate_qps=rate_qps,
                           burst=burst)
        with self._lock:
            self._policies[name] = pol
            if pol.rate_qps is not None:
                self._buckets[name] = TokenBucket(pol.rate_qps, pol.burst,
                                                  now=now)
            else:
                self._buckets.pop(name, None)
        return pol

    def policy(self, name: str) -> TenantPolicy:
        with self._lock:
            return self._policies.get(name) or TenantPolicy(name)

    def weight(self, name: str) -> float:
        with self._lock:
            pol = self._policies.get(name)
            return pol.weight if pol is not None else 1.0

    def admit(self, name: str, now: Optional[float] = None) -> bool:
        """Charge one query to ``name``'s token bucket; unlimited tenants
        always pass."""
        with self._lock:
            bucket = self._buckets.get(name)
            return bucket.try_take(1.0, now=now) if bucket else True

    def policies(self) -> Dict[str, TenantPolicy]:
        with self._lock:
            return dict(self._policies)
