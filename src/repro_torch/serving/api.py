"""Query-submission API + admission control (the serving front door).

The paper's prototype is a *serving system*: operators submit continuous
queries (CQs) against a live camera fleet, and the cloud fine-tunes /
ships a CQ model per query before the fleet can answer it.  This module
is the control-plane surface in front of that machinery:

  * ``TierSpec`` / ``TenantSpec`` — the scenario-level declarations of
    priority tiers (an SLO + an Eq. 7 pressure weight) and per-tenant
    submission quotas.
  * ``TokenBucket`` — the classic rate limiter the per-tenant quota runs
    on (simulated-clock driven: refill is computed from the event time,
    never from the wall clock, so admission verdicts are deterministic).
  * ``AdmissionController`` — the admit/shed decision at ``QueryArrival``:
    quota first, then shed on cloud fine-tune backlog in *reverse tier
    order* (tier 0 — the top tier — is backlog-exempt; each lower tier's
    backlog allowance halves, so under rush-hour load the low tiers shed
    first and the top tier keeps training headroom).
  * ``QueryAPI`` — submit/status/retire against a live pipeline, used by
    the asyncio driver (``serving.engine.AsyncDriver``) to inject queries
    mid-run; scenario-declared arrivals go through the same admission
    path, so simulated and live submissions are indistinguishable to the
    engine.

Nothing here imports the ``system/`` layer: the pipeline composes these
pieces, not the other way round.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One priority tier of the serving control plane.

    ``slo_s`` is the tier's end-to-end answer-latency objective;
    ``weight`` is the Eq. 7 / Eqs. 8-9 SLO-pressure gain: an item whose
    remaining slack is smaller than a node's drain time pays
    ``weight * (drain - slack)`` extra cost on that node, steering urgent
    work toward nodes that can still make the deadline (weight 0 keeps
    the allocator bit-identical to the tierless engine)."""
    tier: int
    name: str = ""
    slo_s: float = 5.0
    weight: float = 0.0

    def __post_init__(self):
        if self.tier < 0:
            raise ValueError(f"tier {self.tier} must be >= 0")
        if self.slo_s <= 0:
            raise ValueError(f"tier {self.tier}: slo_s={self.slo_s} "
                             f"must be positive")
        if self.weight < 0:
            raise ValueError(f"tier {self.tier}: weight={self.weight} "
                             f"must be >= 0")


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """Per-tenant submission quota: a token bucket of ``burst`` capacity
    refilling at ``rate`` queries/second of simulated time."""
    tenant: str
    rate: float
    burst: int = 1

    def __post_init__(self):
        if not self.tenant:
            raise ValueError("tenant name must be non-empty")
        if self.rate <= 0:
            raise ValueError(f"tenant {self.tenant!r}: rate={self.rate} "
                             f"must be positive")
        if self.burst < 1:
            raise ValueError(f"tenant {self.tenant!r}: burst={self.burst} "
                             f"must be >= 1")


class TokenBucket:
    """Simulated-clock token bucket (refill from event time deltas)."""

    def __init__(self, rate: float, burst: int):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._last_t = 0.0

    def take(self, t: float) -> bool:
        """Consume one token at simulated time ``t``; False if empty."""
        if t > self._last_t:
            self.tokens = min(self.burst,
                              self.tokens + (t - self._last_t) * self.rate)
            self._last_t = t
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


#: tier ``k >= 1`` sheds once the cloud's fine-tune backlog exceeds
#: ``backlog_limit_s * BACKLOG_TIER_DECAY ** (k - 1)`` — each lower tier
#: tolerates half the backlog of the one above it, so overload sheds
#: bottom-up.  Tier 0 is backlog-exempt (quota still applies).
BACKLOG_TIER_DECAY = 0.5


class AdmissionController:
    """The admit/shed verdict at query submission time.

    Returns ``None`` to admit, or a shed reason (``"quota"`` /
    ``"backlog"``) — the caller publishes the matching
    ``alerts/admission/<reason>`` event and marks the query shed.  Order
    matters: quota is charged first (a tenant flooding the API burns its
    own bucket even when the cloud is idle), backlog second."""

    def __init__(self, tenants: Tuple[TenantSpec, ...] = (),
                 backlog_limit_s: Optional[float] = None):
        self.backlog_limit_s = backlog_limit_s
        self._buckets: Dict[str, TokenBucket] = {
            tn.tenant: TokenBucket(tn.rate, tn.burst) for tn in tenants}
        self.admitted = 0
        self.shed: Dict[str, int] = {}

    def backlog_limit(self, tier: int) -> float:
        """This tier's backlog allowance in seconds (inf for tier 0)."""
        if tier <= 0 or self.backlog_limit_s is None:
            return float("inf")
        return self.backlog_limit_s * BACKLOG_TIER_DECAY ** (tier - 1)

    def admit(self, t: float, tenant: str, tier: int,
              backlog_s: float) -> Optional[str]:
        bucket = self._buckets.get(tenant)
        if bucket is not None and not bucket.take(t):
            self.shed["quota"] = self.shed.get("quota", 0) + 1
            return "quota"
        if backlog_s > self.backlog_limit(tier):
            self.shed["backlog"] = self.shed.get("backlog", 0) + 1
            return "backlog"
        self.admitted += 1
        return None


@dataclasses.dataclass
class SubmitResult:
    """One submission's outcome: ``admitted`` or ``shed:<reason>``."""
    query: int
    verdict: str

    @property
    def admitted(self) -> bool:
        return self.verdict == "admitted"


class QueryAPI:
    """Submit/status/retire against a live pipeline.

    Built for the asyncio driver: a ``serve_demo``-style client schedules
    ``submit`` calls via ``AsyncDriver.call_at`` and the query enters the
    SAME ``QueryArrival`` -> admission -> fine-tune -> ship -> serve path
    the scenario-declared queries take.  The admission verdict is not
    known at submit time (it is decided when the arrival event pops);
    poll ``status`` or read ``log`` after the run."""

    def __init__(self, pipe):
        self._pipe = pipe
        self.log: List[SubmitResult] = []

    def submit(self, t: float, spec) -> SubmitResult:
        """Register ``spec`` and enqueue its arrival at ``max(t,
        spec.t_arrive_s)``.  Raises ``ValueError`` on a duplicate id."""
        from repro_torch.system.events import QueryArrival
        self._pipe.register_query(spec)
        self._pipe.events.push(max(t, spec.t_arrive_s),
                               QueryArrival(spec.query, spec.kind))
        res = SubmitResult(spec.query, "submitted")
        self.log.append(res)
        return res

    def status(self, query: int) -> str:
        """``unknown | pending | shed | training | live | retired``."""
        qs = self._pipe.queries
        if query not in qs.specs:
            return "unknown"
        if qs.is_shed(query):
            return "shed"
        if qs.is_retired(query):
            return "retired"
        if qs.live_edges.get(query):
            return "live"
        if query in qs.train_s:
            return "training"
        return "pending"

    def retire(self, t: float, query: int) -> None:
        """Enqueue the query's retirement at ``t`` (idempotent: retiring
        a shed or already-retired query is a no-op at the handler)."""
        from repro_torch.system.events import QueryRetire
        if query not in self._pipe.queries.specs:
            raise ValueError(f"unknown query {query}")
        self._pipe.events.push(t, QueryRetire(query))
