"""Runtime query lifecycle: the ``QuerySet`` registry + ``QuerySpec``.

SurveilEdge's headline workflow is *queries* arriving against a live
camera fleet, not one eternal query.  Each continuous query (CQ) moves
through

    arrival ──► cloud fine-tune (Fig. 5, ``core.finetune.scheme_train_time``)
            ──► per-edge CQ weight shipment (WAN downlink, FIFO)
            ──► live serving (per-(query, edge) Eqs. 8-9 thresholds,
                 fused into the same ONE triage launch per tick)
            ──► retire (threshold rows freed, feedback buffers cleared)

``QuerySet`` owns the lifecycle state machine; the orchestrator
(``system/pipeline.py``) drives it from ``QueryArrival`` / ``TrainDone``
/ ``ModelUpdate(kind="weights")`` / ``QueryRetire`` events.  Until a
query's weights *deliver* at an edge, that edge has no model to score the
query with: its detections wait in the pipeline's deferral buffer (the
query's escalations are thereby blocked while the cloud trains), and the
Fig. 5 training time surfaces as head-of-query latency — exactly the
trade the paper's Fig. 5 plots.

The lifecycle is modelled for the cascade schemes only (``surveiledge``,
``surveiledge_fixed`` — the schemes where the cloud actually fine-tunes
and ships CQ models).  ``cloud_only`` answers every query with the
cloud's accurate model (nothing to ship) and ``edge_only`` assumes
pre-provisioned edge models, so both serve every query from arrival.  A
scenario with no explicit ``queries`` runs one implicit query that is
born live everywhere — bit-identical to the pre-lifecycle engine.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Set, Tuple

from repro_torch.core.finetune import FIG5_SCHEMES, scheme_train_time

#: the implicit query id used when a scenario declares no explicit queries
DEFAULT_QUERY = 0


@dataclasses.dataclass(frozen=True)
class QuerySpec:
    """One continuous query's lifecycle declaration.

    ``train_scheme`` picks the Fig. 5 fine-tuning scheme the cloud runs on
    arrival; it also shapes the synthetic stream's class-conditional
    confidence sharpness (``scenario._SCHEME_BETAS``) — No-Fine-tune ships
    instantly but scores blurrier, All-Fine-tune scores sharpest but
    trains ~num_cameras-x longer.  ``t_retire_s=None`` means the query
    lives to the end of the run.

    ``tenant`` / ``tier`` are the control-plane coordinates (admission
    quotas and priority, ``repro_torch.serving.api``): both default to the
    tierless/quota-free engine, which keeps every pre-control-plane
    scenario bit-identical.

    ``kind`` selects what the query *asks*:

    * ``"classify"`` (the default — every pre-existing construction) —
      per-camera classification: is this crop the query class?
    * ``"track"`` — cross-camera re-ID: detections carry embeddings, the
      fleet-wide track registry (``system/tracks.py``) associates them
      against live tracks in ONE fused similarity launch per tick, and a
      predictive hand-off pre-warms the next-likely edge over the WAN
      downlink.  Track queries still ride the full classify lifecycle
      (fine-tune, weight shipment, triage, tiers, admission) — the track
      stage is additive."""
    query: int
    t_arrive_s: float = 0.0
    t_retire_s: Optional[float] = None
    train_scheme: str = "surveiledge"
    tenant: str = ""
    tier: int = 0
    kind: str = "classify"

    def __post_init__(self):
        if self.query < 0:
            raise ValueError(f"query id {self.query} must be >= 0")
        if self.kind not in ("classify", "track"):
            raise ValueError(
                f"query {self.query}: unknown kind {self.kind!r} "
                f"(expected 'classify' or 'track')")
        if self.tier < 0:
            raise ValueError(
                f"query {self.query}: tier={self.tier} must be >= 0")
        if self.t_arrive_s < 0:
            raise ValueError(
                f"query {self.query}: t_arrive_s={self.t_arrive_s} < 0")
        if self.t_retire_s is not None and self.t_retire_s <= self.t_arrive_s:
            raise ValueError(
                f"query {self.query}: t_retire_s={self.t_retire_s} must "
                f"exceed t_arrive_s={self.t_arrive_s}")
        if self.train_scheme not in FIG5_SCHEMES:
            raise ValueError(
                f"query {self.query}: unknown train_scheme "
                f"{self.train_scheme!r} (expected one of {FIG5_SCHEMES})")


class QuerySet:
    """Lifecycle state for every query in one run.

    State per query: pending -> training -> live on a growing set of edges
    (weights deliver edge by edge over the FIFO downlink, so a fleet goes
    live staggered) -> retired.  ``live_on`` is the single predicate the
    triage path asks; everything else is bookkeeping for the per-query
    report rows.
    """

    def __init__(self, sc):
        specs = sc.queries or (QuerySpec(DEFAULT_QUERY),)
        self.specs: Dict[int, QuerySpec] = {sp.query: sp for sp in specs}
        self.default = min(self.specs)
        # the lifecycle (train -> ship -> serve) is only modelled where the
        # cloud actually fine-tunes CQ models; see module docstring
        self.lifecycle = bool(sc.queries) and sc.scheme in (
            "surveiledge", "surveiledge_fixed")
        self._num_cameras = sc.num_cameras
        self._step_s = sc.train_step_s
        self._edge_ids = tuple(sc.edge_ids)
        self.live_edges: Dict[int, Set[int]] = {q: set() for q in self.specs}
        self.retired: Set[int] = set()
        self.shed: Set[int] = set()
        self.train_s: Dict[int, float] = {}
        self.train_window: Dict[int, Tuple[float, float]] = {}
        if not self.lifecycle:
            for q in self.specs:
                self.live_edges[q] = set(sc.edge_ids)

    def register(self, sp: QuerySpec) -> None:
        """Add a query at runtime (live API submission): it starts in the
        pending state and rides the same arrival -> train -> ship -> serve
        lifecycle as a scenario-declared query."""
        if sp.query in self.specs:
            raise ValueError(f"query {sp.query} already registered")
        self.specs[sp.query] = sp
        self.live_edges[sp.query] = set() if self.lifecycle \
            else set(self._edge_ids)

    # --- lifecycle transitions ------------------------------------------------
    def arrive(self, query: int, t: float) -> float:
        """The query enters: returns the Fig. 5 cloud training seconds its
        ``train_scheme`` costs (charged to the cloud by the caller)."""
        sp = self.specs[query]
        dt = scheme_train_time(sp.train_scheme, self._num_cameras,
                               step_s=self._step_s)
        self.train_s[query] = dt
        self.train_window[query] = (t, t + dt)
        return dt

    def activate(self, query: int, edge: int) -> None:
        """``query``'s CQ weights delivered at ``edge``: serving starts."""
        self.live_edges[query].add(edge)

    def retire(self, query: int) -> None:
        self.retired.add(query)

    def shed_query(self, query: int) -> None:
        """Admission refused the query: it never trains, never ships, and
        its stream items are dropped (counted) instead of answered."""
        self.shed.add(query)

    # --- predicates -----------------------------------------------------------
    def live_on(self, query: int, edge: int) -> bool:
        """Can ``edge`` triage this query's detections right now?"""
        return (query not in self.retired
                and edge in self.live_edges.get(query, ()))

    def is_retired(self, query: int) -> bool:
        return query in self.retired

    def is_shed(self, query: int) -> bool:
        return query in self.shed

    def training_at(self, query: int, t: float) -> bool:
        """Is the cloud inside this query's Fig. 5 fine-tune at ``t``?"""
        w = self.train_window.get(query)
        return w is not None and w[0] <= t < w[1]
