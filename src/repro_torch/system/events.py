"""Typed simulation events + the time-ordered event queue.

The pipeline's event loop is a plain priority queue over ``(time, seq,
event)`` triples; ``seq`` breaks time ties in push order, which the
orchestrator relies on (per-tick arrival batches are pushed before the
tick's queue-length sample, failures after both).  Events are small frozen
dataclasses so each handler dispatches on type, not on string tags.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple

from repro_torch.serving.simulator import Item


@dataclasses.dataclass
class Task:
    """One item travelling through the pipeline.

    The item's ``query`` rides along on the ``Item`` itself — routing and
    service are query-agnostic (the Eq. 7 allocator prices a node by its
    total load across every live query sharing it)."""
    item: Item
    phase: str                    # 'classify' (CQ) or 'reclassify' (accurate)
    decision: Optional[bool]      # set for classify tasks at triage time
    tx_s: float = 0.0             # seconds this task spent on the wire
    #                               (informational; the aggregate lives in
    #                               Transport — never fed to the node
    #                               latency estimators, which would let one
    #                               congestion burst bias Eq. 7 forever)
    # speculative escalation (Scenario.speculative_escalation): the edge's
    # provisional CQ verdict, served the instant the WAN upload *starts*
    # and reconciled when the cloud's reclassify verdict lands — the
    # stale-in-flight ModelUpdate delivery semantics generalized to
    # verdicts.  None on non-speculative tasks; carried across failover so
    # a stranded reclassify still reconciles against what was served.
    provisional: Optional[bool] = None
    t_provisional: Optional[float] = None     # when the edge served it


@dataclasses.dataclass(frozen=True)
class Sample:
    """Per-tick queue-length sampling point."""


@dataclasses.dataclass(frozen=True)
class Arrive:
    """One item entering the system directly (cloud_only streams per item)."""
    item: Item


@dataclasses.dataclass(frozen=True)
class TickArrivals:
    """All of one scheduler tick's detections, grouped by home edge.

    The cascade schemes consume this as ONE fused fleet-triage launch.
    ``tick`` is the scheduler tick index (the superstep planner keys its
    per-tick plan slices by it; -1 for legacy callers that never plan)."""
    batches: Dict[int, List[Item]]
    tick: int = -1


@dataclasses.dataclass(frozen=True)
class Transfer:
    """A task finishing its WAN/LAN transfer and landing on ``node``."""
    node: int
    task: Task


@dataclasses.dataclass(frozen=True)
class EdgeFail:
    """Edge ``node`` dies at this instant."""
    node: int


@dataclasses.dataclass(frozen=True)
class ServiceDone:
    """``node`` finishes serving ``task`` after ``service_s`` seconds."""
    node: int
    task: Task
    service_s: float


@dataclasses.dataclass(frozen=True)
class FeedbackTick:
    """Periodic cloud-side recalibration instant (every ``update_period_s``).

    The feedback stage fits every ready (query, edge) row's Platt
    calibration in ONE fused ``ops.calibrate_fleet`` launch and ships the
    parameters down the WAN downlink as per-row ``ModelUpdate`` events."""


@dataclasses.dataclass(frozen=True)
class ModelUpdate:
    """A per-query CQ model artifact arriving at ``edge`` over the WAN
    downlink.  Two kinds share the stale-in-flight delivery semantics:

    * ``kind="calibration"`` — recalibrated Platt ``params`` for the
      (query, edge) CQ confidence (the online feedback loop).
    * ``kind="weights"`` — the freshly fine-tuned CQ model itself (§IV-B):
      the edge starts serving the query only once this delivers; the
      query's detections wait in the edge's deferral buffer until then.
    * ``kind="prewarm"`` — a track query's predictive hand-off: the track
      stage predicted the target's next-likely edge and ships that edge's
      thresholds/CQ weights *before* the target arrives, turning the WAN
      downlink speculative.  At delivery the edge is marked warm for the
      query (``tracks.TrackStage.apply_prewarm``); ``params`` is None.

    Applied at *delivery* time: ticks that fire while the update is in
    flight still triage with the stale model/calibration — the same race a
    real edge device lives with (a pre-warm that delivers after the target
    has already crossed simply arrives too late to help)."""
    edge: int
    params: Optional[Tuple[float, float]]     # Platt (a, b); None otherwise
    query: int = 0
    kind: str = "calibration"                 # or "weights" / "prewarm"


@dataclasses.dataclass(frozen=True)
class QueryArrival:
    """A new continuous query (CQ) enters the system: the cloud starts its
    Fig. 5 fine-tune (``core.finetune.scheme_train_time``) the instant this
    fires; ``TrainDone`` follows after the scheme's training time.
    ``kind`` mirrors the spec's ``QuerySpec.kind`` so event consumers can
    dispatch without a registry lookup."""
    query: int
    kind: str = "classify"


@dataclasses.dataclass(frozen=True)
class TrainDone:
    """The cloud finished fine-tuning ``query``'s CQ model: per-edge weight
    shipments start on the WAN downlink (one ``ModelUpdate(kind="weights")``
    per live edge, FIFO-serialized like every other downlink transfer)."""
    query: int


@dataclasses.dataclass(frozen=True)
class QueryRetire:
    """``query`` leaves the system: its per-(query, edge) threshold rows
    drop out of the fused triage launch (freeing edge escalation capacity),
    its feedback buffers are cleared, and detections still waiting for its
    weights are answered with the pre-trained prior.  Escalations already
    in flight complete and are counted — retirement never loses answers."""
    query: int


@dataclasses.dataclass(frozen=True)
class ReleaseTick:
    """Deferred-item release barrier at a scheduler-tick boundary.

    When a query's CQ weights deliver at an edge mid-tick, the items that
    were waiting are NOT triaged immediately (that would cost an extra
    kernel launch): they join the next tick boundary.  A natural
    ``TickArrivals`` at the same boundary absorbs them first (setup-time
    events win FIFO tie-breaks), keeping the one-launch-per-tick
    invariant; this event only launches if that tick had no arrivals of
    its own."""
    tick: int = -1


#: Host event boundaries for the scan-superstep path: the events that
#: mutate state the fused tick math reads (query liveness, node liveness,
#: calibrations, thresholds' drain signals via transport/scheduler load
#: shifts).  A superstep may only fuse ticks strictly between two
#: boundaries — an event landing mid-superstep must SPLIT it, never be
#: absorbed — and the pipeline re-samples its boundary-held control
#: signals at the first tick after each one.  Pure tick/DES flow
#: (Sample, Arrive, TickArrivals, Transfer, ServiceDone) never *creates*
#: a boundary event: every boundary is either pushed at setup or by
#: another boundary's handler, so the event queue always knows the next
#: boundary time before a superstep is planned.
BOUNDARY_EVENTS = (EdgeFail, QueryArrival, TrainDone, QueryRetire,
                   ModelUpdate, FeedbackTick, ReleaseTick)


class EventQueue:
    """Min-heap of timestamped events with stable FIFO tie-breaking.

    Boundary events (``BOUNDARY_EVENTS``) are additionally tracked in a
    side heap so the superstep planner can ask for the next boundary time
    in O(1) without scanning the queue.  Because events pop in global
    time order, the side heap's minimum always equals a popping boundary
    event's time, so pops stay O(log n)."""

    def __init__(self) -> None:
        self._pq: List[Tuple[float, int, object]] = []
        self._seq = 0
        self._boundary: List[float] = []

    def push(self, t: float, event: object) -> None:
        self._seq += 1
        heapq.heappush(self._pq, (t, self._seq, event))
        if isinstance(event, BOUNDARY_EVENTS):
            heapq.heappush(self._boundary, t)

    def pop(self) -> Tuple[float, object]:
        t, _, event = heapq.heappop(self._pq)
        if isinstance(event, BOUNDARY_EVENTS):
            heapq.heappop(self._boundary)
        return t, event

    def peek_time(self) -> Optional[float]:
        """Earliest queued event time without popping (None when empty).
        The async driver sleeps its clock to this instant before popping,
        so virtual-time runs pop in exactly the DES order."""
        return self._pq[0][0] if self._pq else None

    def next_boundary(self) -> float:
        """Earliest boundary-event time still queued (+inf if none)."""
        return self._boundary[0] if self._boundary else float("inf")

    def __bool__(self) -> bool:
        return bool(self._pq)

    def __len__(self) -> int:
        return len(self._pq)
