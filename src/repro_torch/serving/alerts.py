"""Alert/health stream over the control-plane bus.

Every operationally interesting condition the engine detects is published
on the ``Bus`` under ``alerts/<scope>/<kind>``:

  alerts/admission/quota       a tenant's token bucket ran dry
  alerts/admission/backlog     cloud fine-tune backlog shed a submission
  alerts/edge<e>/failover      edge died; its work re-dispatched
  alerts/edge<e>/shed_batch    overloaded edge shed a tick's raw batch
  alerts/edge<e>/queue_depth   sampled queue depth above the alert line
  alerts/edge<e>/threshold_drift  Eqs. 8-9 bracket drifted past the line

``AlertStream`` is the in-process consumer (the dashboard analogue): it
subscribes ``alerts/#`` and keeps (a) per-kind counts — the stable,
seed-robust aggregate ``QueryReport`` snapshots and the report gate
bands — and (b) a bounded ring of the most recent alerts with their full
topic and payload, for debugging and the demo CLI.  External consumers
subscribe the same topics on the same bus; nothing here is load-bearing
for the engine's decisions (alerts observe, never steer).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Deque, Dict


@dataclasses.dataclass(frozen=True)
class Alert:
    t: float
    topic: str
    payload: Any


class AlertStream:
    """Bus-subscribed alert aggregator (counts by kind + recent ring)."""

    def __init__(self, bus, keep: int = 256, keep_per_scope: int = 8):
        self._bus = bus
        self.counts: Dict[str, int] = {}
        self.recent: Deque[Alert] = collections.deque(maxlen=keep)
        # per-scope view ("edge3", "admission", ...): kind counts + a
        # short recent ring each, feeding health_snapshot
        self._scope_counts: Dict[str, Dict[str, int]] = {}
        self._scope_recent: Dict[str, Deque[Alert]] = {}
        self._keep_per_scope = keep_per_scope
        bus.subscribe("alerts/#", self._on_alert)

    def _on_alert(self, topic: str, payload: Any) -> None:
        # aggregate by the kind segment ("failover", "quota", ...): the
        # scope segment carries a node id, which varies with seed and
        # would make the report-gate baseline dict churn per run shape
        kind = topic.rsplit("/", 1)[-1]
        self.counts[kind] = self.counts.get(kind, 0) + 1
        t = payload.get("t", 0.0) if isinstance(payload, dict) else 0.0
        alert = Alert(float(t), topic, payload)
        self.recent.append(alert)
        parts = topic.split("/")
        scope = parts[1] if len(parts) > 1 else ""
        sc = self._scope_counts.setdefault(scope, {})
        sc[kind] = sc.get(kind, 0) + 1
        ring = self._scope_recent.get(scope)
        if ring is None:
            ring = self._scope_recent[scope] = collections.deque(
                maxlen=self._keep_per_scope)
        ring.append(alert)

    @property
    def total(self) -> int:
        return sum(self.counts.values())

    def snapshot(self) -> Dict[str, int]:
        """Per-kind counts, sorted by kind (the ``QueryReport.alerts``
        payload)."""
        return dict(sorted(self.counts.items()))

    def health_snapshot(self, edge: int) -> Dict[str, Any]:
        """One edge's operator health view (``QueryReport.edge_health``):
        per-kind alert counts for scope ``edge<edge>``, the scope's most
        recent alerts (topic, t, payload), and its total.  An edge that
        never alerted reports a clean ``{"alerts": {}, "recent": [],
        "total": 0}`` — the healthy baseline, not an error."""
        scope = f"edge{edge}"
        counts = dict(sorted(self._scope_counts.get(scope, {}).items()))
        recent = [
            {"t": round(a.t, 3), "topic": a.topic, "payload": a.payload}
            for a in self._scope_recent.get(scope, ())]
        return {"alerts": counts, "recent": recent,
                "total": sum(counts.values())}

    def close(self) -> None:
        """Detach from the bus (safe mid-delivery: publish iterates a
        snapshot of the subscription list)."""
        self._bus.unsubscribe("alerts/#", self._on_alert)
