"""Intelligent task allocator (paper Eq. 7 + §IV-D).

Every edge device runs this scheduler.  When a detection arrives it picks

    d_i = argmin_{0 <= j <= N}  Q_j * t_j                      (Eq. 7)

over all computing nodes (0 = the Cloud), using the replicated parameter
store (queue lengths Q_j, per-item latency estimates t_j, thresholds
alpha/beta).  Any parameter write triggers propagation to all nodes —
mirroring the paper's SQLite + MQTT design with an in-process bus.
"""
from __future__ import annotations

import dataclasses
from typing import Collection, Dict, List, Optional

from repro_torch.core.latency import LatencyEstimator
from repro_torch.core.thresholds import ThresholdState

CLOUD = 0      # node id 0 is the Cloud, as in the paper


@dataclasses.dataclass
class NodeInfo:
    node_id: int
    queue_len: int = 0
    up: bool = True            # False once the node is marked failed
    estimator: LatencyEstimator = dataclasses.field(
        default_factory=LatencyEstimator)

    @property
    def t(self) -> float:
        return self.estimator.predict()

    @property
    def drain_time(self) -> float:
        return self.queue_len * self.t


class Scheduler:
    """Per-edge-device scheduler over the shared parameter view."""

    def __init__(self, nodes: List[int], interval_s: float = 1.0,
                 thresholds: Optional[ThresholdState] = None):
        self.nodes: Dict[int, NodeInfo] = {n: NodeInfo(n) for n in nodes}
        self.thresholds = thresholds or ThresholdState()
        self.interval_s = interval_s

    # --- Eq. 7 ---------------------------------------------------------------
    def select_node(self, exclude_cloud: bool = False,
                    exclude: Collection[int] = (),
                    extra_cost: Optional[Dict[int, float]] = None) -> int:
        """argmin_j Q_j * t_j (+ extra_cost_j) over eligible nodes.

        The cloud participates unless ``exclude_cloud``; ``exclude`` drops
        further node ids (e.g. a detection's own edge, or a failed node —
        nodes marked down via :meth:`mark_down` are always skipped).
        ``extra_cost`` adds per-node seconds to the drain cost — the
        end-to-end harness charges the cloud its WAN-uplink backlog this
        way, since the paper folds transmission latency into t_0.  Ties
        break to the lowest node id, so with every queue empty the cloud
        (node 0) wins — matching the paper's idle-system behaviour where the
        fast cloud absorbs traffic until edge queues pay off.  Raises
        ``ValueError`` if the exclusions leave no eligible node.
        """
        best, best_cost = None, float("inf")
        for nid in sorted(self.nodes):
            n = self.nodes[nid]
            if exclude_cloud and nid == CLOUD:
                continue
            if nid in exclude or not n.up:
                continue
            cost = n.queue_len * n.t
            if extra_cost:
                cost += extra_cost.get(nid, 0.0)
            if cost < best_cost:
                best, best_cost = nid, cost
        if best is None:
            raise ValueError("no eligible node (all excluded or down)")
        return best

    # --- SLO-weighted Eq. 7 (priority tiers) ----------------------------------
    def slo_pressure(self, weight: float, slack_s: float,
                     base_extra: Optional[Dict[int, float]] = None
                     ) -> Dict[int, float]:
        """Per-node extra cost making Eq. 7 deadline-aware.

        For an item with ``slack_s`` seconds left on its tier's SLO, every
        node whose effective drain (its queue drain plus any
        ``base_extra`` — e.g. the cloud's WAN backlog) exceeds the slack
        pays ``weight * (drain - slack)`` on top of its Q_j * t_j cost: a
        node that would already miss the deadline is penalized in
        proportion to how badly, while nodes inside the slack keep the
        plain Eq. 7 argmin.  ``weight == 0`` (the tierless default)
        returns ``base_extra`` unchanged — bit-identical allocation."""
        base = base_extra or {}
        if weight <= 0.0:
            return base
        out = dict(base)
        for nid, n in self.nodes.items():
            if not n.up:
                continue
            over = n.drain_time + base.get(nid, 0.0) - slack_s
            if over > 0.0:
                out[nid] = out.get(nid, 0.0) + weight * over
        return out

    # --- node liveness --------------------------------------------------------
    def mark_down(self, node_id: int) -> None:
        """Take a node out of Eq. 7 rotation (failed-edge scenarios)."""
        self.nodes[node_id].up = False

    def mark_up(self, node_id: int) -> None:
        self.nodes[node_id].up = True

    # --- parameter-store updates (any write triggers threshold refresh) ------
    def on_enqueue(self, node_id: int) -> None:
        self.nodes[node_id].queue_len += 1
        self._refresh_thresholds(node_id)

    def on_complete(self, node_id: int, latency_s: float) -> None:
        n = self.nodes[node_id]
        n.queue_len = max(0, n.queue_len - 1)
        n.estimator.observe(latency_s)
        self._refresh_thresholds(node_id)

    def _refresh_thresholds(self, node_id: int) -> None:
        """Eqs. 8-9, driven by the updated node's drain time."""
        n = self.nodes[node_id]
        self.thresholds = self.thresholds.update(
            n.queue_len, n.t, self.interval_s)

    # --- cascade triage -------------------------------------------------------
    def triage(self, confidence: float) -> str:
        return self.thresholds.triage(confidence)

    def snapshot(self) -> Dict[str, float]:
        return {
            "alpha": self.thresholds.alpha,
            "beta": self.thresholds.beta,
            **{f"Q{n.node_id}": n.queue_len for n in self.nodes.values()},
            **{f"t{n.node_id}": n.t for n in self.nodes.values()},
        }
