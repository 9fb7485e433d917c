"""Event-driven cloud-edge serving simulator, and the detection record.

``Item`` is the detection record the query system (``repro_torch.system``)
consumes, copied field for field from the reference so a reference stream
rebuilds here through ``repro_torch.bridge.items_from_records``.

``CloudEdgeSim`` is the reference's legacy single-process evaluation
substrate (a copy: host numpy, no kernel), which reproduces the paper's
experimental setups (Tables II-IV) with calibrated per-node service-time
distributions.  Four schemes:

  surveiledge        task scheduling (Eq. 7) + adaptive thresholds (Eqs. 8-9)
  surveiledge_fixed  local-edge-first, constant alpha=0.8 / beta=0.1
  edge_only          CQ-specific model only, no escalation
  cloud_only         every detection uploaded + classified by the cloud model

The workload is a stream of *detections* (``serving/workload.py``) with a
precomputed edge confidence and ground-truth label per item; the cloud
classifier is treated as ground truth exactly as the paper treats
ResNet-152.  Latency = queueing + service + (for uploads) transmission;
bandwidth = bytes shipped to the cloud.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.latency import LatencyEstimator
from repro_torch.core.scheduler import CLOUD, Scheduler
from repro_torch.core.scoring import f_score as _f_score
from repro_torch.core.thresholds import ThresholdState
from repro_torch.serving.bus import Bus, FifoLink, ParamDB


@dataclasses.dataclass
class Item:
    """One detected object entering the query system."""
    t_arrival: float
    camera: int
    edge_device: int          # home edge of the camera
    conf: float               # edge-model confidence (precomputed)
    is_query: bool            # ground truth
    nbytes: int = 3 * 128 * 128  # crop payload (~49 KB, 128x128 RGB)
    query: int = 0            # which continuous query (CQ) scored this crop
    # cross-camera track queries (QuerySpec.kind == "track") only; both
    # default inert so every classify-path construction is unchanged
    emb: Optional[np.ndarray] = None   # L2-normalizable re-ID embedding
    gt_track: int = -1        # ground-truth trajectory id (-1: untracked)


@dataclasses.dataclass
class NodeSpec:
    node_id: int
    service_s: float                    # mean per-item inference time
    jitter: float = 0.15                # lognormal sigma


@dataclasses.dataclass
class LinkSpec:
    uplink_MBps: float = 2.0            # edge -> cloud
    rtt_s: float = 0.05


@dataclasses.dataclass
class SimResult:
    scheme: str
    latencies: np.ndarray               # per item (seconds)
    decisions: np.ndarray               # bool
    truths: np.ndarray                  # bool
    uploaded_bytes: int
    escalated: int
    per_node_busy: Dict[int, float]
    trace: List[Tuple[float, int, float]]      # (t, node, latency)

    # --- metrics --------------------------------------------------------------
    def f_score(self, lam: float = 2.0) -> float:
        return _f_score(self.decisions, self.truths, lam)

    @property
    def avg_latency(self) -> float:
        return float(np.mean(self.latencies)) if len(self.latencies) else 0.0

    @property
    def p99_latency(self) -> float:
        return float(np.percentile(self.latencies, 99)) if len(self.latencies) else 0.0

    @property
    def latency_var(self) -> float:
        return float(np.var(self.latencies)) if len(self.latencies) else 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "scheme": self.scheme,
            "accuracy_F2": round(self.f_score(2.0), 4),
            "avg_latency_s": round(self.avg_latency, 3),
            "p99_latency_s": round(self.p99_latency, 3),
            "latency_var": round(self.latency_var, 3),
            "bandwidth_MB": round(self.uploaded_bytes / 1e6, 2),
            "escalated": self.escalated,
        }


class CloudEdgeSim:
    """Discrete-event simulation of N edge nodes + 1 cloud node."""

    def __init__(self, edges: Sequence[NodeSpec], cloud: NodeSpec,
                 link: LinkSpec, *, scheme: str,
                 interval_s: float = 1.0, seed: int = 0,
                 fixed_thresholds: Optional[Tuple[float, float]] = None):
        assert cloud.node_id == CLOUD
        self.scheme = scheme
        self.link = link
        self.interval_s = interval_s
        self.rng = np.random.default_rng(seed)
        self.specs: Dict[int, NodeSpec] = {cloud.node_id: cloud}
        for e in edges:
            self.specs[e.node_id] = e
        self.bus = Bus()
        self.db = ParamDB(self.bus)
        self.sched = Scheduler(sorted(self.specs),
                               interval_s=interval_s,
                               thresholds=ThresholdState())
        if scheme == "surveiledge_fixed":
            # frozen at the paper's constants: alpha=0.8, beta=0.1 (or a
            # caller-supplied pair, for the threshold-ablation benchmark)
            a, b = fixed_thresholds or (0.8, 0.1)
            self.sched.thresholds = ThresholdState(
                alpha=a, beta=b, gamma1=0.0,
                gamma2=b / max(1.0 - a, 1e-6))
        # publish initial params (mirrors the SQLite bootstrap)
        for nid in self.specs:
            self.db.put(f"t{nid}", self.specs[nid].service_s)
            self.db.put(f"Q{nid}", 0)

    # --------------------------------------------------------------------------
    def _service_time(self, node: int) -> float:
        spec = self.specs[node]
        return float(spec.service_s *
                     self.rng.lognormal(0.0, spec.jitter))

    def _tx_done(self, t: float, nbytes: int) -> float:
        """Shared WAN uplink: a FIFO resource — uploads serialize.

        This is what makes cloud-only slow in the paper (Table II): the
        uplink saturates and upload queueing dominates end-to-end latency.
        """
        return self._uplink.send(t, nbytes)

    def run(self, items: Sequence[Item]) -> SimResult:
        """Discrete-event loop: arrivals are scheduled with the *current*
        queue/latency state (Eq. 7 semantics), service completions free
        their node and pull the next queued task (FIFO)."""
        scheme = self.scheme
        queues: Dict[int, List] = {nid: [] for nid in self.specs}
        node_busy: Dict[int, bool] = {nid: False for nid in self.specs}
        busy_time = {nid: 0.0 for nid in self.specs}
        lat: List[float] = []
        dec: List[bool] = []
        tru: List[bool] = []
        trace: List[Tuple[float, int, float]] = []
        self._uploaded = 0
        self._escalated = 0
        self._cloud_tx: Dict[int, float] = {}

        pq: List = []   # (time, seq, kind, payload)
        self._seq = 0
        self._uplink = FifoLink(self.link.uplink_MBps, self.link.rtt_s)

        def push(t, kind, payload):
            self._seq += 1
            heapq.heappush(pq, (t, self._seq, kind, payload))

        def start_service(t, node):
            it, phase = queues[node].pop(0)
            node_busy[node] = True
            svc = self._service_time(node)
            busy_time[node] += svc
            push(t + svc, "done", (it, node, phase, svc))

        def enqueue(t, node, it, phase):
            queues[node].append((it, phase))
            self.sched.on_enqueue(node)
            self.db.put(f"Q{node}", self.sched.nodes[node].queue_len)
            if not node_busy[node]:
                start_service(t, node)

        def finish(t, it, accept: bool, node: int):
            lat.append(t - it.t_arrival)
            dec.append(accept)
            tru.append(it.is_query)
            trace.append((it.t_arrival, node, t - it.t_arrival))

        for it in sorted(items, key=lambda x: x.t_arrival):
            push(it.t_arrival, "arrive", it)

        while pq:
            t, _, kind, payload = heapq.heappop(pq)
            if kind == "arrive":
                it = payload
                if scheme == "cloud_only":
                    self._uploaded += it.nbytes
                    push(self._tx_done(t, it.nbytes), "at_cloud", (it, t))
                elif scheme == "surveiledge":
                    node = self.sched.select_node()
                    if node == CLOUD:
                        self._uploaded += it.nbytes
                        push(self._tx_done(t, it.nbytes), "at_cloud", (it, t))
                    else:
                        enqueue(t, node, it, "edge")
                else:
                    enqueue(t, it.edge_device, it, "edge")
            elif kind == "at_cloud":
                it, t_submit = payload
                # cloud t_i estimate includes transmission (paper lumps the
                # upload into the cloud's per-item cost)
                self._cloud_tx[id(it)] = t - t_submit
                enqueue(t, CLOUD, it, "cloud")
            elif kind == "done":
                it, node, phase, svc = payload
                node_busy[node] = False
                obs = svc + self._cloud_tx.pop(id(it), 0.0) \
                    if phase == "cloud" else svc
                self.sched.on_complete(node, obs)
                self.db.put(f"t{node}", self.sched.nodes[node].estimator.t)
                self.db.put(f"Q{node}", self.sched.nodes[node].queue_len)
                if phase == "cloud":
                    # ground-truth classifier (paper: ResNet-152 == truth)
                    finish(t, it, it.is_query, node)
                elif scheme == "edge_only":
                    finish(t, it, it.conf > 0.5, node)
                else:
                    route = self.sched.thresholds.triage(it.conf)
                    if route == "escalate":
                        self._escalated += 1
                        self._uploaded += it.nbytes
                        push(self._tx_done(t, it.nbytes), "at_cloud", (it, t))
                    else:
                        finish(t, it, route == "accept", node)
                if queues[node]:
                    start_service(t, node)

        return SimResult(
            scheme=scheme,
            latencies=np.asarray(lat),
            decisions=np.asarray(dec, bool),
            truths=np.asarray(tru, bool),
            uploaded_bytes=self._uploaded,
            escalated=self._escalated,
            per_node_busy=busy_time,
            trace=trace,
        )
