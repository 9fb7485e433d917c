"""Per-query metrics for the end-to-end pipeline (Tables II-IV columns).

``QueryReport`` is the harness's single result object: per-item latencies and
decisions against ground truth, bandwidth split into WAN (edge->cloud upload)
and LAN (edge->edge re-dispatch), per-tick queue-length timelines, the count
of fused fleet-triage kernel launches (exactly ONE per tick-with-arrivals on
the cascade schemes, regardless of fleet size — asserted by the smoke tests),
and each edge's final adaptive (alpha, beta).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.scoring import f_score as _f_score
from repro_torch.core.scoring import f_score_counts as _f_counts

# log-spaced latency histogram for streaming percentiles: 20 buckets per
# decade over [1e-4 s, 1e4 s] (+ underflow/overflow).  The p99 read-out
# returns a bucket's upper edge clamped to the observed maximum, so its
# relative error is bounded by one bucket width (10^(1/20)-1 ~ 12%).
_LAT_LO, _LAT_HI, _LAT_BPD = 1e-4, 1e4, 20
_LAT_BUCKETS = int(round(math.log10(_LAT_HI / _LAT_LO) * _LAT_BPD))


def _lat_bucket(lat: float) -> int:
    if lat <= _LAT_LO:
        return 0
    if lat >= _LAT_HI:
        return _LAT_BUCKETS + 1
    return 1 + min(_LAT_BUCKETS - 1,
                   int(math.floor(math.log10(lat / _LAT_LO) * _LAT_BPD)))


class _Acc:
    """One streaming cell: confusion counts + Welford latency moments +
    the log-bucket latency histogram.  O(1) per item, O(1) memory."""

    __slots__ = ("n", "tp", "fp", "fn", "mean", "m2", "max_lat", "hist")

    def __init__(self) -> None:
        self.n = 0
        self.tp = self.fp = self.fn = 0
        self.mean = 0.0
        self.m2 = 0.0
        self.max_lat = 0.0
        self.hist = np.zeros(_LAT_BUCKETS + 2, np.int64)

    def add(self, lat: float, decision: bool, truth: bool) -> None:
        self.n += 1
        if decision and truth:
            self.tp += 1
        elif decision:
            self.fp += 1
        elif truth:
            self.fn += 1
        d = lat - self.mean
        self.mean += d / self.n
        self.m2 += d * (lat - self.mean)
        if lat > self.max_lat:
            self.max_lat = lat
        self.hist[_lat_bucket(lat)] += 1

    def f_score(self, lam: float = 2.0) -> float:
        return _f_counts(self.tp, self.fp, self.fn, lam)

    @property
    def var(self) -> float:
        return self.m2 / self.n if self.n else 0.0

    def percentile(self, q: float = 0.99) -> float:
        """Histogram percentile: upper edge of the rank's bucket, clamped
        to the observed max (single-sample cells are therefore exact)."""
        if not self.n:
            return 0.0
        rank = max(1, int(math.ceil(q * self.n)))
        cum = 0
        for i, c in enumerate(self.hist):
            cum += int(c)
            if cum >= rank:
                if i == 0:
                    return min(_LAT_LO, self.max_lat)
                if i > _LAT_BUCKETS:
                    return self.max_lat
                edge = _LAT_LO * 10.0 ** (i / _LAT_BPD)
                return min(edge, self.max_lat)
        return self.max_lat


class StreamingWindows:
    """Streaming windowed report aggregates: O(windows + queries) memory
    instead of O(items) arrays.

    The metropolis preset finishes ~10^6 items per run; keeping per-item
    latency/decision/truth arrays (and then binning them at report time)
    is the O(items) cost this replaces.  ``add`` folds each finished item
    into three cells at O(1): the run total, its fixed-width finish-time
    window (``accuracy_timeline``), and its query's row
    (``per_query_summary``).  Enabled by ``Scenario.metrics_window_s``;
    the exact array path stays the default everywhere else."""

    def __init__(self, window_s: float):
        if window_s <= 0:
            raise ValueError(f"window_s must be positive, got {window_s}")
        self.window_s = float(window_s)
        self.total = _Acc()
        self.windows: Dict[int, _Acc] = {}
        self.queries: Dict[int, _Acc] = {}

    @property
    def n(self) -> int:
        return self.total.n

    def add(self, t: float, lat: float, decision: bool, truth: bool,
            query: int) -> None:
        self.total.add(lat, decision, truth)
        w = int(t // self.window_s)
        cell = self.windows.get(w)
        if cell is None:
            cell = self.windows[w] = _Acc()
        cell.add(lat, decision, truth)
        qcell = self.queries.get(query)
        if qcell is None:
            qcell = self.queries[query] = _Acc()
        qcell.add(lat, decision, truth)

    def timeline(self, lam: float = 2.0) -> List[Dict[str, float]]:
        """Same row schema as ``QueryReport.accuracy_timeline`` (windows
        with zero finished items never exist in the dict, so they are
        omitted exactly like the array path omits them)."""
        return [{"t_start": round(w * self.window_s, 3), "n": c.n,
                 "f2": round(c.f_score(lam), 4)}
                for w, c in sorted(self.windows.items())]


@dataclasses.dataclass
class QueryReport:
    scenario: str
    scheme: str
    latencies: np.ndarray                  # (n_items,) seconds, finish order
    decisions: np.ndarray                  # (n_items,) bool: "is query object"
    truths: np.ndarray                     # (n_items,) bool ground truth
    finish_times: np.ndarray               # (n_items,) absolute seconds
    uploaded_bytes: int                    # shipped over the WAN uplink
    lan_bytes: int                         # shipped edge-to-edge
    escalated: int                         # items sent for re-classification
    rerouted: int                          # raw batches shed / failed-over
    kernel_launches: int                   # fused fleet-triage launches
    ticks: int                             # scheduler intervals simulated
    queue_timeline: Dict[int, np.ndarray]  # node -> (ticks,) queue length
    per_node_busy: Dict[int, float]        # node -> total service seconds
    per_node_served: Dict[int, int]        # node -> items serviced
    # edge -> final (alpha, beta): per-edge Eqs. 8-9 state at end of run
    # (empty for the non-cascade schemes)
    thresholds: Dict[int, Tuple[float, float]] = \
        dataclasses.field(default_factory=dict)
    # stage -> wall-clock seconds: frontend stages (the pixel path reports
    # render_s / framediff_s / classify_s) plus the engine's triage_s —
    # where a frames-to-answers run actually spent its compute
    stage_timings: Dict[str, float] = dataclasses.field(default_factory=dict)
    # --- runtime query lifecycle ----------------------------------------------
    # per-item query id aligned with latencies/decisions/truths (all zeros
    # for implicit single-query runs)
    query_ids: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    # query -> lifecycle facts from the pipeline (train_scheme, train_s,
    # t_arrive_s, t_retire_s, deferred, live_edges, thresholds); empty for
    # implicit single-query runs
    queries: Dict[int, Dict] = dataclasses.field(default_factory=dict)
    cloud_train_s: float = 0.0             # total Fig. 5 fine-tune seconds
    #                                        charged on the cloud node
    # --- feedback loop (cloud -> edge online recalibration) -------------------
    downloaded_bytes: int = 0              # model updates over the downlink
    #                                        (real wire size: int8-quantized
    #                                        when Scenario.quantize_downlink)
    downlink_fp_bytes: int = 0             # fp-equivalent downlink cost —
    #                                        the differential reference the
    #                                        quantized bytes are gated
    #                                        against (== downloaded_bytes on
    #                                        the fp path)
    model_updates: int = 0                 # fused calibrate launches (one
    #                                        ops.calibrate_fleet per event)
    # --- speculative escalation (Scenario.speculative_escalation) -------------
    provisional: int = 0                   # verdicts served at upload start
    reconciled: int = 0                    # cloud answers reconciled against
    #                                        a served provisional verdict
    reconciliation_flips: int = 0          # reconciliations that changed
    #                                        the answer (fed back as labels)
    provisional_latency_sum: float = 0.0   # sum of arrival->provisional-serve
    #                                        latencies (seconds)
    # simulated seconds-on-the-wire per link family (transfer time belongs
    # to transport, never to the node latency estimators)
    wan_transfer_s: float = 0.0
    lan_transfer_s: float = 0.0
    # --- scan-superstep runtime (Scenario.superstep) --------------------------
    supersteps: int = 0                    # fused multi-tick device launches
    triaged_ticks: int = 0                 # ticks that had ready work (the
    #                                        per-tick driver pays one launch
    #                                        for each of these; the superstep
    #                                        driver pays one per boundary-free
    #                                        run — their ratio is the
    #                                        host-loop reduction factor)
    # streaming aggregates (Scenario.metrics_window_s): when set, the
    # per-item arrays above are EMPTY and every metric below reads the
    # O(window) cells instead — city-of-cameras runs must not hold (or
    # sort) per-item arrays at report time
    stream: Optional[StreamingWindows] = None
    # --- serving control plane (admission / tiers / alerts) -------------------
    # alert kind -> count: the run's alerts/# bus traffic (quota, backlog,
    # failover, shed_batch, queue_depth, threshold_drift), snapshotted
    # from the AlertStream; empty when nothing alerted
    alerts: Dict[str, int] = dataclasses.field(default_factory=dict)
    submitted_queries: int = 0             # QueryArrivals seen by admission
    #                                        (0 when admission is off)
    shed_queries: int = 0                  # submissions admission refused
    shed_items: int = 0                    # stream items dropped because
    #                                        their query was shed
    # tier -> {n, mean_latency_s, p99_latency_s, slo_s, slo_breaches}:
    # per-priority-tier latency cells (tiers declared only) — the
    # priority-inversion evidence: tier 0 must hold its SLO while lower
    # tiers queue and shed
    tier_latency: Dict[int, Dict[str, float]] = \
        dataclasses.field(default_factory=dict)
    # --- cross-camera track queries (QuerySpec.kind == "track") ---------------
    # all zero (and absent from summary()) on classify-only runs, so every
    # pre-track report row keeps its exact schema
    track_items: int = 0                   # embedded detections associated
    tracks_born: int = 0                   # registry track births
    track_matches: int = 0                 # crop -> live-track associations
    id_switches: int = 0                   # ground-truth object re-observed
    #                                        on a DIFFERENT registry track
    track_opportunities: int = 0           # ground-truth re-observations
    #                                        (the ID-switch denominator)
    track_handoffs: int = 0                # associations that crossed edges
    prewarms_shipped: int = 0              # predictive hand-off downlink
    #                                        shipments (Transport.ship_update)
    prewarm_hits: int = 0                  # matches only the pre-warmed
    #                                        (not naturally warm) floor
    #                                        accepted — the hand-off's win
    track_launches: int = 0                # fused ops.associate_tracks
    #                                        launches (<= 1 per tick)
    # edge -> AlertStream.health_snapshot(edge): per-edge alert counts +
    # recent alert payloads, the operator's health view (never in summary()
    # — it is a nested dict, not a flat metric column)
    edge_health: Dict[int, Dict] = dataclasses.field(default_factory=dict)

    @property
    def n_items(self) -> int:
        """Finished items, whichever accumulation path the run used."""
        return self.stream.n if self.stream is not None \
            else len(self.latencies)

    # --- accuracy -------------------------------------------------------------
    def f_score(self, lam: float = 2.0) -> float:
        """F_lambda (paper uses F2: recall-weighted)."""
        if self.stream is not None:
            return self.stream.total.f_score(lam)
        return _f_score(self.decisions, self.truths, lam)

    @property
    def true_positives(self) -> int:
        """Correctly answered query items — the denominator of the paper's
        bandwidth-efficiency view (uplink bytes spent per useful answer)."""
        if self.stream is not None:
            return self.stream.total.tp
        return int(np.count_nonzero(self.decisions & self.truths)) \
            if len(self.decisions) else 0

    # --- latency --------------------------------------------------------------
    @property
    def avg_latency(self) -> float:
        if self.stream is not None:
            return self.stream.total.mean if self.stream.n else 0.0
        return float(np.mean(self.latencies)) if len(self.latencies) else 0.0

    @property
    def p99_latency(self) -> float:
        """p99 finish latency; on the streaming path this is the histogram
        read-out (exact for single-sample cells, otherwise within one
        log-bucket of the sorted-array percentile)."""
        if self.stream is not None:
            return self.stream.total.percentile(0.99)
        return float(np.percentile(self.latencies, 99)) \
            if len(self.latencies) else 0.0

    @property
    def latency_var(self) -> float:
        if self.stream is not None:
            return self.stream.total.var
        return float(np.var(self.latencies)) if len(self.latencies) else 0.0

    def accuracy_timeline(self, window_s: float = 10.0,
                          lam: float = 2.0) -> List[Dict[str, float]]:
        """Windowed F_lambda over finish time: ``[{t_start, n, f2}, ...]``.

        This is how concept-drift recovery becomes visible: on
        ``drifting_city`` the open-loop ablation's windows slump after
        ``drift_at_s`` and stay down, while the closed loop's climb back
        once the first post-drift ``ModelUpdate`` delivers.  Windows with
        zero finished items are omitted (a NaN row would poison JSON
        artifact consumers).

        On the streaming path the window width was fixed when the run
        started (``Scenario.metrics_window_s``); ``window_s`` here is
        ignored — re-binning would need the per-item arrays the
        streaming path exists to avoid."""
        if self.stream is not None:
            return self.stream.timeline(lam)
        if not len(self.finish_times):
            return []
        out = []
        n_win = int(np.floor(float(self.finish_times.max()) / window_s)) + 1
        idx = np.minimum((self.finish_times // window_s).astype(int),
                         n_win - 1)
        for k in range(n_win):
            m = idx == k
            if not m.any():
                continue
            out.append({"t_start": round(k * window_s, 3),
                        "n": int(m.sum()),
                        "f2": round(_f_score(self.decisions[m],
                                             self.truths[m], lam), 4)})
        return out

    def per_query_summary(self, lam: float = 2.0) -> Dict[int, Dict]:
        """One row per query: accuracy/latency over ITS items, merged with
        the lifecycle facts the pipeline recorded (Fig. 5 train_scheme and
        train_s, arrival/retire instants, items deferred while its weights
        were training/in flight).

        This is where the Fig. 5 trade becomes legible at run time: an
        ``all_finetune`` query shows the largest ``train_s`` and the worst
        head-of-query latency (its early detections waited out the
        fine-tune), a ``no_finetune`` query shows ``train_s == 0`` but the
        lowest ``f2``."""
        if self.stream is not None:
            out: Dict[int, Dict] = {}
            known = set(self.queries) | set(self.stream.queries)
            for q in sorted(int(q) for q in known):
                c = self.stream.queries.get(q)
                row = {
                    "n_items": c.n if c else 0,
                    "f2": round(c.f_score(lam), 4) if c else 0.0,
                    "avg_latency_s": round(c.mean, 3) if c else 0.0,
                    "p99_latency_s": round(c.percentile(0.99), 3)
                    if c else 0.0,
                }
                row.update(self.queries.get(q, {}))
                out[q] = row
            return out
        qids = self.query_ids if len(self.query_ids) else \
            np.zeros(len(self.latencies), np.int64)
        out: Dict[int, Dict] = {}
        known = set(self.queries) | set(np.unique(qids[:len(self.latencies)])
                                        if len(self.latencies) else [])
        for q in sorted(int(q) for q in known):
            m = qids == q
            n = int(m.sum())
            row = {
                "n_items": n,
                "f2": round(_f_score(self.decisions[m], self.truths[m],
                                     lam), 4) if n else 0.0,
                "avg_latency_s": round(float(np.mean(self.latencies[m])), 3)
                if n else 0.0,
                "p99_latency_s": round(
                    float(np.percentile(self.latencies[m], 99)), 3)
                if n else 0.0,
            }
            row.update(self.queries.get(q, {}))
            out[q] = row
        return out

    def summary(self) -> Dict[str, float]:
        """Flat row with the Tables II-IV column schema (+ harness extras)."""
        return {
            "scheme": self.scheme,
            "accuracy_F2": round(self.f_score(2.0), 4),
            "avg_latency_s": round(self.avg_latency, 3),
            "p99_latency_s": round(self.p99_latency, 3),
            "latency_var": round(self.latency_var, 3),
            "bandwidth_MB": round(self.uploaded_bytes / 1e6, 2),
            "lan_MB": round(self.lan_bytes / 1e6, 2),
            "downloaded_MB": round(self.downloaded_bytes / 1e6, 3),
            # raw bytes too: the loader's updates-without-downlink gate
            # must not be fooled by MB rounding on tiny payloads
            "downloaded_bytes": self.downloaded_bytes,
            # fp-equivalent downlink cost: the quantized-shipping reduction
            # is downlink_fp_bytes / downloaded_bytes within ONE row (and
            # the gate rejects quantized > fp as a wire-accounting bug)
            "downlink_fp_MB": round(self.downlink_fp_bytes / 1e6, 3),
            "downlink_fp_bytes": self.downlink_fp_bytes,
            "model_updates": self.model_updates,
            # bandwidth efficiency: WAN upload spent per correct positive
            # answer (the paper's 7x-less-bandwidth headline, normalized)
            "uplink_bytes_per_TP": round(
                self.uploaded_bytes / max(self.true_positives, 1), 1),
            # speculative escalation: how often the edge's provisional
            # verdict disagreed with the cloud's, and how fast the edge
            # actually answered escalated items
            "reconciliation_flip_rate": round(
                self.reconciliation_flips / self.reconciled, 4)
            if self.reconciled else 0.0,
            "provisional_latency_s": round(
                self.provisional_latency_sum / self.provisional, 3)
            if self.provisional else 0.0,
            "provisional": self.provisional,
            "reconciled": self.reconciled,
            "escalated": self.escalated,
            "rerouted": self.rerouted,
            "kernel_launches": self.kernel_launches,
            "ticks": self.ticks,
            "launches_per_tick": round(
                self.kernel_launches / max(self.ticks, 1), 3),
            # scan-superstep runtime: 0 supersteps == per-tick driver; a
            # superstep run's triaged_ticks / supersteps ratio is the
            # host-loop reduction the fused scan bought
            "supersteps": self.supersteps,
            # multi-query runtime: the launch columns above NOT scaling
            # with n_queries is the fused-(Q, E, N)-launch proof
            "n_queries": max(1, len(self.queries)
                             or (len(self.stream.queries)
                                 if self.stream is not None
                                 else (len(np.unique(self.query_ids))
                                       if len(self.query_ids) else 1))),
            "cloud_train_s": round(self.cloud_train_s, 3),
            **self._control_plane_summary(),
            **self._track_summary(),
        }

    @property
    def track_continuity(self) -> float:
        """1 - id_switches / opportunities: fraction of ground-truth
        re-observations that kept their registry identity (1.0 when no
        opportunities — an empty run has nothing to switch)."""
        if not self.track_opportunities:
            return 1.0
        return 1.0 - self.id_switches / self.track_opportunities

    def _track_summary(self) -> Dict[str, float]:
        """Track columns — only emitted when a track query actually ran,
        so classify-only rows keep their exact schema."""
        if not self.track_items:
            return {}
        return {
            "track_items": self.track_items,
            "tracks_born": self.tracks_born,
            "track_matches": self.track_matches,
            "id_switches": self.id_switches,
            "track_continuity": round(self.track_continuity, 4),
            "track_handoffs": self.track_handoffs,
            "prewarms_shipped": self.prewarms_shipped,
            "prewarm_hits": self.prewarm_hits,
            # <= 1.0 by construction: the per-tick fused-launch budget
            "track_launches_per_tick": round(
                self.track_launches / max(self.ticks, 1), 3),
        }

    def _control_plane_summary(self) -> Dict[str, float]:
        """Admission/tier/alert columns — only emitted when the control
        plane actually ran (tiers declared or submissions seen), so
        pre-control-plane rows keep their exact schema."""
        out: Dict[str, float] = {}
        if self.submitted_queries or self.alerts:
            out["alerts_total"] = sum(self.alerts.values())
        if self.submitted_queries:
            out["submitted_queries"] = self.submitted_queries
            out["shed_queries"] = self.shed_queries
            out["shed_items"] = self.shed_items
            out["shed_rate"] = round(
                self.shed_queries / self.submitted_queries, 4)
        if self.tier_latency:
            top = min(self.tier_latency)
            out["slo_breach_top_tier"] = \
                self.tier_latency[top]["slo_breaches"]
            for k, row in sorted(self.tier_latency.items()):
                out[f"p99_latency_tier{k}"] = round(
                    row["p99_latency_s"], 3)
                out[f"slo_breach_tier{k}"] = row["slo_breaches"]
        return out


def merge_timelines(samples: List[Dict[int, int]]) -> Dict[int, np.ndarray]:
    """Per-tick {node: queue_len} samples -> {node: (ticks,) array}."""
    if not samples:
        return {}
    nodes = sorted(samples[0])
    return {n: np.asarray([s[n] for s in samples], dtype=np.int64)
            for n in nodes}
