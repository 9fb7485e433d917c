"""Cloud->edge feedback stage: online CQ confidence recalibration.

This closes the loop the offline §IV-B training scheme leaves open at run
time: every cloud (or peer-edge) re-classification verdict is an exact
label for the edge confidence that escalated it, and throwing those labels
away freezes each edge's confidence quality for the whole run.  Instead:

  reclassify completes ──► per-(query, edge) (score, truth) ring buffer
                                      │  every update_period_s
                                      ▼
                    ONE fused ``ops.calibrate_fleet`` launch on the
                    run's device (all ready (query, edge) rows' Platt
                    fits, row-folded and bucket-padded exactly like the
                    triage kernel's query axis)
                                      │  per-row (a, b)
                                      ▼
                    WAN downlink (``Transport.wan_recv``, FIFO)
                                      │  ModelUpdate at *delivery* time
                                      ▼
                    ``TriageStage.apply_update`` — later ticks triage on
                    ``sigmoid(a * logit(conf) + b)``; in-flight ticks
                    still ran on the stale calibration (the real race)

Buffers are bounded deques (``feedback_window``): recency-windowed labels
are what lets the fit *follow* concept drift instead of averaging it away.
Rows with too few labels, or labels all one class, are skipped rather
than shipped an identity that would overwrite a learned calibration; a
retired query's buffers are cleared and its rows never fit again.
"""
from __future__ import annotations

import collections
from typing import Deque, Dict, FrozenSet, List, Set, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.serving.simulator import Item
from repro_torch.system.events import ModelUpdate
from repro_torch.system.scenario import Scenario
from repro_torch.system.transport import Transport

IDENTITY = (1.0, 0.0)
# must match kernels/calibrate.EPS: train-time and serve-time logit
# features have to agree or the fit systematically misses near 0/1
_EPS = 1e-4


def apply_calibration(conf: np.ndarray, a: float, b: float) -> np.ndarray:
    """``sigmoid(a * logit(conf) + b)`` — the Platt map the fused
    calibration kernel fits.  The identity (1, 0) returns ``conf``
    untouched (bit-exact, not just numerically close), so an uncalibrated
    run is indistinguishable from one with the loop disabled."""
    if (a, b) == IDENTITY:
        return conf
    c = np.clip(conf, _EPS, 1.0 - _EPS)
    z = a * np.log(c / (1.0 - c)) + b
    # numerically stable sigmoid: exp only ever sees non-positive z
    out = np.empty_like(z)
    pos = z >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-z[pos]))
    ez = np.exp(z[~pos])
    out[~pos] = ez / (1.0 + ez)
    return out


def calibrate_row(row: np.ndarray, n: int,
                  params: Tuple[float, float]) -> None:
    """Apply one (query, edge) row's live Platt params to its first ``n``
    lanes in place (identity is a bit-exact no-op; pad lanes stay -1.0).

    Both fused-triage pack paths — the per-tick legacy pack
    (``triage.TriageStage.triage_tick``) and the scan-superstep slab pack
    (``system.superstep``) — MUST go through this one helper: the
    superstep's bit-exactness guarantee against the per-tick driver rests
    on the calibrated f32 lanes being computed by identical code."""
    if n and params != IDENTITY:
        row[:n] = apply_calibration(row[:n], params[0], params[1])


class FeedbackStage:
    """Accumulates cloud-labeled escalations; emits fleet model updates."""

    def __init__(self, sc: Scenario, transport: Transport,
                 device: torch.device):
        self.sc = sc
        self.transport = transport
        self.device = device          # where the fused fit runs
        # the loop needs a cascade (something to recalibrate) and a period
        self.enabled = (sc.update_period_s is not None
                        and sc.scheme in ("surveiledge", "surveiledge_fixed"))
        self.buffers: Dict[Tuple[int, int],
                           Deque[Tuple[float, float, bool]]] = {
            (q, e): collections.deque(maxlen=sc.feedback_window)
            for q in sc.query_ids for e in sc.edge_ids}
        self.model_updates = 0        # fused calibrate launches (one/event)
        self.labels_seen = 0

    # --- label intake ---------------------------------------------------------
    def observe(self, t: float, item: Item) -> None:
        """One re-classification verdict at time ``t``: ground truth for
        ``item``'s raw edge confidence, banked against its query's row on
        its *home* edge (whose CQ model produced the score, wherever the
        re-classification actually ran)."""
        if not self.enabled:
            return
        self.buffers[(item.query, item.edge_device)].append(
            (t, item.conf, item.is_query))
        self.labels_seen += 1

    def add_query(self, query: int) -> None:
        """Open label buffers for a runtime-submitted query (live API) so
        its re-classification verdicts feed the fused fit like any
        declared query's."""
        for e in self.sc.edge_ids:
            self.buffers.setdefault(
                (query, e),
                collections.deque(maxlen=self.sc.feedback_window))

    def retire_query(self, query: int) -> None:
        """A retired query's labels describe a model nobody serves anymore:
        clear its buffers so its rows never re-enter the fused fit."""
        for key, buf in self.buffers.items():
            if key[0] == query:
                buf.clear()

    def _fresh(self, t: float, key: Tuple[int, int]
               ) -> List[Tuple[float, bool]]:
        """This (query, edge) row's labels young enough to describe the
        CURRENT score distribution.  Labels age out after
        ``feedback_max_age_periods`` update periods: the count-bounded
        deque alone turns over at the escalation rate, which under drift
        leaves the fit anchored to the dead regime for most of a run."""
        horizon = t - self.sc.feedback_max_age_periods * self.sc.update_period_s
        return [(s, truth) for (ts, s, truth) in self.buffers[key]
                if ts >= horizon]

    # --- one update event -----------------------------------------------------
    def tick(self, t: float, dead: set,
             retired: Union[Set[int], FrozenSet[int]] = frozenset()
             ) -> List[Tuple[float, ModelUpdate]]:
        """Fit every ready (query, edge) row in ONE fused launch and ship
        the results.

        Ready = live query on a live edge, with at least
        ``feedback_min_count`` fresh labels of both classes (a single-class
        or tiny fit would ship noise over a possibly learned calibration).
        Returns ``[(delivery_time, ModelUpdate), ...]`` — the caller pushes
        them onto the event queue so calibration lands only when the WAN
        downlink delivers it."""
        ready: List[Tuple[Tuple[int, int], List[Tuple[float, bool]]]] = []
        for key in sorted(self.buffers):
            q, e = key
            if e in dead or q in retired:
                continue
            labels = self._fresh(t, key)
            pos = sum(1 for _, truth in labels if truth)
            if len(labels) >= self.sc.feedback_min_count \
                    and 0 < pos < len(labels):
                ready.append((key, labels))
        if not ready:
            return []
        n = max(len(labels) for _, labels in ready)
        scores = np.full((len(ready), n), -1.0, np.float32)
        truths = np.zeros((len(ready), n), np.float32)
        for i, (_, labels) in enumerate(ready):
            scores[i, :len(labels)] = [s for s, _ in labels]
            truths[i, :len(labels)] = [float(truth) for _, truth in labels]
        # the ready rows are already (query, edge)-folded — the same Q·E
        # row-folding the kernel's 3D entry point performs itself
        params, _ = ops.calibrate_fleet(
            scores, truths, min_count=self.sc.feedback_min_count,
            device=self.device)
        params = params.cpu().numpy()
        self.model_updates += 1
        out = []
        for i, ((q, e), _) in enumerate(ready):
            # ship through the downlink wire path: under quantize_downlink
            # the (a, b) pair round-trips the int8 codec, so the edge
            # applies the calibration it actually received, and the link
            # is charged the real wire size instead of the fp width
            done, vals = self.transport.ship_update(
                t, self.sc.update_nbytes,
                values=np.asarray([params[i, 0], params[i, 1]], np.float32))
            out.append((done, ModelUpdate(
                e, (float(vals[0]), float(vals[1])),
                query=q, kind="calibration")))
        return out
