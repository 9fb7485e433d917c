"""Fleet-wide track registry for cross-camera track queries.

``TrackStage`` owns track birth / update / retire, keyed ``(query,
track_id)``.  Once per scheduler tick the orchestrator hands it every
live track query's embedded detections (grouped per (query, edge)); the
stage matches ALL of them against the fleet-wide live track table in ONE
fused ``ops.associate_tracks`` launch on the run's device — the same
per-tick launch budget discipline as triage — then applies the
associations:

* matched crop -> the track follows the crop (EMA embedding update,
  last-seen camera/edge advance).  A match whose edge differs from the
  track's previous edge is a *hand-off*: the association crossed edges,
  which is the thing a per-edge tracker cannot do.
* unmatched crop -> a new track is born.
* tracks unseen for ``Scenario.track_ttl_s`` retire; a ``QueryRetire``
  drops the query's whole table.

Warm vs cold edges drive the per-crop acceptance floor
(``Scenario.track_thresholds = (warm, cold)``): an edge is warm for a
query when one of the query's live tracks was last seen there, or when a
predictive pre-warm delivered and is inside ``prewarm_ttl_s``.  A cold
edge accepts only near-perfect (same-camera) continuations; a warm edge
accepts cross-camera appearance shifts.  That gap is the predictive
hand-off's value: when a track crosses into a new camera, the stage
extrapolates its direction one camera further and ships a pre-warm for
the *next* edge over the WAN downlink (``Transport.ship_update`` — the
same FIFO + stale-in-flight delivery semantics as every model artifact:
the pre-warm only helps if it DELIVERS before the target arrives), so by
the time the target crosses again the receiving edge is already warm.

ID-switch accounting rides the synthetic trajectory ground truth
(``Item.gt_track``): every re-observation of a ground-truth object is an
opportunity; landing on a different registry track than last time is an
ID switch.  ``track_continuity = 1 - switches / opportunities``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.system.events import ModelUpdate


@dataclasses.dataclass
class _Track:
    emb: np.ndarray               # L2-normalized running appearance
    last_seen: float
    last_camera: int
    last_edge: int
    prewarm_edge: int = -1        # last edge this track pre-warmed (dedupe)
    hits: int = 1


#: EMA weight of the incoming crop embedding on a match (re-normalized)
_EMA = 0.30


class TrackStage:
    """One per pipeline run (created only when track queries exist)."""

    def __init__(self, sc, transport, device: torch.device):
        self.sc = sc
        self.transport = transport
        self.device = device          # where the fused association runs
        self.tracks: Dict[Tuple[int, int], _Track] = {}
        self._next_id: Dict[int, int] = {}
        self._warm_until: Dict[Tuple[int, int], float] = {}
        self._gt_last: Dict[Tuple[int, int], int] = {}
        self.launches = 0
        self.items = 0
        self.matches = 0
        self.tracks_born = 0
        self.id_switches = 0
        self.opportunities = 0
        self.handoffs = 0
        self.prewarms = 0
        self.prewarm_hits = 0
        self.elapsed_s = 0.0

    # --- warmth ---------------------------------------------------------------
    def _warm_parts(self, query: int, edge: int, t: float) -> Tuple[bool, bool]:
        """(naturally warm: a live track is here, pre-warmed: delivery live)."""
        nat = any(tr.last_edge == edge
                  for (q, _), tr in self.tracks.items() if q == query)
        pre = self._warm_until.get((query, edge), -np.inf) >= t
        return nat, pre

    def apply_prewarm(self, t: float, query: int, edge: int) -> None:
        """A ``ModelUpdate(kind="prewarm")`` delivered: the edge holds the
        query's thresholds/CQ weights hot for ``prewarm_ttl_s``."""
        key = (query, edge)
        until = t + self.sc.prewarm_ttl_s
        if until > self._warm_until.get(key, -np.inf):
            self._warm_until[key] = until

    def retire_query(self, query: int) -> None:
        for key in [k for k in self.tracks if k[0] == query]:
            del self.tracks[key]
        for key in [k for k in self._warm_until if k[0] == query]:
            del self._warm_until[key]

    # --- the per-tick association --------------------------------------------
    def tick(self, t: float, batches: Dict[Tuple[int, int], list]
             ) -> List[Tuple[float, ModelUpdate]]:
        """Associate one tick's embedded detections; returns the pre-warm
        shipments as ``(delivery_t, ModelUpdate)`` pairs for the caller to
        push onto the event queue.

        ``batches`` maps (query, edge) -> items; iteration is sorted by
        key (items keep stream order within a batch), so association —
        and therefore every hand-off decision — is deterministic across
        reruns and drivers."""
        t0 = time.perf_counter()
        # TTL retirement first: a track the fleet lost track_ttl_s ago must
        # not claim this tick's crops
        ttl = self.sc.track_ttl_s
        dead = [k for k, tr in self.tracks.items() if tr.last_seen < t - ttl]
        for k in dead:
            del self.tracks[k]
        crops = []
        for key in sorted(batches):
            q, e = key
            for it in batches[key]:
                if it.emb is not None:
                    crops.append((it, q, e))
        if not crops:
            self.elapsed_s += time.perf_counter() - t0
            return []
        self.items += len(crops)
        warm_t, cold_t = self.sc.track_thresholds
        # warmth is sampled BEFORE this tick's updates, per (query, edge)
        warm_nat: Dict[Tuple[int, int], bool] = {}
        warm_pre: Dict[Tuple[int, int], bool] = {}
        for _, q, e in crops:
            if (q, e) not in warm_nat:
                warm_nat[(q, e)], warm_pre[(q, e)] = self._warm_parts(q, e, t)
        keys = sorted(self.tracks)
        D = self.sc.embedding_dim
        emb = np.stack([c[0].emb for c in crops]).astype(np.float32)
        emb /= np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
        crop_q = np.asarray([q for _, q, _ in crops], np.int32)
        thr = np.asarray(
            [warm_t if (warm_nat[(q, e)] or warm_pre[(q, e)]) else cold_t
             for _, q, e in crops], np.float32)
        if keys:
            trk = np.stack([self.tracks[k].emb for k in keys])
            trk_q = np.asarray([k[0] for k in keys], np.int32)
            assign, sim = ops.associate_tracks(emb, trk, crop_q, trk_q, thr,
                                               device=self.device)
            assign = assign.cpu().numpy()
            sim = sim.cpu().numpy()
            self.launches += 1
        else:
            # empty table: nothing to launch against — every crop births
            assign = np.full(len(crops), -1, np.int32)
            sim = np.full(len(crops), -1e30, np.float32)
        out: List[Tuple[float, ModelUpdate]] = []
        C = self.sc.num_cameras
        E = self.sc.num_edges
        for i, (it, q, e) in enumerate(crops):
            j = int(assign[i])
            if j >= 0:
                key = keys[j]
                tr = self.tracks[key]
                self.matches += 1
                # a pre-warm "hit": the match needed the warm floor (cold
                # would have rejected it) and ONLY the pre-warm provided it
                if (warm_pre[(q, e)] and not warm_nat[(q, e)]
                        and float(sim[i]) < cold_t):
                    self.prewarm_hits += 1
                if e != tr.last_edge:
                    self.handoffs += 1
                prev_cam = tr.last_camera
                tr.emb = (1.0 - _EMA) * tr.emb + _EMA * emb[i]
                tr.emb /= max(float(np.linalg.norm(tr.emb)), 1e-12)
                tr.last_seen = t
                tr.last_edge = e
                tr.last_camera = it.camera
                tr.hits += 1
                if it.camera != prev_cam:
                    self._predict_handoff(t, q, tr, prev_cam, it.camera,
                                          e, C, E, out)
            else:
                tid = self._next_id.get(q, 0)
                self._next_id[q] = tid + 1
                key = (q, tid)
                self.tracks[key] = _Track(
                    emb=emb[i].copy(), last_seen=t,
                    last_camera=it.camera, last_edge=e)
                self.tracks_born += 1
            if it.gt_track >= 0:
                gk = (q, it.gt_track)
                prev_tid = self._gt_last.get(gk)
                if prev_tid is not None:
                    self.opportunities += 1
                    if prev_tid != key[1]:
                        self.id_switches += 1
                self._gt_last[gk] = key[1]
        self.elapsed_s += time.perf_counter() - t0
        return out

    def _predict_handoff(self, t: float, query: int, tr: _Track,
                         prev_cam: int, cam: int, edge: int,
                         C: int, E: int,
                         out: List[Tuple[float, ModelUpdate]]) -> None:
        """The track just crossed prev_cam -> cam: extrapolate one camera
        further along the chain (wrap-aware) and pre-warm its edge."""
        if not self.sc.predictive_handoff or prev_cam < 0:
            return
        d = cam - prev_cam
        if d > C / 2:
            d -= C
        elif d < -C / 2:
            d += C
        if d == 0:
            return
        next_cam = (cam + (1 if d > 0 else -1)) % C
        next_edge = next_cam % E + 1
        # skip same-edge predictions and duplicate ships for one crossing
        if next_edge == edge or tr.prewarm_edge == next_edge:
            return
        tr.prewarm_edge = next_edge
        done, _ = self.transport.ship_update(t, self.sc.prewarm_nbytes)
        out.append((done, ModelUpdate(next_edge, None, query=query,
                                      kind="prewarm")))
        self.prewarms += 1

    # --- report ---------------------------------------------------------------
    @property
    def continuity(self) -> float:
        if self.opportunities == 0:
            return 1.0
        return 1.0 - self.id_switches / self.opportunities
