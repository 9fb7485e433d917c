"""Pixel-path frontend: rendered frames -> motion crops -> CQ scores -> Items.

The paper's query pipeline starts from pixels (§IV): frame differencing
(Eqs. 1-6) finds moving objects, their crops go through the fine-tuned CQ
classifier, and only the classifier's confidences enter the cascade.  This
module runs that path over the procedural camera fleet:

  1. render — every camera produces one synthetic frame triple per
     scheduler tick (``scenario.frame_schedule`` staggers captures within
     the tick), batched fleet-wide into one (C, 3, H, W, 3) array.
  2. framediff — the FUSED pixel cascade (ONE kernel launch per tick:
     framediff + dilate + erode + foreground count, see
     ``kernels/pixel_cascade.py``) and the connected-component labeller
     (``detection.pipeline.detect``) turn the tick's frames into filtered
     moving-object crops; the counts skip CCL on motionless ticks.
     ``fused=False`` runs the staged three-launch chain instead, the
     differential reference.
  3. classify — all of the tick's crops, across every camera, are scored
     by the CQ classifier in ONE bucket-padded call
     (``kernels.ops.score_crops``), so calls per tick stay O(1) in fleet
     size, like the fused triage kernel downstream.

The output is the ``Item`` stream the engine's event loop consumes, so
``run_query(sc, frontend=PixelFrontend())`` is the paper's full frames ->
triage -> allocation -> metrics loop.  Ground truth comes from the
renderer: each detection is matched to the nearest planted sprite
(unmatched detections are disturbance and count as non-query).

Every kernel and the classifier run on ``device``: ``"cuda"`` (the
default) or ``"cpu"`` for the plain PyTorch versions.  Per-stage
wall-clock (render/framediff/classify) is recorded and surfaces in
``QueryReport.stage_timings`` next to the engine's triage timing; on the
card a stage's time ends when its results are back on the host.

By default the classifier is a freshly initialised (untrained) CQ edge
model drawn from ``torch.Generator().manual_seed(seed)`` — the full
compute path with no training in the loop.  Its weights differ from the
reference's ``PixelFrontend(seed=...)`` (a JAX PRNG draw); pass
``params=bridge.cq_params_from_numpy(...)`` to score with the reference's
(or any fine-tuned) weights.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data import synthetic_video as SV
from repro_torch.detection import pipeline as DP
from repro_torch.detection.components import Box
from repro_torch.kernels import ops
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import meta as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import CQClassifier
from repro_torch.serving.simulator import Item
from repro_torch.system.frontend import Frontend
from repro_torch.system.scenario import (Scenario, frame_schedule,
                                         scenario_cameras)


def cq_config(arch: str = "surveiledge-cls") -> ModelConfig:
    """The CQ classifier's config: the arch's edge variant with a 2-class
    head and the arch's full token vocabulary (the reference's
    ``PixelFrontend`` builds the same)."""
    full = get_config(arch)
    return dataclasses.replace(full.edge_variant(), num_query_classes=2,
                               vocab_size=full.vocab_size)


def match_truth(box: Box, truth: SV.FrameTruth,
                radius: float = SV.SPRITE) -> Optional[int]:
    """Class of the planted sprite a detection box corresponds to.

    Nearest truth object whose center lies within ``radius`` of the box
    center on both axes (the renderer's sprites are SPRITE x SPRITE);
    ``None`` when the detection matches nothing — disturbance/noise."""
    cy = (box.y0 + box.y1) / 2
    cx = (box.x0 + box.x1) / 2
    best, best_d = None, float("inf")
    for cls, (y, x) in zip(truth.classes, truth.boxes):
        dy = abs(cy - (y + SV.SPRITE / 2))
        dx = abs(cx - (x + SV.SPRITE / 2))
        if dy < radius and dx < radius and dy + dx < best_d:
            best, best_d = cls, dy + dx
    return best


class PixelFrontend(Frontend):
    """Frames-to-items frontend over the procedural camera fleet.

    One instance owns one CQ classifier (config + params, on ``device``)
    and caches the last scenario's stream, so sweeping the four schemes
    over one scenario renders and scores the fleet's frames once.
    ``launches`` counts classifier calls (one per tick with crops)."""

    def __init__(self, *, arch: str = "surveiledge-cls",
                 params: Optional[M.Tree] = None, seed: int = 0,
                 query_class: int = SV.QUERY_CLASS,
                 threshold: int = 40, crop: int = 32, min_area: int = 12,
                 fused: bool = True, cache: bool = True, device="cuda"):
        super().__init__()
        if crop % 8:
            raise ValueError(f"crop side {crop} must be patch-aligned (8 px)")
        self.device = resolve_device(device)
        self.cfg = cq_config(arch)
        if params is None:
            params = M.init_params(
                self.cfg, torch.Generator().manual_seed(seed))
        self.model = CQClassifier(self.cfg, params, device=self.device)
        self.query_class = query_class
        self.threshold = threshold
        self.crop = crop
        self.min_area = min_area
        self.fused = fused           # ONE fused pixel launch vs staged three
        self.launches = 0            # classifier launches (one per tick)
        self._cache_enabled = cache
        self._cache: Optional[Tuple[tuple, List[Item], Dict[str, float]]] \
            = None

    # stream identity: every scenario field the rendered stream depends on
    # (scheme, links and topology speeds don't change what the cameras see)
    @staticmethod
    def _stream_key(sc: Scenario) -> tuple:
        return (sc.name, sc.seed, sc.num_cameras, sc.num_edges,
                sc.duration_s, sc.interval_s, sc.burst_boost, sc.burst_rate,
                sc.frame_hw, sc.track_query_ids, sc.embedding_dim)

    def stream(self, sc: Scenario) -> List[Item]:
        key = self._stream_key(sc)
        if self._cache is not None and self._cache[0] == key:
            _, items, timings = self._cache
            self._timings = dict(timings)
            return list(items)
        items, timings = self._build(sc)
        self._timings = dict(timings)
        if self._cache_enabled:
            self._cache = (key, list(items), timings)
        return items

    def _build(self, sc: Scenario) -> Tuple[List[Item], Dict[str, float]]:
        cams = scenario_cameras(sc)
        schedule = frame_schedule(sc)                        # (T, C)
        rng = np.random.default_rng(sc.seed + 31)
        t_render = t_framediff = t_classify = 0.0
        items: List[Item] = []
        for k in range(schedule.shape[0]):
            t0 = time.perf_counter()
            triples, truths = [], []
            for j, cam in enumerate(cams):
                frames, truth = SV.render_triple(cam, schedule[k, j], rng)
                triples.append(frames)
                truths.append(truth)
            batch = np.stack(triples)                # (C, 3, H, W, 3)
            t_render += time.perf_counter() - t0

            t0 = time.perf_counter()
            dets = DP.detect(batch, threshold=self.threshold, crop=self.crop,
                             min_area=self.min_area, fused=self.fused,
                             device=self.device)
            t_framediff += time.perf_counter() - t0

            flat = [(j, d) for j, per in enumerate(dets) for d in per]
            if not flat:
                continue
            t0 = time.perf_counter()
            tokens = SV.crops_to_tokens(
                np.stack([d.crop for _, d in flat]), self.cfg.vocab_size)
            conf = ops.score_crops(self.model, tokens,
                                   device=self.device).cpu().numpy()
            t_classify += time.perf_counter() - t0
            self.launches += 1

            nbytes = self.crop * self.crop * 3
            # track queries declared -> every detection carries a pixel-
            # derived re-ID embedding (appearance hash of the crop)
            embed = bool(sc.track_query_ids)
            for (j, det), cf in zip(flat, conf):
                cls = match_truth(det.box, truths[j])
                items.append(Item(
                    t_arrival=float(schedule[k, j]),
                    camera=cams[j].cam_id,
                    edge_device=cams[j].cam_id % sc.num_edges + 1,
                    conf=float(cf),
                    is_query=cls == self.query_class,
                    nbytes=nbytes,
                    emb=SV.crop_embedding(det.crop, sc.embedding_dim)
                    if embed else None))
        items.sort(key=lambda it: it.t_arrival)
        return items, {"render_s": t_render, "framediff_s": t_framediff,
                       "classify_s": t_classify}
