"""Workload construction: synthetic camera streams -> scored detection items.

Runs the *actual* offline/online SurveilEdge pipeline end to end:
  1. offline: leisure-time labels -> camera profiles -> K-means clusters
  2. online: CQ-specific fine-tuning of the edge model per cluster
  3. stream: per-camera Poisson arrivals (periodic busy profiles) scored by
     the trained edge model -> `Item` stream for the simulator.

One numpy generator, ``default_rng(seed)``, is drawn from in the
reference's order — leisure labels, exactly ``finetune_steps`` fine-tuning
batches, arrivals, then the scoring crops — so every item's arrival time,
camera, edge and ground truth equal the reference's whatever the weights.
The eval batch draws from ``default_rng(seed + 99)``.  The edge model's
init draws from ``torch.Generator().manual_seed(seed)`` (the reference
draws from a JAX PRNG key), and fine-tuning and scoring run on ``device``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core import finetune as FT
from repro_torch.core import profiles as PR
from repro_torch.data import synthetic_video as SV
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import meta as M
from repro_torch.models.meta import init_params
from repro_torch.models.transformer import CQClassifier
from repro_torch.serving.simulator import Item
from repro_torch.system.pixel_frontend import cq_config

#: detections scored per classifier call
SCORE_BATCH = 256


@dataclasses.dataclass
class Workload:
    items: List[Item]
    edge_params: object
    edge_cfg: object
    clusters: np.ndarray
    edge_accuracy: float
    # wall seconds of the build's stages: finetune_s (init to trained
    # weights, eval included), stream_s (arrivals), score_s (crops and
    # the classifier's calls, ending when the confidences are on the host)
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)
    # the fine-tune's per-step wall seconds and losses (FinetuneResult's)
    step_seconds: Tuple[float, ...] = ()
    step_losses: Tuple[float, ...] = ()


def _binary_batches(rng, cfg, cluster_profile, labels_pool, query_class,
                    batch: int = 64):
    """Infinite iterator of CQ fine-tuning batches (tokens, binary labels),
    as CPU tensors."""
    classes = np.arange(SV.NUM_CLASSES)
    neg_w = cluster_profile.copy()
    neg_w[query_class] = 0
    neg_w = np.maximum(neg_w, 1e-6)
    neg_w /= neg_w.sum()
    while True:
        is_pos = rng.random(batch) < 0.5
        cls = np.where(is_pos, query_class,
                       rng.choice(classes, size=batch, p=neg_w))
        tokens, _ = SV.labeled_crop_batch(cls, rng, cfg.vocab_size)
        yield (torch.from_numpy(tokens),
               torch.from_numpy(is_pos.astype(np.int32)))


def build_workload(*, num_cameras: int = 8, num_edges: int = 3,
                   duration_s: float = 240.0, interval_s: float = 1.0,
                   query_class: int = SV.QUERY_CLASS,
                   arch: str = "surveiledge-cls",
                   finetune_steps: int = 60,
                   seed: int = 0, device="cuda") -> Workload:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    cams = SV.make_cameras(num_cameras, seed=seed)

    # --- offline stage: profiles + clustering ------------------------------
    leisure = {c.cam_id: rng.choice(SV.NUM_CLASSES, size=400, p=c.class_mix)
               for c in cams}
    cam_ids, profs = PR.build_profiles(leisure, SV.NUM_CLASSES)
    assign, centers = PR.cluster_cameras(profs, k=2)

    # --- online stage: CQ-specific fine-tune (cluster 0's model is used for
    # all cameras of that cluster; for the workload we fine-tune one model on
    # the majority cluster's profile, as the paper does per query) -----------
    t0 = time.perf_counter()
    edge_cfg = cq_config(arch)
    maj = int(np.argmax(np.bincount(assign)))
    profile = centers[maj]
    pre = M.tree_map(lambda t: t.to(dev), init_params(
        edge_cfg, torch.Generator().manual_seed(seed)))
    ev_tokens, ev_labels = next(_binary_batches(
        np.random.default_rng(seed + 99), edge_cfg, profile, None, query_class,
        batch=256))
    res = FT.finetune(
        edge_cfg, pre,
        _binary_batches(rng, edge_cfg, profile, None, query_class),
        steps=finetune_steps, lr=1e-3, eval_set=(ev_tokens, ev_labels))
    t1 = time.perf_counter()

    # --- stream: arrivals + edge confidences --------------------------------
    pending: List[Tuple[float, int, int, int]] = []   # (t, cam, edge, cls)
    for t in np.arange(0.0, duration_s, interval_s):
        for cam in cams:
            n = rng.poisson(cam.rate_at(t) * interval_s)
            for _ in range(int(n)):
                cls = int(rng.choice(SV.NUM_CLASSES, p=cam.class_mix))
                pending.append((float(t + rng.uniform(0, interval_s)),
                                cam.cam_id, cam.cam_id % num_edges + 1, cls))
    t2 = time.perf_counter()
    # batch-score all detections with the trained edge model
    model = CQClassifier(edge_cfg, res.params, device=dev)
    all_cls = [p[3] for p in pending]
    confs = np.zeros(len(pending))
    for i in range(0, len(pending), SCORE_BATCH):
        cls_chunk = all_cls[i:i + SCORE_BATCH]
        tokens, _ = SV.labeled_crop_batch(cls_chunk, rng, edge_cfg.vocab_size)
        confs[i:i + len(cls_chunk)] = model(
            torch.from_numpy(tokens)).cpu().numpy()
    t3 = time.perf_counter()
    items = [Item(t_arrival=t, camera=cam, edge_device=edge, conf=float(cf),
                  is_query=(cls == query_class))
             for (t, cam, edge, cls), cf in zip(pending, confs)]
    items.sort(key=lambda x: x.t_arrival)
    return Workload(items=items, edge_params=res.params, edge_cfg=edge_cfg,
                    clusters=assign, edge_accuracy=res.accuracy,
                    timings={"finetune_s": t1 - t0, "stream_s": t2 - t1,
                             "score_s": t3 - t2},
                    step_seconds=res.step_seconds,
                    step_losses=res.step_losses)
