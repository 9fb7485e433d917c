"""CQ-specific fine-tuning walkthrough (paper §IV-A/B, Fig. 5).

Shows the offline + online training stages in isolation: build camera
profiles, cluster them, select a context-specific training set (negatives
proportional to the cluster profile), fine-tune the edge model for a
user-defined query, and compare with a head-only probe.  Training runs on
``--device`` (the card by default; ``cpu`` for the host):

  PYTHONPATH=src python -m repro_torch.finetune_cq --query-class 3 --device cpu

The edge model's init draws from ``torch.Generator().manual_seed(0)``
(the reference example draws from ``PRNGKey(0)``); every numpy draw is
the reference example's.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import finetune as FT
from repro_torch.core import profiles as PR
from repro_torch.data import synthetic_video as SV
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import meta as M
from repro_torch.serving.workload import _binary_batches
from repro_torch.system.pixel_frontend import cq_config


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--query-class", type=int, default=SV.QUERY_CLASS)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # --- offline: profiles + clustering -----------------------------------
    cams = SV.make_cameras(8, seed=0)
    rng = np.random.default_rng(0)
    leisure = {c.cam_id: rng.choice(SV.NUM_CLASSES, size=400, p=c.class_mix)
               for c in cams}
    cam_ids, profs = PR.build_profiles(leisure, SV.NUM_CLASSES)
    assign, centers = PR.cluster_cameras(profs, k=2)
    print("camera -> cluster:", dict(zip(cam_ids, assign.tolist())))

    # --- online: context-specific training set + fine-tune ------------------
    cfg = cq_config()
    cluster = int(np.argmax(np.bincount(assign)))
    profile = centers[cluster]

    labels_pool = rng.choice(SV.NUM_CLASSES, size=2000, p=profile / profile.sum())
    idx = PR.select_training_set(labels_pool, profile, args.query_class,
                                 n_positive=200, n_negative=400, rng=rng)
    print(f"selected {len(idx)} training samples "
          f"({(labels_pool[idx] == args.query_class).mean():.0%} positive)")

    pre = M.tree_map(lambda t: t.to(dev),
                     M.init_params(cfg, torch.Generator().manual_seed(0)))
    ev = next(_binary_batches(np.random.default_rng(9), cfg, profile, None,
                              args.query_class, batch=256))
    res = FT.finetune(cfg, pre,
                      _binary_batches(rng, cfg, profile, None,
                                      args.query_class),
                      steps=args.steps, lr=1e-3, eval_set=ev)
    print(f"fine-tuned {res.steps} steps on {dev.type} in "
          f"{res.train_seconds:.1f}s -> accuracy {res.accuracy:.3f} "
          f"(loss {res.final_loss:.3f})")

    head = FT.finetune(cfg, pre,
                       _binary_batches(np.random.default_rng(1), cfg, profile,
                                       None, args.query_class),
                       steps=args.steps, lr=1e-3, head_only=True, eval_set=ev)
    print(f"head-only probe: accuracy {head.accuracy:.3f} "
          f"in {head.train_seconds:.1f}s")


if __name__ == "__main__":
    main()
