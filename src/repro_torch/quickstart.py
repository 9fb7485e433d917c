"""Quickstart: the SurveilEdge cascade in five minutes.

Builds a (edge CQ-specific, cloud high-accuracy) pair from one assigned
architecture, runs the confidence-thresholded cascade over a batch of
synthetic detections, and prints the triage/bandwidth stats.  Both models
run on ``--device`` (the card by default; ``cpu`` for the host):

  PYTHONPATH=src python -m repro_torch.quickstart --arch qwen1.5-0.5b --device cpu

The weights draw from ``torch.Generator``s seeded 0 (edge) and 1 (cloud),
where the reference example uses ``PRNGKey(0/1)``; the crops are the
reference example's.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import cascade as C
from repro_torch.core.thresholds import ThresholdState
from repro_torch.data import synthetic_video as SV
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import meta
from repro_torch.models.transformer import CQClassifier


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="surveiledge-cls")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    full = get_config(args.arch)
    edge_cfg = full.edge_variant()          # 2-layer CQ-specific model
    cloud_cfg = full.reduced()              # stand-in for the big model
    print(f"arch={full.name}  edge={edge_cfg.d_model}d x {edge_cfg.num_layers}L  "
          f"cloud={cloud_cfg.d_model}d x {cloud_cfg.num_layers}L")

    edge = CQClassifier(edge_cfg, meta.init_params(
        edge_cfg, torch.Generator().manual_seed(0)), device=dev)
    cloud = CQClassifier(cloud_cfg, meta.init_params(
        cloud_cfg, torch.Generator().manual_seed(1)), device=dev)

    # synthetic detected-object crops -> patch tokens
    rng = np.random.default_rng(0)
    classes = rng.integers(0, SV.NUM_CLASSES, size=args.batch)
    tokens, _ = SV.labeled_crop_batch(classes, rng, edge_cfg.vocab_size)
    tokens = torch.from_numpy(tokens).to(dev)

    th = ThresholdState(alpha=0.8, beta=0.1)
    out = C.cascade_batch(edge(tokens), cloud, tokens, alpha=th.alpha,
                          beta=th.beta, capacity=args.batch)
    routes = out["routes"].cpu().numpy()
    n_esc = int(out["n_escalated"])
    print(f"edge accepts : {(routes == C.ACCEPT).sum()}")
    print(f"edge rejects : {(routes == C.REJECT).sum()}")
    print(f"escalated    : {n_esc} "
          f"({float(out['escalated_frac']):.1%} of the batch -> cloud)")
    print(f"bandwidth    : {n_esc * 3 * 128 * 128 / 1e6:.2f} MB "
          f"(vs {args.batch * 3 * 128 * 128 / 1e6:.2f} MB cloud-only)")


if __name__ == "__main__":
    main()
