"""End-to-end driver: serve a small model with batched requests through
the full SurveilEdge system.

Pipeline: synthetic cameras -> camera profiling + K-means clustering ->
CQ-specific fine-tuning -> scored detections -> cloud-edge cascade
serving with the intelligent task allocator (``CloudEdgeSim``) ->
metrics.  Fine-tuning and scoring run on ``--device`` (the card by
default; ``cpu`` for the host); the simulation is host numpy:

  PYTHONPATH=src python -m repro_torch.serve_cascade --duration 120 --device cpu
"""
from __future__ import annotations

import argparse

from repro_torch.kernels.runtime import resolve_device
from repro_torch.serving.simulator import CloudEdgeSim, LinkSpec, NodeSpec
from repro_torch.serving.workload import build_workload


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--duration", type=float, default=120.0)
    ap.add_argument("--cameras", type=int, default=8)
    ap.add_argument("--edges", type=int, default=3)
    ap.add_argument("--uplink-MBps", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("building workload (offline stage: profiles -> clusters -> "
          "CQ fine-tune; online stage: detection + scoring)...")
    wl = build_workload(num_cameras=args.cameras, num_edges=args.edges,
                        duration_s=args.duration, seed=args.seed, device=dev)
    print(f"  camera clusters : {wl.clusters.tolist()}")
    print(f"  edge model acc  : {wl.edge_accuracy:.3f}")
    print(f"  detections      : {len(wl.items)}")

    edges = [NodeSpec(i + 1, service_s=0.30) for i in range(args.edges)]
    cloud = NodeSpec(0, service_s=0.05)
    link = LinkSpec(uplink_MBps=args.uplink_MBps, rtt_s=0.1)

    print(f"\n{'scheme':20s}{'F2':>8s}{'avg lat':>10s}{'p99':>9s}"
          f"{'var':>9s}{'MB up':>8s}")
    for scheme in ("surveiledge", "surveiledge_fixed", "edge_only",
                   "cloud_only"):
        sim = CloudEdgeSim(edges, cloud, link, scheme=scheme, seed=1)
        r = sim.run(wl.items)
        print(f"{scheme:20s}{r.f_score():8.3f}{r.avg_latency:10.3f}"
              f"{r.p99_latency:9.2f}{r.latency_var:9.2f}"
              f"{r.uploaded_bytes / 1e6:8.2f}")
    print("\nSurveilEdge should show: near-cloud accuracy, lowest latency, "
          "bandwidth well below cloud-only.")


if __name__ == "__main__":
    main()
