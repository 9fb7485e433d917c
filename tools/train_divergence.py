#!/usr/bin/env python3
"""How far two builds of the trained workload drift apart, and what a
fine-tune step's batch draw costs on the host.

  PYTHONPATH=src python3 tools/train_divergence.py [--steps 80] [--cuda]

Builds ``serving.workload.build_workload`` at
``benchmarks/common.py::shared_workload``'s settings (8 cameras, 3 edges,
240 s, seed 0; ``--steps`` AdamW steps) on the host with torch's default
thread count, again with one thread, and with ``--cuda`` on the card.
Every build starts from the same init and draws the same batches, so
they differ only in the order their f32 sums run.  Prints one JSON line:
each build's per-step loss gap to the first build, the first step whose
gap exceeds 1e-3, the items' largest ``conf`` gap, whether the integer
fields are identical, and the mean wall ms of drawing one 64-crop
fine-tuning batch (``_binary_batches``) on this host.  With ``--cuda`` it
also prints the card's name and power limit first.  Imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: ``benchmarks/common.py::shared_workload``'s build, without the steps
WORKLOAD = dict(num_cameras=8, num_edges=3, duration_s=240.0, seed=0)
#: batches drawn to time one draw
DRAWS = 20


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--cuda", action="store_true",
                    help="also build on the card (needs a CUDA device)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    from repro_torch.serving.workload import _binary_batches, build_workload
    from repro_torch.system.pixel_frontend import cq_config

    if args.cuda:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    threads = torch.get_num_threads()
    builds = {}
    builds[f"cpu_{threads}_threads"] = build_workload(
        **WORKLOAD, finetune_steps=args.steps, device="cpu")
    torch.set_num_threads(1)
    builds["cpu_1_thread"] = build_workload(
        **WORKLOAD, finetune_steps=args.steps, device="cpu")
    torch.set_num_threads(threads)
    if args.cuda:
        builds["cuda"] = build_workload(**WORKLOAD, finetune_steps=args.steps,
                                        device="cuda")
    (base_name, base), *rest = builds.items()

    def fields(wl):
        return [(i.t_arrival, i.camera, i.edge_device, i.is_query)
                for i in wl.items]

    out = {"steps": args.steps, "items": len(base.items), "base": base_name,
           "builds": {}}
    for name, wl in rest:
        gap = [abs(a - b) for a, b in zip(wl.step_losses, base.step_losses)]
        out["builds"][name] = {
            "loss_gap": gap,
            "first_step_over_1e-3": next(
                (i + 1 for i, g in enumerate(gap) if g > 1e-3), None),
            "max_loss_gap_steps_1_20": max(gap[:20]),
            "max_abs_dconf": max(abs(a.conf - b.conf)
                                 for a, b in zip(wl.items, base.items)),
            "integer_fields_identical": fields(wl) == fields(base),
            "accuracy": wl.edge_accuracy}
    it = _binary_batches(np.random.default_rng(0), cq_config(),
                         np.full(12, 1 / 12), None, 3)
    t0 = time.perf_counter()
    for _ in range(DRAWS):
        next(it)
    out["batch_draw_ms"] = 1e3 * (time.perf_counter() - t0) / DRAWS
    out["base_accuracy"] = base.edge_accuracy
    print(json.dumps(out))


if __name__ == "__main__":
    main()
