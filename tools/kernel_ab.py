#!/usr/bin/env python3
"""Check and time the triage, calibrate, association and superstep
kernels of one source tree, and the card's launch floor.

  python3 tools/kernel_ab.py [--src DIR] [--tag NAME]

Builds ``csrc/{triage,calibrate,associate,superstep}.cu`` of the
``repro_torch`` package under ``DIR`` (default: this checkout's ``src``)
with nvcc, holds each against its plain version with ``chip_smoke.py``'s
checks (triage exactly at every ``TRIAGE_WIDTHS`` x ``TRIAGE_ROWS``,
calibrate within ``CAL_ATOL`` at ``CALIBRATE_WIDTHS``, the superstep bit
for bit at ``SUPERSTEP_SHAPES``, the association at ``ASSOC_SHAPES`` and
its semantic cases), times each kernel at the main paths' shapes
(``TRIAGE_TIMED``, ``CALIBRATE_TIMED``, ``ASSOC_TIMED``,
``SUPERSTEP_TIMED``; stream ms per call, as ``chip_smoke.device_ms``) and
the empty kernel of ``csrc/triage.cu`` where the tree has one (null
otherwise), and prints the card's name and power limit and then one JSON
line.  To compare two trees on one card, run it in one session on each in
turns (A, B, B, A).  Needs a CUDA device; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: (R, N): city_scale's (64, 32) and (64, 64), drifting_city's (8, 16..64),
#: and the one-row launch at its bucket
TRIAGE_TIMED = [(64, 64), (64, 32), (8, 64), (8, 32), (8, 16), (1, 16)]
#: (R, N): drifting_city's (8, 16) and (8, 64), the feedback window's
#: full width, and the block path past it
CALIBRATE_TIMED = [(8, 16), (8, 64), (8, 256), (8, 1024)]
#: (M, K, D): the track presets' padded shapes and two larger problems
ASSOC_TIMED = [(8, 8, 32), (16, 16, 32), (16, 64, 32), (32, 128, 32),
               (128, 128, 32), (1024, 128, 32)]
#: (S, R, N): metropolis's slab shapes and the cap slab at other widths
SUPERSTEP_TIMED = [(1, 16384, 8), (9, 2048, 8), (64, 8192, 8),
                   (32, 16384, 8), (32, 16384, 3), (32, 16384, 16),
                   (32, 16384, 32), (32, 8192, 64)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="this tree")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("kernel_ab: torch finds no CUDA device")
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch.nn.functional as F

    import chip_smoke as CS
    from repro_torch.kernels import calibrate as C
    from repro_torch.kernels import ops, runtime
    from repro_torch.kernels import similarity as SIM
    from repro_torch.kernels import superstep as SS
    from repro_torch.kernels import triage as T

    built = runtime.build(("triage", "calibrate", "associate", "superstep"))
    for name, info in sorted(built.items()):
        print(f"-- {name} ({args.tag}): {info['path']}\n"
              f"{info['log'].strip()}", flush=True)
    dev = torch.device("cuda")
    CS.check_triage(torch, T, ops, dev)
    CS.check_calibrate(torch, C, dev)
    CS.check_superstep(torch, SS, dev)
    CS.check_associate(torch, F, SIM, ops, dev)
    torch.cuda.synchronize()

    floor = (CS.device_ms(torch, lambda: T.empty_launch(dev), 200)
             if hasattr(T, "empty_launch") else None)
    g = torch.Generator(device="cpu").manual_seed(5)
    triage = []
    for r, n in TRIAGE_TIMED:
        conf = torch.rand((r, n), generator=g).to(dev)
        thr = torch.tensor([[0.7, 0.2]]).expand(r, 2).contiguous().to(dev)
        ms = CS.device_ms(torch, lambda: T.triage_fleet(conf, thr,
                                                        capacity=8), 200)
        triage.append({"shape": [r, n], "ms": ms,
                       "bound_ms": CS.triage_bound_ms(r, n)[0]})
    calibrate = []
    for r, n in CALIBRATE_TIMED:
        scores, truths = (t.to(dev) for t in CS.label_rows(torch, r, n, n))
        ms = CS.device_ms(torch, lambda: C.calibrate_fleet(
            scores, truths, iters=8, min_count=8), 200)
        calibrate.append({"shape": [r, n], "ms": ms,
                          "bound_ms": CS.calibrate_bound_ms(r, n, 8)[0]})
    for row in triage + calibrate:
        row["over_floor_ms"] = None if floor is None else row["ms"] - floor
    assoc = []
    for m, k, d in ASSOC_TIMED:
        ins = [t.to(dev) for t in CS.assoc_problem(torch, F, g, m, k, d)]
        assoc.append({"shape": [m, k, d],
                      "ms": CS.device_ms(torch, lambda: SIM.associate(*ins),
                                         200),
                      "bound_ms": CS.associate_bound_ms(m, k, d)[0]})
    steps = []
    for s, r, n in SUPERSTEP_TIMED:
        ins = [t.to(dev) for t in CS.superstep_slab(torch, g, s, r, n)]
        ms = CS.device_ms(torch, lambda: SS.superstep(*ins, capacity=8), 100)
        bound = CS.superstep_bound_ms(s, r, n)[0]
        steps.append({"shape": [s, r, n], "ms": ms, "bound_ms": bound,
                      "share_of_bound": bound / ms})
    print(CS.card_line())
    print(json.dumps({"tag": args.tag, "src": args.src,
                      "launch_floor_ms": floor, "triage": triage,
                      "calibrate": calibrate, "associate": assoc,
                      "superstep": steps}), flush=True)


if __name__ == "__main__":
    main()
