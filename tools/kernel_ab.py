#!/usr/bin/env python3
"""Check and time the association and superstep kernels of one source tree.

  python3 tools/kernel_ab.py [--src DIR] [--tag NAME]

Builds ``csrc/associate.cu`` and ``csrc/superstep.cu`` of the
``repro_torch`` package under ``DIR`` (default: this checkout's ``src``)
with nvcc, holds each against its plain version with ``chip_smoke.py``'s
checks (the superstep bit for bit at ``SUPERSTEP_SHAPES``, the association
at ``ASSOC_SHAPES`` and its semantic cases), times each kernel at
``ASSOC_TIMED`` and ``SUPERSTEP_TIMED`` (stream ms per call, as
``chip_smoke.device_ms``), and prints the card's name and power limit and
then one JSON line.  To compare two trees on one card, run it in one
session on each in turns (A, B, B, A).  Needs a CUDA device; imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

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
    from repro_torch.kernels import ops, runtime
    from repro_torch.kernels import similarity as SIM
    from repro_torch.kernels import superstep as SS

    built = runtime.build(("associate", "superstep"))
    for name, info in sorted(built.items()):
        print(f"-- {name} ({args.tag}): {info['path']}\n"
              f"{info['log'].strip()}", flush=True)
    dev = torch.device("cuda")
    CS.check_superstep(torch, SS, dev)
    CS.check_associate(torch, F, SIM, ops, dev)
    torch.cuda.synchronize()

    g = torch.Generator(device="cpu").manual_seed(5)
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
                      "associate": assoc, "superstep": steps}), flush=True)


if __name__ == "__main__":
    main()
