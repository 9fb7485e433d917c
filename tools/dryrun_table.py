#!/usr/bin/env python3
"""The production-shape dry-run matrix as one markdown table.

  python3 tools/dryrun_table.py DIR [--bench benchmarks/BENCH_roofline.json]

Reads the records ``python -m repro_torch.launch.dryrun`` wrote into
``DIR`` (``<arch>__<shape>__<mesh>.json``) and prints, a row per record
of the reference's matrix (``BENCH_roofline.json``'s ``models``: the ten
``ASSIGNED`` configs x four shapes on the single mesh, three on the multi
mesh): per-device peak GB and whether it fits one card; per-device FLOPs
and their ratio to the reference's analytic count over the chips (and,
for a decode, to the count over the shards that split each term,
``roofline.decode_flops_per_device``); collective MB a device by kind
(all-reduce / all-gather / reduce-scatter) beside the analytic count;
the all-gathers of a cache leaf (decodes); the port roofline's dominant
term (the reference's formulas over the H100's constants; then the same
with the measured FLOPs and collective bytes) beside the reference
record's; and the run's seconds.  A record missing from ``DIR`` is a
row that says so.  Then a line with the card's name and power limit
where ``nvidia-smi`` answers (the records' own ``card_bytes_source``
otherwise).  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mb(x: float) -> str:
    return f"{x / 1e6:.1f}"


def row(rec: dict, want: dict) -> str:
    a, c, m = rec["analytic"], rec["collectives"], rec["memory"]
    flops = rec["cost"]["flops"]
    ratio = f"{flops / a['flops_per_device']:.3f}"
    if a.get("decode_flops_per_device"):
        ratio += f" ({flops / a['decode_flops_per_device']:.4f})"
    kinds = "/".join(_mb(c[k]["bytes"]) for k in
                     ("all-reduce", "all-gather", "reduce-scatter"))
    leaf = c["all-gather"].get("cache_leaf_gathers", "")
    return (f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} | "
            f"{m['peak_bytes'] / 1e9:.2f} | {'yes' if m['fits'] else 'NO'} "
            f"| {flops:.3e} | {ratio} | {kinds} | "
            f"{_mb(a['collective_bytes_per_device'])} | {leaf} | "
            f"{a['dominant']} / {a['measured_dominant']} | "
            f"{want['dominant']} | {rec['run_s']} |")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dir")
    ap.add_argument("--bench", default=os.path.join(
        ROOT, "benchmarks", "BENCH_roofline.json"))
    args = ap.parse_args(argv)
    with open(args.bench) as f:
        matrix = json.load(f)["models"]
    print("| arch | shape | mesh | peak GB | fits | FLOPs/dev | x analytic/"
          "chips (x per-device) | AR/AG/RS MB/dev | analytic MB/dev | cache "
          "gathers | dominant: port / measured | reference | run s |")
    print("| --- " * 13 + "|")
    missing = 0
    for want in matrix:
        path = os.path.join(args.dir, f"{want['arch']}__{want['shape']}__"
                                      f"{want['mesh']}.json")
        if not os.path.exists(path):
            missing += 1
            print(f"| {want['arch']} | {want['shape']} | {want['mesh']} | "
                  f"no record |" + " |" * 9)
            continue
        with open(path) as f:
            print(row(json.load(f), want))
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        card = ""
    print(f"\n{len(matrix) - missing} of {len(matrix)} records; card: "
          f"{card or 'nvidia-smi gave no answer'}")
    return 1 if missing else 0


if __name__ == "__main__":
    sys.exit(main())
