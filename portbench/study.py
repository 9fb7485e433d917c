"""Readings that set a cell's correctness limits: the program's honest
runs and the lower-precision control, seed by seed, in one process.

    python3 portbench/study.py --workload <name> --seeds 1 2 3 ... \\
        [--bursts N] [--out chiprun_out/study.jsonl]

For each seed: set-up and ``--bursts`` bursts of the cell's traffic at
its own load (its slots, cache, prompt and answer lengths), then the
check's reference over the same requests as a run reads them, once in
float32 against the program's served tokens and confidences and once
with the reference in TF32 in the program's place (the control: at each
position the token TF32 puts first, read against the float32 reference).
One JSON line a seed: the numbers the check compares, the control's, and
each sampled request's widest gap, smallest router margin and dropped
share.  Not run by the benchmark's own runs.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--bursts", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench import harness as H
    if not torch.cuda.is_available():
        print("study: no CUDA card", file=sys.stderr)
        return 2
    bench = H.load_json(ROOT / "BENCHMARK.json")
    cell, _ = H.cell(bench, args.workload)
    dev = torch.device("cuda")
    out = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            t0 = time.perf_counter()
            drv, st, w = H.window_only(cell, seed, dev, args.bursts)
            t1 = time.perf_counter()
            r = drv.check(w, st, cell, seed, dev, control="tf32",
                          detail=True)
            row = {"workload": args.workload, "seed": seed,
                   "program_s": t1 - t0,
                   "check_s": time.perf_counter() - t1,
                   "requests_served": len(w.requests),
                   "thresholds": st.th, **r}
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
