"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout with an NVIDIA card.  The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number the correctness check
compared, beside its limit.  The same numbers end standard error.

Exits 2, printing no result, where torch finds no CUDA card or fewer than
the cell asks for, and 3 where a module of JAX or the JAX package was
loaded once the window closed.  Kernel and compiler caches go to fixed
directories under ``build/`` in the checkout.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache = ROOT / "build" / "portbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(cache / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench import harness as H

    bench = H.load_json(ROOT / "BENCHMARK.json")
    cell, entry = H.cell(bench, args.workload)
    chips = int(entry["chips"])
    have = H.card_count()
    if not have or have < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"torch {torch.__version__} finds {have or 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    import repro_torch  # noqa: F401  (the program: absent, the run fails)
    result = H.measure(bench, cell, args.seed, args.seconds,
                       bool(args.trace), "cuda", T_START, chips=chips)
    found = H.forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: "
              f"{found}", file=sys.stderr)
        return 3
    for line in H.limits_line(result["checks"]):
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
