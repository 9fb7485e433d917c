"""The card's idle time in a traced run, put down to the program's own
spans (``repro_torch.tracing``).

    python3 portbench/idle_by_span.py --workload <name> --seed <n> \\
        --seconds <s>

From the root of a checkout with an NVIDIA card.  Runs the cell as
``run.py --trace 1`` does and prints its result line, then one more
JSON object: the traced slice's length and idle seconds, and under
``idle_by_span`` the idle seconds by the program span open innermost on
the host at the time, named by its path from its root span (``tick >
tick.launch > moe``), most first, with "outside any span" last.
"""
import time

T_START = time.perf_counter()

import collections  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
OUTSIDE = "outside any span"


def _inside(idle, intervals) -> float:
    """Seconds of the ``idle`` stretches inside the union of
    ``intervals``: |I| + |X| - |I u X|."""
    from portbench.stats import union_s
    return union_s(idle) + union_s(intervals) - union_s(
        list(idle) + list(intervals))


def table(run):
    """{"window_s", "idle_s", "idle_by_span": [[path, s], ...]} of the
    run's traced slice and the program's spans of its window; None
    without a trace or spans."""
    from portbench import spans
    from portbench.stats import gaps_between
    tr = run.trace
    w = spans.window(run)
    if tr is None or w is None:
        return None
    lo, hi = tr["t0"], tr["t1"]
    idle = gaps_between(((s, s + d) for _, s, d in tr["kernels"]), lo, hi)
    by_sid = {s.sid: s for s in w.spans}
    kids = collections.defaultdict(list)
    for s in w.spans:
        if s.parent in by_sid:
            kids[s.parent].append((s.t0, s.t1))

    def path(s):
        names = [s.name]
        while s.parent in by_sid:
            s = by_sid[s.parent]
            names.append(s.name)
        return " > ".join(reversed(names))

    # each span's own time: its stretch of the slice less its children's
    own = collections.defaultdict(list)
    for s in w.spans:
        at, end = max(s.t0, lo), min(s.t1, hi)
        if at >= end:
            continue
        for a, b in sorted(kids[s.sid]):
            if at >= end:
                break
            if a > at:
                own[path(s)].append((at, min(a, end)))
            at = max(at, b)
        if at < end:
            own[path(s)].append((at, end))
    idle_s = sum(b - a for a, b in idle)
    rows = sorted(((k, _inside(idle, v)) for k, v in own.items()),
                  key=lambda kv: -kv[1])
    rows.append((OUTSIDE, idle_s - _inside(idle, [
        (max(s.t0, lo), min(s.t1, hi)) for s in w.spans
        if s.parent not in by_sid and s.t1 > lo and s.t0 < hi])))
    return {"window_s": tr["window_s"], "idle_s": idle_s,
            "idle_by_span": [[k, v] for k, v in rows]}


def main(argv=None) -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import harness as H
    from portbench import run as R
    kept = []
    driver = H.driver

    def keeping(mix):
        def run(*a, **kw):
            kept.append(driver(mix).run(*a, **kw))
            return kept[-1]
        return types.SimpleNamespace(run=run)

    R.T_START = T_START
    H.driver = keeping
    try:
        rc = R.main(list(sys.argv[1:] if argv is None else argv)
                    + ["--trace", "1"])
    finally:
        H.driver = driver
    if rc or not kept:
        return rc or 1
    print(json.dumps(table(kept[-1].run)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
