"""Share of the traced slice in which the device ran nothing while the
host was inside a launch span of the program (``repro_torch.tracing.
LAUNCH``: enqueueing an edge triage, a prefill, a slot copy or a decode
tick): the idle time the host's dispatch leaves, a part of
``device_idle_share``."""
from portbench import spans
from portbench.stats import gaps_between, union_s


def read(run):
    tr = run.trace
    if tr is None or tr["window_s"] <= 0:
        return None
    w = spans.window(run)
    if w is None:
        return None
    lo, hi = tr["t0"], tr["t1"]
    launch = [(max(s.t0, lo), min(s.t1, hi)) for s in w.spans
              if s.name in w.launch and s.t1 > lo and s.t0 < hi]
    if not launch:
        return None
    idle = gaps_between(((s, s + d) for _, s, d in tr["kernels"]), lo, hi)
    # the idle time inside launch spans: |I| + |L| - |I u L|
    inside = union_s(idle) + union_s(launch) - union_s(idle + launch)
    return 100.0 * inside / tr["window_s"]
