"""Mean host time a decode tick spends in its MoE layers' dispatch (the
program's ``moe`` spans under ``tick.launch``, summed a tick): the MoE's
share of ``tick_launch_ms``."""
from portbench import spans


def read(run):
    w = spans.window(run)
    if w is None:
        return None
    ticks, launches = w.decode()
    moe = w.under(launches, "moe")
    if not ticks or not moe:
        return None
    return sum(s.t1 - s.t0 for s in moe) / len(ticks) * 1e3
