"""Mean host time a decode tick spends enqueueing it (the program's
``tick.launch`` span: the decode step and its argmax launched, before
the tokens are read back): the host's dispatch share of
``decode_tick_ms``."""
from portbench import spans


def read(run):
    w = spans.window(run)
    if w is None:
        return None
    ticks, launches = w.decode()
    if not ticks or not launches:
        return None
    return sum(s.t1 - s.t0 for s in launches) / len(ticks) * 1e3
