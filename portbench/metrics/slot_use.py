"""Share of the decode batch's slots holding a request, averaged over
the window's ticks (``DecodeEngine.active`` before each tick over its
slots)."""


def read(run):
    if not run.steps:
        return None
    return 100.0 * sum(a / s for _, _, a, s in run.steps) / len(run.steps)
