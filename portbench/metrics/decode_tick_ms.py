"""Mean host time of ``DecodeEngine.step`` (one decode tick of the whole
slot batch; it reads the argmax back) over the window's ticks."""


def read(run):
    spans = [t1 - t0 for t0, t1, _, _ in run.steps]
    return sum(spans) / len(spans) * 1e3 if spans else None
