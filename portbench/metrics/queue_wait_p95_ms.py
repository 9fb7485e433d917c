"""95th percentile, over the window's cloud requests, of the wait in the
server's queue: from the end of the request's ``edge`` span (its edge
triage) to the start of its ``admit`` span (the admission that takes
it)."""
from portbench import spans
from portbench.stats import percentile


def read(run):
    w = spans.window(run)
    if w is None:
        return None
    return percentile((x * 1e3 for x in w.queue_waits()), 95)
