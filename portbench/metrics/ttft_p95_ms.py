"""95th percentile, over every cloud-served request of the window, of
the time from its burst's submission to its first token (the end of its
admission, which reads the token back)."""
from portbench.stats import percentile


def read(run):
    return percentile(
        ((r["t_first"] - r["t_submit"]) * 1e3 for r in run.requests.values()
         if r["route"] == "cloud" and r["t_first"] is not None), 95)
