"""95th percentile, over every request of the window (those the edge
settled too), of the time from its burst's submission to its whole
answer: SurveilEdge's query response time.  A request never answered
counts as taking the whole window."""
from portbench.stats import percentile


def read(run):
    return percentile(
        ((r["t_done"] - r["t_submit"]) * 1e3 if r["t_done"] is not None
         else run.window_s * 1e3 for r in run.requests.values()), 95)
