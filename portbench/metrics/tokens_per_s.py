"""Tokens generated by cloud-served requests over the whole window:
every request the window's bursts sent to the cloud, all its answer
tokens, over the seconds from the first burst's submission to the end
of the last."""


def read(run):
    tokens = sum(len(r["output"]) for r in run.requests.values()
                 if r["route"] == "cloud" and r["output"] is not None)
    return tokens / run.window_s if run.window_s > 0 else None
