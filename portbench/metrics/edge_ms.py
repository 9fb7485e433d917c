"""Mean host time of ``CascadeServer.submit`` a request: the edge
model's forward over the prompt and the triage; it waits for the device
by reading the confidence back."""


def read(run):
    spans = [t1 - t0 for _, t0, t1 in run.submits]
    return sum(spans) / len(spans) * 1e3 if spans else None
