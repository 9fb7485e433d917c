"""Prompt tokens admitted over the seconds inside ``DecodeEngine.admit``
(a batch-1 prefill and the copy into its slot; it reads the argmax
back)."""


def read(run):
    secs = sum(t1 - t0 for _, t0, t1, _ in run.admits)
    return sum(S for *_, S in run.admits) / secs if secs > 0 else None
