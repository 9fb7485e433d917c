"""The model FLOPs the admissions' prompts need (``portbench/flops/``,
by the model's family, active experts only) over the seconds inside
``admit``, as a share of the card's TF32 dense peak
(``portbench/roofline.py``).  Nothing where the family has no count."""
from portbench.flops import prefill_of
from portbench.roofline import TF32_FLOP_S


def read(run):
    count = prefill_of(run.model["family"])
    secs = sum(t1 - t0 for _, t0, t1, _ in run.admits)
    if count is None or secs <= 0:
        return None
    flops = sum(count(run.model, S) for *_, S in run.admits)
    return 100.0 * flops / secs / TF32_FLOP_S
