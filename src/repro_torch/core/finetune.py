"""CQ-specific fine-tuning cost model (paper §IV-B, Fig. 5).

When a new query arrives, a lightweight edge model is fine-tuned from shared
pre-trained weights on the cluster's context-specific dataset, then shipped
to the edge.  Three schemes, matching the paper's Fig. 5 comparison:

  * ``surveiledge``  — fine-tune from pre-trained weights on *cluster* data
                       (small LR, few steps; the paper's scheme: ~8x faster
                       than All-Fine-tune at nearly equal accuracy)
  * ``all_finetune`` — train per *camera* from scratch-ish (high LR, many
                       steps x num cameras; the expensive upper bound)
  * ``no_finetune``  — pre-trained weights used as-is (zero training time,
                       low accuracy on the specific query)

This module holds the analytic cost the runtime query lifecycle charges
(``system/queries.py``).  The trainer itself arrives with the cloud-side
training slice of the port.
"""
from __future__ import annotations

# Fig. 5 training-step budget: SurveilEdge fits ONE cluster model in
# `FIG5_STEPS` steps, All-Fine-tune fits one model PER CAMERA (the
# ~num_cameras-x slower upper bound), No-Fine-tune trains nothing.
FIG5_STEPS = 40
FIG5_SCHEMES = ("surveiledge", "all_finetune", "no_finetune")


def scheme_train_time(scheme: str, num_cameras: int, *,
                      step_s: float = 0.05) -> float:
    """Simulated cloud seconds to fine-tune one CQ model under ``scheme``.

    This is the Fig. 5 trade as an analytic cost the runtime query
    lifecycle charges on arrival (``system/queries.py``): ``step_s`` is
    the cloud's per-optimizer-step wall clock, and the step counts mirror
    the reference trainer's exactly.
    """
    if scheme == "no_finetune":
        return 0.0
    if scheme == "surveiledge":
        return FIG5_STEPS * step_s
    if scheme == "all_finetune":
        return FIG5_STEPS * step_s * max(int(num_cameras), 1)
    raise ValueError(
        f"unknown Fig. 5 training scheme {scheme!r} "
        f"(expected one of {FIG5_SCHEMES})")
