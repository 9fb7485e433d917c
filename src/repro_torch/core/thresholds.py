"""Dynamic confidence-threshold adaptation (paper Eqs. 8-9).

The cascade uploads an image to the cloud when its edge confidence f falls in
[beta, alpha].  SurveilEdge adapts the interval width to system load:

  alpha_new = max(min(alpha_old - gamma1 * (l_d * t_d - s), 1), 0.5)     (8)
  beta_new  = gamma2 * (1 - alpha_new)                                   (9)

where l_d*t_d is the expected drain time of the chosen queue (queue length x
per-item latency) and s is the query sampling interval.  When the system is
overloaded (drain > s) the bracket shrinks -> fewer cloud uploads; when idle
it widens -> more reclassification -> higher accuracy.  alpha is clamped to
[0.5, 1] and beta < 0.5 by construction (gamma2 in (0,1)).

``ThresholdState`` is one edge's adaptation state.  The paper runs Eqs. 8-9
on every edge device, so the end-to-end engine keeps one instance per edge
(``repro_torch.system.triage.TriageStage``) and feeds the resulting (E, 2) matrix
to the fused fleet-triage kernel as runtime data.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class ThresholdState:
    alpha: float = 0.8
    beta: float = 0.1
    gamma1: float = 0.2
    gamma2: float = 0.25
    # Optional asymmetric widening gain: when the system is idle (drain < s)
    # alpha rises with this gain instead of gamma1.  None keeps the paper's
    # symmetric Eq. 8.  The end-to-end harness sets a small value ("shed load
    # fast, spend idle capacity slowly") so a periodically-idle system does
    # not slam the bracket open and saturate the uplink with escalations.
    gamma1_up: Optional[float] = None

    def update(self, queue_len: float, item_latency: float,
               interval_s: float) -> "ThresholdState":
        """Eq. 8/9 update given the selected queue's drain time."""
        drain = queue_len * item_latency
        gain = self.gamma1 if (drain >= interval_s or self.gamma1_up is None) \
            else self.gamma1_up
        alpha = self.alpha - gain * (drain - interval_s)
        alpha = max(min(alpha, 1.0), 0.5)
        beta = self.gamma2 * (1.0 - alpha)
        return dataclasses.replace(self, alpha=alpha, beta=beta)

    def triage(self, confidence: float):
        """-> 'accept' | 'reject' | 'escalate' for one confidence value."""
        if confidence > self.alpha:
            return "accept"
        if confidence < self.beta:
            return "reject"
        return "escalate"
