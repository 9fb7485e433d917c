"""Latency estimation (paper §IV-D.3).

Two estimators, exactly as the paper uses them:

1. ``Lognormal3``: three-parameter lognormal MLE (Eqs. 10-16).  gamma (the
   physical minimum latency) is found by solving Eq. 16 iteratively
   (bisection on the monotone score function); mu/sigma^2 follow in closed
   form (Eqs. 14-15).  Long-period predictor; prediction is a weighted mean
   of E[X] = gamma + exp(mu + sigma^2/2) and Median[X] = gamma + exp(mu),
   which the paper uses to damp outlier-driven swings.

2. ``adaptive_mean``: the self-adaptive weighted mean of Eq. 17 — the
   real-time estimator whose weights automatically de-emphasize outliers:

     t = (t_old^2 + t_new^2)/(t_old+t_new)^2 * t_old
       + 2*t_old*t_new /(t_old+t_new)^2 * t_new
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np


def adaptive_mean(t_old: float, t_new: float) -> float:
    """Eq. 17: outlier-damping weighted mean (weights sum to 1)."""
    s = t_old + t_new
    if s <= 0:
        return max(t_old, t_new, 0.0)
    w_old = (t_old * t_old + t_new * t_new) / (s * s)
    w_new = 2.0 * t_old * t_new / (s * s)
    return w_old * t_old + w_new * t_new


def _score_gamma(x: np.ndarray, g: float) -> float:
    """LHS of Eq. 16 (=0 at the MLE gamma)."""
    d = x - g
    ln = np.log(d)
    n = len(x)
    s1 = np.sum(1.0 / d)
    s2 = np.sum(ln)
    s3 = np.sum(ln * ln)
    s4 = np.sum(ln / d)
    return s1 * (s2 - s3 + s2 * s2 / n) - n * s4


def fit_lognormal3(x: Sequence[float],
                   iters: int = 80) -> Tuple[float, float, float]:
    """MLE (gamma, mu, sigma^2) of the 3-parameter lognormal (Eqs. 10-16).

    Solves Eq. 16 for gamma by bisection on (eps, min(x)), then Eqs. 14-15.
    Falls back to gamma=0 (plain lognormal) if no sign change is bracketed.
    """
    xa = np.asarray(list(x), dtype=np.float64)
    if len(xa) < 3 or np.any(xa <= 0):
        raise ValueError("need >=3 positive samples")
    xmin = float(np.min(xa))
    lo, hi = 1e-12, xmin * (1.0 - 1e-9)
    flo, fhi = _score_gamma(xa, lo), _score_gamma(xa, hi)
    if flo * fhi > 0:
        gamma = 0.0
    else:
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            fm = _score_gamma(xa, mid)
            if flo * fm <= 0:
                hi, fhi = mid, fm
            else:
                lo, flo = mid, fm
        gamma = 0.5 * (lo + hi)
    ln = np.log(xa - gamma)
    mu = float(np.mean(ln))                       # Eq. 14
    sigma2 = float(np.mean((ln - mu) ** 2))       # Eq. 15
    return gamma, mu, sigma2


@dataclasses.dataclass
class LatencyEstimator:
    """Combined estimator: Eq. 17 online + lognormal refits every ``refit_every``.

    ``predict()`` = blend of the real-time adaptive mean and the lognormal
    (mean(E[X], Median[X])) long-period prediction, as in the paper.
    """
    t: float = 0.1                     # current real-time estimate (seconds)
    history_max: int = 256
    refit_every: int = 64
    blend: float = 0.5                 # weight of lognormal long-period term
    _history: list = dataclasses.field(default_factory=list)
    _since_fit: int = 0
    _lognormal: Optional[Tuple[float, float, float]] = None

    def observe(self, t_new: float) -> float:
        self.t = adaptive_mean(self.t, t_new)
        self._history.append(float(t_new))
        if len(self._history) > self.history_max:
            self._history = self._history[-self.history_max:]
        self._since_fit += 1
        if self._since_fit >= self.refit_every and len(self._history) >= 8:
            try:
                self._lognormal = fit_lognormal3(self._history)
            except (ValueError, FloatingPointError):
                self._lognormal = None
            self._since_fit = 0
        return self.t

    def predict(self) -> float:
        if self._lognormal is None:
            return self.t
        g, mu, s2 = self._lognormal
        mean = g + np.exp(mu + s2 / 2.0)
        median = g + np.exp(mu)
        longterm = 0.5 * (mean + median)   # paper: damped long-period value
        return (1 - self.blend) * self.t + self.blend * float(longterm)
