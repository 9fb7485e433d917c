"""Host-side core: Eq. 7 scheduler, Eqs. 8-9 thresholds, latency
estimators, F-score, and the Fig. 5 fine-tune cost model."""
