"""Core: Eq. 7 scheduler, Eqs. 8-9 thresholds, latency estimators,
F-score, the cascade, camera profiles and K-means clustering, and the
Fig. 5 fine-tuning (the trainer and its cost model)."""
