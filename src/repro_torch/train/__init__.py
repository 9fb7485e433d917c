"""Step factories of the serving path (the train step is not ported yet)."""
