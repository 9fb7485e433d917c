"""Step factories: the LLM train step and the serving path's closures."""
