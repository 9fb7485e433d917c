"""npz checkpoints of parameter and training-state trees."""
