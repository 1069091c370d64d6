"""Training: the optimizer, the train state, checkpoints, and the step loop."""
