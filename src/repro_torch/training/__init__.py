"""Training: optimizers, the train step, checkpoints."""
