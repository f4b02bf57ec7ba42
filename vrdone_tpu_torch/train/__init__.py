"""Training: optimizer and schedule, the train step, checkpoints."""
