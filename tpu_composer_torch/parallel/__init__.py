"""Training on one card: the train step, checkpoints and the collective
probe (the multi-device half waits for its slice)."""
