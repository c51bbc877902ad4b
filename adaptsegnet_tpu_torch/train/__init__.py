"""Training: config, state, optimizers, steps and the loop."""
