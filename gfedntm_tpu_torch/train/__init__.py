"""Training steps and optimizers."""
