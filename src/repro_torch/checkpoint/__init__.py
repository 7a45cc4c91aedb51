"""Reading the JAX package's checkpoints (numpy and torch only)."""
