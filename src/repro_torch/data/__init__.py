"""The trainer's data: the JAX package's synthetic LM stream."""
