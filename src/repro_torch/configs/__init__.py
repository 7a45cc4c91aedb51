"""Configs of the architectures the port serves (its own copy; it imports
nothing of the JAX package)."""
