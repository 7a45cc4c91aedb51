"""Runtime supervision of the port: the straggler watchdog (the rest of
the JAX package's ``runtime`` waits for training, ROADMAP A12/A13)."""
