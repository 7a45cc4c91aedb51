"""The trainer's optimizer (AdamW, the JAX package's ``optim``)."""
