"""Checkpoints in the JAX package's format (numpy and torch only): the
reader (``reader.py``) and the trainer's writer (``checkpointer.py``)."""
