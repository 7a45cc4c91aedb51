"""Hand-written Hopper kernels (``csrc/*.cu``), their ctypes wrappers,
their plain torch versions (``ref.py``) and the device dispatch
(``ops.py``)."""
