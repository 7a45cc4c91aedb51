"""PyTorch / CUDA port of the Opt-GPTQ serving system for NVIDIA Hopper.

The module layout mirrors the JAX package ``repro`` (the reference this
port is tested against); public functions keep its names and tensor
layouts.  The port imports ``torch`` and ``numpy`` only.
"""
from __future__ import annotations


def resolve_device(device):
    """The device an entry point runs on.  CUDA is the default of every
    entry point; asking for it on a host without a usable card raises —
    nothing falls back to the CPU behind the caller's back.  torch is
    imported here, not with the package, so the static checker
    (``repro_torch.analysis``, standard library only) starts without
    it."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain reference path")
    return dev
