"""Token sampling: greedy / temperature / top-k / top-p, the port's
counterpart of the JAX package's ``serving/sampler.py``.

``sample_from_logits`` (re-exported from ``repro_torch.core.sampling``)
is the per-slot core the fused decode megastep and the legacy loop use;
``sample`` is a host-facing convenience wrapper over the legacy
single-key batch sampler ``sample_device``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.sampling import sample_device, sample_from_logits

__all__ = ["sample", "sample_device", "sample_from_logits"]


def sample(logits: torch.Tensor, key, temperatures: Sequence[float],
           top_k: int = 0) -> np.ndarray:
    """Host wrapper: Python temperature list in, numpy token ids out.
    The sampling runs on the logits' device; only the ids come back."""
    t = torch.tensor(list(temperatures), dtype=torch.float32,
                     device=logits.device)
    return sample_device(logits, key, t, top_k).cpu().numpy()
