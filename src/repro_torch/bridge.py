"""Moving parameter trees between numpy, the CPU and the card.

``params_from_numpy`` turns the JAX package's parameter pytree, given as
numpy arrays (``jax.tree.map(np.asarray, params)``), into the port's
tensors with the same layouts — dense leaves, int4 dicts and the layer
stacks alike — so one test can feed both packages the same weights.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":            # ml_dtypes' bfloat16
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """Nested dicts / lists of numpy arrays -> the same structure of
    torch tensors on ``device`` (the card unless the caller asks for the
    CPU; raises on a host without one)."""
    return _from_numpy(tree, resolve_device(device))


def _from_numpy(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_from_numpy(v, device) for v in tree)
    return _tensor(tree).to(device)


def tree_to(tree: Any, device) -> Any:
    """The same tree with every tensor on ``device`` (tensors already
    there are kept as they are)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)
