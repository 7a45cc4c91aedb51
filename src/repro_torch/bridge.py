"""Moving parameter trees between numpy, the CPU and the card.

``params_from_numpy`` turns the JAX package's parameter pytree, given as
numpy arrays (``jax.tree.map(np.asarray, params)``), into the port's
tensors with the same layouts — dense leaves, int4 dicts and the layer
stacks alike — so one test can feed both packages the same weights;
``opt_state_from_numpy`` does the same for its AdamW state, and
``params_to_numpy`` / ``opt_state_to_numpy`` go back, in the reference's
stacked layout.
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


def opt_state_from_numpy(st: Any, device="cuda"):
    """The reference's ``OptState`` as numpy arrays (``jax.tree.map(
    np.asarray, opt_state)``; any (step, mu, nu) triple) -> the port's
    ``OptState`` on ``device``, its trees in the stacked layout."""
    from repro_torch.optim.adamw import OptState
    dev = resolve_device(device)
    step, mu, nu = st
    return OptState(_tensor(step).to(dev), _from_numpy(mu, dev),
                    _from_numpy(nu, dev))


def params_to_numpy(tree: Any) -> Any:
    """The port's tree -> numpy arrays in the reference's layout: a layer
    stack held as a list of per-layer dicts is stacked, and bf16 leaves
    come back as float32 (exact: numpy has no bfloat16)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        rows = [params_to_numpy(t) for t in tree]
        return _stack_np(rows)
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def _stack_np(rows):
    if isinstance(rows[0], dict):
        return {k: _stack_np([r[k] for r in rows]) for k in rows[0]}
    return np.stack(rows)


def opt_state_to_numpy(st) -> tuple:
    """The port's ``OptState`` -> (step, mu, nu) as numpy, in the
    reference's layout (``params_to_numpy``)."""
    return (st.step.cpu().numpy().copy(), params_to_numpy(st.mu),
            params_to_numpy(st.nu))
