"""The restore half of the JAX package's ``checkpoint/checkpointer.py``,
in numpy and torch: read a checkpoint directory that its ``Checkpointer``
wrote and hand back the params tree on a device.

Layout (the reference's): ``<dir>/step_<N:08d>/manifest.json`` plus one
``.npy`` per leaf, named ``<tree>.<dotted path>`` with every character
outside ``[A-Za-z0-9_.-]`` replaced by ``_``.  A JAX bfloat16 leaf is
saved by numpy as 2-byte void words (``|V2``: numpy has no bfloat16
without ``ml_dtypes``); those words are viewed as ``torch.bfloat16``.
The writer waits for training (ROADMAP A12).
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.transformer import keeps_dtype

_SAFE = re.compile(r"[^A-Za-z0-9_.-]")
# a leaf is copied to its device in slices of whole leading rows of at
# most this many bytes (one layer when a layer is larger)
_SLICE_BYTES = 1 << 28


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts -> {dotted path: leaf} (the reference's paths)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}.{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _unflatten_like(tree: Any, flat: Dict[str, Any], prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, flat, f"{prefix}.{k}" if prefix
                                   else str(k)) for k, v in tree.items()}
    return flat[prefix]


def _leaf_file(tree_name: str, path: str) -> str:
    return _SAFE.sub("_", f"{tree_name}.{path}") + ".npy"


def all_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for n in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", n)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    st = all_steps(directory)
    return st[-1] if st else None


def _is_bf16_words(dt: np.dtype) -> bool:
    if dt.kind == "V" or dt.name == "bfloat16":
        if dt.itemsize != 2:
            raise ValueError(f"unknown {dt.itemsize}-byte void leaf dtype "
                             f"{dt!r}")
        return True
    return False


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    """A copy of ``arr`` as a CPU tensor; 2-byte void words (and
    ml_dtypes' bfloat16) become bfloat16."""
    a = np.array(arr, copy=True, order="C")
    if _is_bf16_words(a.dtype):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def restore(directory: str, step: int, templates: Dict[str, Any],
            device="cuda", dtype: Optional[torch.dtype] = None
            ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Read step ``step``'s trees named by ``templates`` (trees of
    tensors, on the ``meta`` device for shapes only) onto ``device``.

    Every leaf of a template must be in the checkpoint with the
    template's shape (a missing leaf raises ``FileNotFoundError``, a
    shape ``ValueError``).  Leaves keep the checkpoint's dtype, or with
    ``dtype`` every floating leaf is cast to it as ``cast_params`` casts
    (``keeps_dtype``: the norm weights stay as they are).
    A leaf is read memory-mapped and copied to ``device`` in slices of
    whole leading rows (at most 256 MB, or one row: one layer of a
    stack), so neither the host nor the device holds more than the
    result and one slice.  Returns (trees, the manifest's ``extra``)."""
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    dev = resolve_device(device)
    out = {}
    for tname, tree in templates.items():
        loaded = {}
        for path, want in _flatten(tree).items():
            fn = os.path.join(d, _leaf_file(tname, path))
            if not os.path.exists(fn):
                raise FileNotFoundError(
                    f"checkpoint step {step} under {directory!r} has no "
                    f"leaf {tname}.{path} ({fn})")
            arr = np.load(fn, mmap_mode="r")
            if tuple(arr.shape) != tuple(want.shape):
                raise ValueError(
                    f"checkpoint leaf {tname}.{path} has shape "
                    f"{tuple(arr.shape)}; the config wants "
                    f"{tuple(want.shape)}")
            to = (torch.bfloat16 if _is_bf16_words(arr.dtype)
                  else torch.from_numpy(np.empty(0, arr.dtype)).dtype)
            if dtype is not None and to.is_floating_point \
                    and not keeps_dtype(path):
                to = dtype
            t = torch.empty(arr.shape, dtype=to, device=dev)
            if arr.ndim:
                rows = max(1, _SLICE_BYTES * arr.shape[0]
                           // max(arr.nbytes, 1))
                for i in range(0, arr.shape[0], rows):
                    t[i:i + rows].copy_(_to_tensor(arr[i:i + rows]))
            else:
                t.copy_(_to_tensor(arr))
            loaded[path] = t
        out[tname] = _unflatten_like(tree, loaded)
    return out, manifest["extra"]


def restore_params(directory: str, template: Any, device="cuda",
                   dtype: Optional[torch.dtype] = None) -> Any:
    """The ``params`` tree of the latest step under ``directory`` (the
    reference's ``LLM.load(checkpoint=...)``), checked against
    ``template``; ``FileNotFoundError`` when there is no step."""
    device = resolve_device(device)
    step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(
            f"no step_* checkpoints under {directory!r}")
    trees, _ = restore(directory, step, {"params": template}, device, dtype)
    return trees["params"]
