"""The checkpoint writer: the JAX package's ``checkpoint/checkpointer.py``
in numpy and torch, writing its format, so each package reads the
other's checkpoints.

* Leaves are saved as ``.npy`` under ``step_<N:08d>.tmp/`` (one file per
  leaf, named ``<tree>.<dotted path>`` with every character outside
  ``[A-Za-z0-9_.-]`` replaced by ``_``), with a ``manifest.json`` of the
  step, each tree's sorted paths and ``extra``; the directory is then
  renamed to ``step_<N:08d>``, so a crash mid-write never corrupts the
  latest checkpoint.  ``keep`` bounds how many steps stay.
* A layer stack held as a list of per-layer dicts (the trainer's layout)
  is written as the reference's stacked leaf, one layer at a time into
  one host array; the optimizer state (a NamedTuple) as ``opt.step``,
  ``opt.mu.<path>``, ``opt.nu.<path>``.
* A bf16 leaf is written as numpy's 2-byte void words (``|V2``), as the
  reference writes one; the port's reader views them as bf16, but the
  reference's ``restore`` cannot read them back (ROADMAP C10).  f32 and
  integer checkpoints go both ways.
* ``restore`` is ``checkpoint/reader.py``'s.
* ``AsyncCheckpointer`` copies every leaf to the host when it is asked to
  save, then writes the files on a thread while the next steps run.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import reader
from repro_torch.checkpoint.reader import Rows, _flatten, _leaf_file
from repro_torch.optim.adamw import tree_map

log = logging.getLogger("repro_torch.checkpoint")


def _host(x) -> np.ndarray:
    """A leaf as a host numpy array of its own (bf16 as 2-byte void
    words): never a view of a tensor a later in-place step changes."""
    if not torch.is_tensor(x):
        return np.asarray(x)
    t = x.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _host_array(leaf) -> np.ndarray:
    """One checkpoint leaf on the host: a ``Rows`` of per-layer leaves is
    stacked into one array, a row at a time."""
    if not isinstance(leaf, Rows):
        return _host(leaf)
    first = _host(leaf[0])
    arr = np.empty((len(leaf), *first.shape), dtype=first.dtype)
    arr[0] = first
    for i in range(1, len(leaf)):
        arr[i] = _host(leaf[i])
    return arr


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save
    def save(self, step: int, trees: Dict[str, Any],
             extra: Optional[Dict[str, Any]] = None) -> str:
        t0 = time.perf_counter()
        tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
        final = os.path.join(self.dir, f"step_{step:08d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "trees": {}, "extra": extra or {}}
        nbytes = 0
        for tname, tree in trees.items():
            flat = _flatten(tree)
            manifest["trees"][tname] = sorted(flat)
            for path, leaf in flat.items():
                arr = _host_array(leaf)
                nbytes += arr.nbytes
                np.save(os.path.join(tmp, _leaf_file(tname, path)), arr)
                del arr
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        log.debug("saved step %d: %d bytes of leaves in %.3f s", step,
                  nbytes, time.perf_counter() - t0)
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        return reader.all_steps(self.dir)

    def latest_step(self) -> Optional[int]:
        return reader.latest_step(self.dir)

    def restore(self, step: int, templates: Dict[str, Any], device="cuda"
                ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """templates: trees with the target structure (tensors, ``meta``
        ones for shapes only); the leaves are read onto ``device`` (the
        card unless the caller asks for the CPU).  Returns (trees,
        the manifest's ``extra``)."""
        return reader.restore(self.dir, step, templates, device)


class AsyncCheckpointer(Checkpointer):
    """Overlaps the file writes with subsequent steps (one in flight)."""

    def __init__(self, directory: str, keep: int = 3):
        super().__init__(directory, keep)
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save_async(self, step: int, trees: Dict[str, Any],
                   extra: Optional[Dict[str, Any]] = None) -> None:
        self.wait()
        # copy to the host NOW (ordered after the steps that wrote the
        # leaves, which later in-place updates would change)
        host_trees = tree_map(_host, trees)

        def work():
            try:
                self.save(step, host_trees, extra)
            except BaseException as e:      # surfaced on next wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
