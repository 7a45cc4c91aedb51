"""One serving step captured as a CUDA graph and replayed: the port's
counterpart of the reference runner's one jitted executable per step
(``jax.jit`` in the JAX package's ``serving/model_runner.py``).

A ``StepGraph`` belongs to one dispatch kind of the runner (the unified
step, its chained variant, the megastep's decode-plus-sample step, the
standalone prefill chunk) and owns:

* the kind's static inputs: ONE int32 word buffer, laid out like
  ``model_runner._Staging``'s pack, of which every input is a view, so a
  dispatch's uploads stay one host-to-device copy (``stage``);
* static device buffers the caller fills or reads around a replay
  (``buffers``: the chained step's feed, the megastep's token rows);
* per variant, a graph, its static output and the kernel launches its
  capture recorded.  The variant key holds every host-side choice the
  step function makes (the sampling plan, the guard, a poison row), so
  one variant is one fixed sequence of launches.

On a CUDA device the first ``run`` of a variant follows PyTorch's
documented pattern: the step runs once for real on the runner's capture
stream (this dispatch's result; it also makes every lazy allocation —
the decode kernel's scratch and arrival counters, cuBLAS's workspace,
the kernel libraries — outside any graph), then is captured with
``torch.cuda.graph(g, stream=s, pool=pool)``.  Every graph of a runner
shares one pool: they never run at once.  Later runs replay.  A failure
to capture or to replay raises; nothing runs the step eagerly instead.

On the CPU (the tests) "capture" records the step function after the
same real first run, and a replay calls it on the same static buffers:
the same bookkeeping, with the plain kernels.

Python does not run during a replay, so the kernel wrappers' launch
counters would not move: each variant keeps the counter deltas of its
capture and adds them at every replay.  A capture whose deltas differ
from its warm-up's, or a CPU replay (whose function counts for itself)
that counts otherwise than its capture, took another path than the
variant key says, and raises.
"""
from __future__ import annotations

import functools
import time
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops

# name -> (shape, numpy dtype) of one static input; dtypes of 32 bits, or
# bool (one word per value)
Fields = Dict[str, Tuple[tuple, np.dtype]]


def _words(a: np.ndarray) -> np.ndarray:
    """A host array's values as int32 words (bools as 0 / 1; 32-bit ints
    and floats bit for bit): the staged layout of every upload."""
    if a.dtype == np.bool_:
        return a.astype(np.int32).ravel()
    if a.dtype.itemsize != 4:
        raise TypeError(f"staged arrays hold 32-bit values, not {a.dtype}")
    return np.ascontiguousarray(a).view(np.int32).ravel()


def _unwords(w: torch.Tensor, dtype: np.dtype) -> torch.Tensor:
    if dtype == np.bool_:
        return w != 0
    if dtype == np.float32:
        return w.view(torch.float32)
    return w                      # int32, and uint32 keys as their bits


def copy_back(state: Dict[str, torch.Tensor],
              new: Dict[str, torch.Tensor]) -> None:
    """Write every entry of a step function's returned ``new`` state that
    is not the static tensor itself back into ``state``'s tensor, in place
    (inside the captured region, so a replay does it too).  Pools are
    updated in place and come back as the same tensors; ``seq_lens``
    comes back as a fresh tensor (``seq_lens + active``), and so does the
    recurrent state of RG-LRU and Mamba layers (``lru_h`` / ``rec_conv``,
    ``ssm_h`` / ``ssm_conv``)."""
    for k, t in new.items():
        if k in state and t is not state[k]:
            state[k].copy_(t)


class _Variant:
    __slots__ = ("graph", "fn", "out", "launches")

    def __init__(self, graph, fn, out, launches):
        self.graph, self.fn, self.out = graph, fn, out
        self.launches = launches


class StepGraph:
    """The static inputs, buffers and captured variants of one dispatch
    kind.  ``fn(key)`` is the step: it reads ``inputs()`` and
    ``buffers``, updates the runner's static state in place and returns
    its output tensor (or None).  ``captures`` counts the variants
    captured, ``replays`` the replays, ``capture_s`` the seconds spent
    capturing (warm-up included)."""

    def __init__(self, name: str, fields: Fields, device: torch.device,
                 fn: Callable[[Hashable], Optional[torch.Tensor]], *,
                 buffers: Optional[Dict[str, torch.Tensor]] = None,
                 stream: Optional["torch.cuda.Stream"] = None, pool=None,
                 counters: Sequence = ops.KERNELS):
        self.name = name
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda and stream is None:
            raise ValueError(f"{name}: a CUDA step graph needs its capture "
                             "stream")
        self.fn = fn
        self.stream, self.pool = stream, pool
        self.counters = list(counters)
        self.layout: List[Tuple[str, tuple, np.dtype, int, int]] = []
        n = 0
        for fname, (shape, dtype) in fields.items():
            dtype = np.dtype(dtype)
            if dtype != np.bool_ and dtype.itemsize != 4:
                raise TypeError(f"{name}.{fname}: static inputs hold 32-bit "
                                f"values or bools, not {dtype}")
            size = int(np.prod(shape, dtype=np.int64))
            self.layout.append((fname, tuple(shape), dtype, n, size))
            n += size
        self.words = torch.zeros(max(n, 1), dtype=torch.int32, device=device)
        self.buffers = dict(buffers or {})
        self.variants: Dict[Hashable, _Variant] = {}
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0

    # ------------------------------------------------------------ inputs
    def inputs(self) -> Dict[str, torch.Tensor]:
        """The static inputs as tensors: views of the word buffer (uint32
        values as their int32 bits), bools derived from their words.  Call
        it inside the step function, so a replay re-derives the bools."""
        return {name: _unwords(self.words[o:o + size], dtype).reshape(shape)
                for name, shape, dtype, o, size in self.layout}

    def _pack(self, arrays: Dict[str, np.ndarray]) -> List[np.ndarray]:
        """The word buffer's contents for ``arrays``: each field's values
        cast to its dtype and checked against its fixed shape; a field not
        given is zeros."""
        unknown = set(arrays) - {f[0] for f in self.layout}
        if unknown:
            raise KeyError(f"{self.name}: no static input {sorted(unknown)}")
        words = []
        for name, shape, dtype, _, size in self.layout:
            if name not in arrays:
                words.append(np.zeros(size, np.int32))
                continue
            a = np.asarray(arrays[name]).astype(dtype, copy=False)
            if a.shape != shape:
                raise ValueError(f"{self.name}.{name}: shape {a.shape}, the "
                                 f"graph's static input is {shape}")
            words.append(_words(a))
        return words

    def stage(self, staging, arrays: Dict[str, np.ndarray]) -> None:
        """One copy of the dispatch's host arrays into the static inputs
        (``_Staging.upload_into``: pinned and non-blocking on the card).
        It is enqueued behind the previous replay, which has read the
        buffer by the time it lands."""
        staging.upload_into(self.words, self._pack(arrays))

    # ------------------------------------------------------------ running
    def _counts(self) -> List[int]:
        return [k.launches for k in self.counters]

    def _restore(self, counts: List[int]) -> None:
        for k, c in zip(self.counters, counts):
            k.launches = c

    def _since(self, counts: List[int]) -> List[int]:
        return [k.launches - c for k, c in zip(self.counters, counts)]

    def _add(self, deltas: List[int]) -> None:
        for k, d in zip(self.counters, deltas):
            k.launches += d

    def run(self, key: Hashable) -> Optional[torch.Tensor]:
        """Run variant ``key`` on the staged inputs: capture it (its first
        run), else replay it.  Returns a fresh copy of the step's output,
        which no later replay overwrites (None for a step without one)."""
        v = self.variants.get(key)
        if v is None:
            out = self._capture(key)
        else:
            out = self._replay(v)
        return None if out is None else out.clone()

    def _capture(self, key: Hashable) -> Optional[torch.Tensor]:
        t0 = time.perf_counter()
        fn = functools.partial(self.fn, key)
        c0 = self._counts()
        if not self.cuda:
            out = fn()
            self.variants[key] = _Variant(None, fn, None, self._since(c0))
        else:
            cur = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(cur)
            with torch.cuda.stream(self.stream):
                out = fn()                      # the warm-up, for real
            warm = self._since(c0)
            c1 = self._counts()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                  capture_error_mode="thread_local"):
                static_out = fn()
            recorded = self._since(c1)
            self._restore(c1)                   # nothing ran yet
            cur.wait_stream(self.stream)
            if recorded != warm:
                raise RuntimeError(
                    f"{self.name} variant {key}: the capture launched "
                    f"{recorded}, its warm-up {warm}: the step took a host "
                    "branch the variant key does not hold")
            self.variants[key] = _Variant(graph, fn, static_out, recorded)
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return out

    def _replay(self, v: _Variant) -> Optional[torch.Tensor]:
        self.replays += 1
        if v.graph is not None:
            v.graph.replay()
            self._add(v.launches)
            return v.out
        c0 = self._counts()
        out = v.fn()
        ran = self._since(c0)
        if ran != v.launches:
            raise RuntimeError(f"{self.name}: a replay launched {ran}, its "
                               f"capture {v.launches}")
        return out

    def reset(self) -> None:
        """Drop every captured variant and its static output (their
        memory returns to the shared pool)."""
        for v in self.variants.values():
            if v.graph is not None:
                v.graph.reset()
        self.variants.clear()
