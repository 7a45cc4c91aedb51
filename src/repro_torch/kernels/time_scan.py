"""Wrappers of the hand-written Hopper time-scan kernels
(``csrc/time_scan.cu``): the Mamba-1 selective scan and the RG-LRU's
linear recurrence, one launch per layer and call.  They replace no
Pallas kernel: the JAX package scans time with ``lax.scan``
(``models/ssm.py``: ``_chunked_time_scan``, ``_ssm_inner``,
``_rglru_scan``).

CUDA tensors only, contiguous f32; ``ops.selective_scan`` /
``ops.linear_scan`` send CPU tensors to the plain versions in
``kernels/ref.py``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

# the state sizes the selective scan is instantiated for (falcon-mamba-7b)
STATE_SIZES = (16,)


class _Launcher:
    """Lazily bound C entry point of ``libtime_scan``."""

    def __init__(self, symbol: str, n_ptrs: int, n_ints: int):
        self._symbol, self._n_ptrs, self._n_ints = symbol, n_ptrs, n_ints
        self._fn = None

    def __call__(self, *args) -> int:
        if self._fn is None:
            fn = getattr(build.load("time_scan"), self._symbol)
            fn.argtypes = ([ctypes.c_void_p] * self._n_ptrs
                           + [ctypes.c_int] * self._n_ints
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn(*args)


class SelectiveScan:
    """Callable kernel wrapper; ``launches`` counts kernel launches."""

    name = "selective_scan"

    def __init__(self):
        self.launches = 0
        self._launch = _Launcher("selective_scan_launch", 8, 4)

    def __call__(self, dt: torch.Tensor, u: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, A: torch.Tensor, h0: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """dt, u [Bt, S, din]; B, C [Bt, S, N]; A [din, N]; h0 [Bt, din,
        N], all f32.  Returns (y [Bt, S, din], h_last [Bt, din, N])."""
        dev = dt.device
        for t, name, nd in ((dt, "dt", 3), (u, "u", 3), (B, "B", 3),
                            (C, "C", 3), (A, "A", 2), (h0, "h0", 3)):
            build.require(t, name, dtype=torch.float32, ndim=nd, device=dev)
        Bt, S, din = dt.shape
        N = A.shape[1]
        if N not in STATE_SIZES:
            raise ValueError(f"selective_scan has no instantiation for "
                             f"state size {N} (has {STATE_SIZES})")
        if (u.shape != dt.shape or B.shape != (Bt, S, N)
                or C.shape != B.shape or A.shape != (din, N)
                or h0.shape != (Bt, din, N)):
            raise ValueError(f"shapes dt {tuple(dt.shape)}, u "
                             f"{tuple(u.shape)}, B {tuple(B.shape)}, C "
                             f"{tuple(C.shape)}, A {tuple(A.shape)}, h0 "
                             f"{tuple(h0.shape)} do not fit")
        y = torch.empty_like(dt)
        h_last = torch.empty_like(h0)
        err = self._launch(dt.data_ptr(), u.data_ptr(), B.data_ptr(),
                           C.data_ptr(), A.data_ptr(), h0.data_ptr(),
                           y.data_ptr(), h_last.data_ptr(), Bt, S, din, N,
                           build.stream_of(dev))
        build.check_launch(self.name, err)
        self.launches += 1
        return y, h_last


class LinearScan:
    """Callable kernel wrapper; ``launches`` counts kernel launches."""

    name = "linear_scan"

    def __init__(self):
        self.launches = 0
        self._launch = _Launcher("linear_scan_launch", 5, 3)

    def __call__(self, a: torch.Tensor, g: torch.Tensor, h0: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """a, g [Bt, S, w]; h0 [Bt, w], all f32.  Returns (hs [Bt, S, w],
        h_last [Bt, w])."""
        dev = a.device
        for t, name, nd in ((a, "a", 3), (g, "g", 3), (h0, "h0", 2)):
            build.require(t, name, dtype=torch.float32, ndim=nd, device=dev)
        Bt, S, w = a.shape
        if g.shape != a.shape or h0.shape != (Bt, w):
            raise ValueError(f"shapes a {tuple(a.shape)}, g "
                             f"{tuple(g.shape)}, h0 {tuple(h0.shape)} do "
                             "not fit")
        hs = torch.empty_like(a)
        h_last = torch.empty_like(h0)
        err = self._launch(a.data_ptr(), g.data_ptr(), h0.data_ptr(),
                           hs.data_ptr(), h_last.data_ptr(), Bt, S, w,
                           build.stream_of(dev))
        build.check_launch(self.name, err)
        self.launches += 1
        return hs, h_last


selective_scan = SelectiveScan()
linear_scan = LinearScan()
