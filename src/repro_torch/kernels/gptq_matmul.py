"""Wrapper of the hand-written Hopper W4A16 GPTQ matmul kernel
(``csrc/gptq_matmul.cu``; replaces the JAX package's Pallas
``kernels/gptq_matmul.py :: gptq_matmul``).

CUDA tensors only; ``ops.quant_matmul`` sends CPU tensors to the plain
version in ``kernels/ref.py``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build

PACK = 8


class GptqMatmul:
    """Callable kernel wrapper; ``launches`` counts kernel launches.

    The kernel takes contiguous groups only (g = k // group_size).  A
    ``g_idx`` passed in is checked against that once per tensor: the
    check reads the tensor on the host, and the verified tensor is kept
    referenced so its memory can never be reused by another ``g_idx``.
    """

    name = "gptq_matmul"

    def __init__(self):
        self.launches = 0
        self._fn = None
        self._groups_ok: Dict[Tuple, torch.Tensor] = {}

    def _launcher(self):
        if self._fn is None:
            fn = build.load("gptq_matmul").gptq_matmul_launch
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                           + [ctypes.c_int] * 4 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def _check_groups(self, g_idx: torch.Tensor, K: int, gs: int) -> None:
        key = (g_idx.data_ptr(), tuple(g_idx.shape), tuple(g_idx.stride()),
               g_idx.dtype, gs)
        if key in self._groups_ok:
            return
        want = torch.arange(K, device=g_idx.device) // gs
        if g_idx.shape != (K,) or not torch.equal(g_idx.long(), want):
            raise ValueError("gptq_matmul takes contiguous groups only "
                             "(g_idx == arange(K) // group_size)")
        self._groups_ok[key] = g_idx

    def __call__(self, x: torch.Tensor, qweight: torch.Tensor,
                 scales: torch.Tensor, zeros: torch.Tensor,
                 g_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [M, K] bf16/f32; qweight [K/8, N] int32; scales/zeros
        [K/gs, N] f32.  Returns x @ dequant(W) as [M, N] in x.dtype."""
        dev = x.device
        build.require(x, "x", ndim=2)
        build.require(qweight, "qweight", dtype=torch.int32, ndim=2,
                      device=dev)
        build.require(scales, "scales", dtype=torch.float32, ndim=2,
                      device=dev)
        build.require(zeros, "zeros", dtype=torch.float32, ndim=2,
                      device=dev)
        M, K = x.shape
        N = qweight.shape[1]
        n_groups = scales.shape[0]
        if (K % n_groups or qweight.shape[0] * PACK != K
                or scales.shape != (n_groups, N) or zeros.shape != scales.shape):
            raise ValueError(f"shapes x {tuple(x.shape)}, qweight "
                             f"{tuple(qweight.shape)}, scales "
                             f"{tuple(scales.shape)} do not fit")
        gs = K // n_groups
        if gs % PACK:
            raise ValueError(f"group_size {gs} must be a multiple of {PACK}")
        if g_idx is not None:
            self._check_groups(g_idx, K, gs)
        y = torch.empty((M, N), dtype=x.dtype, device=dev)
        err = self._launcher()(
            build.dtype_code(x), x.data_ptr(), qweight.data_ptr(),
            scales.data_ptr(), zeros.data_ptr(), y.data_ptr(), M, K, N, gs,
            build.stream_of(dev))
        build.check_launch(self.name, err)
        self.launches += 1
        return y


gptq_matmul = GptqMatmul()
