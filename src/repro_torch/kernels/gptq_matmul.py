"""Wrapper of the hand-written Hopper W4A16 GPTQ matmul kernel
(``csrc/gptq_matmul.cu``; replaces the JAX package's Pallas
``kernels/gptq_matmul.py :: gptq_matmul``), and the planner of its bf16
tensor-core body.

CUDA tensors only; ``ops.quant_matmul`` sends CPU tensors to the plain
version in ``kernels/ref.py``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build

PACK = 8
BK = 64                                  # k per staged tile (gptq_matmul.cu)
TILES = {1: (16, 64), 4: (64, 128), 8: (128, 128)}   # mt -> (BM, BN)
DECODE_BLOCKS_PER_SM = 4


class Plan(NamedTuple):
    """How the bf16 body covers one product: m16 tiles per block ``mt``
    (BM x BN output tiles), ``kt_per`` 64-wide k tiles per split,
    ``splits`` blocks along K per output tile, ``sr`` scale rows staged
    per k tile."""
    mt: int
    bm: int
    bn: int
    kt_per: int
    splits: int
    sr: int

    @property
    def launches(self) -> int:
        """Kernel launches per call: the product, plus the split-K sum."""
        return 1 + (self.splits > 1)


@functools.lru_cache(maxsize=4096)
def plan(M: int, K: int, N: int, gs: int, sms: int) -> Plan:
    """The tile for M (16 rows for decode, 64, else 128) and the split of
    K across blocks when the output tiles alone would give the ``sms`` SMs
    too few blocks: fewer than one each, or for decode (bound by bytes in
    flight, not by operations) fewer than DECODE_BLOCKS_PER_SM each."""
    mt = 1 if M <= 16 else 4 if M <= 64 else 8
    bm, bn = TILES[mt]
    tiles = max(1, math.ceil(M / bm) * math.ceil(N / bn))
    kt = math.ceil(K / BK)
    want = sms * (DECODE_BLOCKS_PER_SM if mt == 1 else 1)
    splits = 1 if tiles >= want else min(kt, math.ceil(want / tiles))
    kt_per = math.ceil(kt / splits)
    return Plan(mt, bm, bn, kt_per, math.ceil(kt / kt_per),
                min(BK // PACK, (BK - 1) // gs + 2))


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
        self._sms: Dict[torch.device, int] = {}

    def _launcher(self):
        if self._fn is None:
            fn = build.load("gptq_matmul").gptq_matmul_launch
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                           + [ctypes.c_int] * 7 + [ctypes.c_void_p])
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
        partial, mt, sr, kt_per, launches = None, 0, 0, 0, 1
        if x.dtype == torch.bfloat16:           # the tensor-core body
            if x.data_ptr() % 16 or qweight.data_ptr() % 16:
                raise ValueError("x and qweight must be 16-byte aligned")
            if dev not in self._sms:
                self._sms[dev] = torch.cuda.get_device_properties(
                    dev).multi_processor_count
            p = plan(M, K, N, gs, self._sms[dev])
            mt, sr, kt_per, launches = p.mt, p.sr, p.kt_per, p.launches
            if p.splits > 1:
                # allocated per call; under a step graph's capture it comes
                # from the graph's private pool, as every temporary does,
                # and a replay reuses the same memory
                partial = torch.empty((p.splits, M, N), dtype=torch.float32,
                                      device=dev)
        err = self._launcher()(
            build.dtype_code(x), x.data_ptr(), qweight.data_ptr(),
            scales.data_ptr(), zeros.data_ptr(), y.data_ptr(),
            None if partial is None else partial.data_ptr(), M, K, N, gs,
            mt, sr, kt_per, build.stream_of(dev))
        build.check_launch(self.name, err)
        self.launches += launches
        return y


gptq_matmul = GptqMatmul()
