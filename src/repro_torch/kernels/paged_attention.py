"""Wrapper of the hand-written Hopper paged decode-attention kernel
(``csrc/paged_attention.cu``; replaces the JAX package's Pallas
``kernels/paged_attention.py :: paged_attention``).

CUDA tensors only; ``ops.paged_attention`` sends CPU tensors to the plain
version in ``kernels/ref.py``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

MAX_G = 16     # grouped query heads per KV head (registers of the kernel)
MAX_D = 128    # head_dim: one output column per thread


class PagedAttention:
    """Callable kernel wrapper; ``launches`` counts kernel launches."""

    name = "paged_attention"

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _launcher(self):
        if self._fn is None:
            fn = build.load("paged_attention").paged_attention_launch
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                           + [ctypes.c_int] * 8 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, q: torch.Tensor, k_pool: torch.Tensor,
                 v_pool: torch.Tensor, block_table: torch.Tensor,
                 seq_lens: torch.Tensor,
                 alibi_slopes: Optional[torch.Tensor] = None, *,
                 sliding_window: int = 0) -> torch.Tensor:
        """q [B, H, D]; k_pool/v_pool [NB, BS, KV, D] (one layer);
        block_table [B, MB] int32; seq_lens [B] int32 (counting the new
        token); alibi_slopes [H] f32 or None.  Returns [B, H, D]."""
        dev = q.device
        build.require(q, "q", ndim=3)
        build.require(k_pool, "k_pool", dtype=q.dtype, ndim=4, device=dev)
        build.require(v_pool, "v_pool", dtype=q.dtype, ndim=4, device=dev)
        build.require(block_table, "block_table", dtype=torch.int32, ndim=2,
                      device=dev)
        build.require(seq_lens, "seq_lens", dtype=torch.int32, ndim=1,
                      device=dev)
        B, H, D = q.shape
        NB, BS, KV, Dk = k_pool.shape
        if v_pool.shape != k_pool.shape or Dk != D:
            raise ValueError(f"pool shapes {tuple(k_pool.shape)} / "
                             f"{tuple(v_pool.shape)} do not fit q {(B, H, D)}")
        if H % KV or H // KV > MAX_G or D > MAX_D or D % 8:
            raise ValueError(f"unsupported heads H={H} KV={KV} D={D} (need "
                             f"G <= {MAX_G}, D <= {MAX_D}, D % 8 == 0)")
        if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
            raise ValueError("pools must be 16-byte aligned")
        if block_table.shape[0] != B or seq_lens.shape[0] != B:
            raise ValueError("block_table / seq_lens batch != q batch")
        if alibi_slopes is not None:
            build.require(alibi_slopes, "alibi_slopes", dtype=torch.float32,
                          ndim=1, device=dev)
        out = torch.empty_like(q)
        err = self._launcher()(
            build.dtype_code(q), q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), block_table.data_ptr(), seq_lens.data_ptr(),
            alibi_slopes.data_ptr() if alibi_slopes is not None else None,
            out.data_ptr(), B, H, KV, D, BS, block_table.shape[1],
            int(sliding_window), int(alibi_slopes is not None),
            build.stream_of(dev))
        build.check_launch(self.name, err)
        self.launches += 1
        return out


paged_attention = PagedAttention()
