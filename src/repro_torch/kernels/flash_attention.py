"""Wrapper of the hand-written Hopper chunk-prefill attention kernel
(``csrc/flash_attention_chunk.cu``; replaces the bf16-pool branch of the
JAX package's Pallas ``kernels/flash_attention.py ::
flash_attention_chunk``).

The int8-pool branch of that kernel and the static-offset
``flash_attention`` (whole-prompt prefill, training) are not ported yet
(ROADMAP B2/B5).  CUDA tensors only; ``ops.chunk_prefill_attention``
sends CPU tensors to the plain version in ``kernels/ref.py``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

ROWS_PER_BLOCK = 48   # query rows (tokens x grouped heads) per thread block


class FlashAttentionChunk:
    """Callable kernel wrapper; ``launches`` counts kernel launches."""

    name = "flash_attention_chunk"

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _launcher(self):
        if self._fn is None:
            fn = build.load("flash_attention_chunk").flash_attention_chunk_launch
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                           + [ctypes.c_int] * 9 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, q: torch.Tensor, k_pool: torch.Tensor,
                 v_pool: torch.Tensor, block_table: torch.Tensor,
                 q_offset: torch.Tensor, total_len: torch.Tensor,
                 k_raw: torch.Tensor, v_raw: torch.Tensor,
                 alibi_slopes: Optional[torch.Tensor] = None, *,
                 k_scales=None, v_scales=None,
                 sliding_window: int = 0) -> torch.Tensor:
        """q [1, W, H, D]; k_pool/v_pool [NB, BS, KV, D] (one layer);
        block_table [1, MB] int32; q_offset / total_len 0-d int32 device
        tensors (read by the kernel, never by the host); k_raw/v_raw
        [1, W, KV, D].  Returns [1, W, H, D]; rows at or past
        ``total_len - q_offset`` hold garbage, as in the JAX kernel."""
        if k_scales is not None or v_scales is not None:
            raise NotImplementedError(
                "int8 pools in flash_attention_chunk are not ported yet "
                "(ROADMAP A8)")
        dev = q.device
        build.require(q, "q", ndim=4)
        for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
            build.require(t, name, dtype=q.dtype, ndim=4, device=dev)
        for name, t in (("k_raw", k_raw), ("v_raw", v_raw)):
            build.require(t, name, dtype=q.dtype, ndim=4, device=dev)
        build.require(block_table, "block_table", dtype=torch.int32, ndim=2,
                      device=dev)
        for name, t in (("q_offset", q_offset), ("total_len", total_len)):
            build.require(t, name, dtype=torch.int32, device=dev)
            if t.numel() != 1:
                raise ValueError(f"{name} must be a scalar tensor")
        B, W, H, D = q.shape
        NB, BS, KV, Dk = k_pool.shape
        if B != 1 or block_table.shape[0] != 1:
            raise ValueError("the chunk kernel serves one sequence per call")
        if v_pool.shape != k_pool.shape or Dk != D or H % KV:
            raise ValueError(f"pool {tuple(k_pool.shape)} does not fit q "
                             f"{tuple(q.shape)}")
        if k_raw.shape != (1, W, KV, D) or v_raw.shape != k_raw.shape:
            raise ValueError(f"k_raw/v_raw must be {(1, W, KV, D)}")
        if D % 8:
            raise ValueError(f"head_dim {D} must be a multiple of 8")
        if any(t.data_ptr() % 16 for t in (k_pool, v_pool, k_raw, v_raw)):
            raise ValueError("pools and raw K/V must be 16-byte aligned")
        if alibi_slopes is not None:
            build.require(alibi_slopes, "alibi_slopes", dtype=torch.float32,
                          ndim=1, device=dev)
        G = H // KV
        bq = max(1, min(W, ROWS_PER_BLOCK // G))
        out = torch.empty_like(q)
        err = self._launcher()(
            build.dtype_code(q), q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), block_table.data_ptr(), q_offset.data_ptr(),
            total_len.data_ptr(), k_raw.data_ptr(), v_raw.data_ptr(),
            alibi_slopes.data_ptr() if alibi_slopes is not None else None,
            out.data_ptr(), W, H, KV, D, BS, block_table.shape[1], bq,
            int(sliding_window), int(alibi_slopes is not None),
            build.stream_of(dev))
        build.check_launch(self.name, err)
        self.launches += 1
        return out


flash_attention_chunk = FlashAttentionChunk()
