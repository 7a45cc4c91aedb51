"""Wrapper of the hand-written Hopper paged decode-attention kernel over the
int8 pool (``csrc/paged_attention.cu``, entry ``paged_attention_quant_launch``;
replaces the JAX package's Pallas ``kernels/paged_attention_quant.py ::
paged_attention_quant``).

The kernel is the decode kernel's body with int8 pool tiles dequantized
to bf16 in shared memory (one f32 scale per block and KV head), the same
split page walk, plan and scratch.  CUDA
tensors only; ``ops.paged_attention_quant`` sends CPU tensors to the
plain version in ``kernels/ref.py``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import check_heads, launch_args


class PagedAttentionQuant:
    """Callable kernel wrapper; ``launches`` counts kernel launches."""

    name = "paged_attention_quant"

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _launcher(self):
        if self._fn is None:
            fn = build.load("paged_attention").paged_attention_quant_launch
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 11
                           + [ctypes.c_int] * 10 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, q: torch.Tensor, k_values: torch.Tensor,
                 k_scales: torch.Tensor, v_values: torch.Tensor,
                 v_scales: torch.Tensor, block_table: torch.Tensor,
                 seq_lens: torch.Tensor,
                 alibi_slopes: Optional[torch.Tensor] = None, *,
                 sliding_window: int = 0) -> torch.Tensor:
        """q [B, H, D] bf16/f32; k_values/v_values [NB, BS, KV, D] int8
        (one layer); k_scales/v_scales [NB, KV] f32; block_table [B, MB]
        int32; seq_lens [B] int32 (counting the new token); alibi_slopes
        [H] f32 or None.  Returns [B, H, D] in q's dtype."""
        dev = q.device
        build.require(q, "q", ndim=3)
        for name, t in (("k_values", k_values), ("v_values", v_values)):
            build.require(t, name, dtype=torch.int8, ndim=4, device=dev)
        for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
            build.require(t, name, dtype=torch.float32, ndim=2, device=dev)
        build.require(block_table, "block_table", dtype=torch.int32, ndim=2,
                      device=dev)
        build.require(seq_lens, "seq_lens", dtype=torch.int32, ndim=1,
                      device=dev)
        B, H, D = q.shape
        NB, BS, KV, Dk = k_values.shape
        if v_values.shape != k_values.shape or Dk != D:
            raise ValueError(f"pool shapes {tuple(k_values.shape)} / "
                             f"{tuple(v_values.shape)} do not fit q "
                             f"{(B, H, D)}")
        if k_scales.shape != (NB, KV) or v_scales.shape != (NB, KV):
            raise ValueError(f"scales must be {(NB, KV)}")
        check_heads(H, KV, D, q.dtype, self.name)
        if D % 16:
            raise ValueError(f"{self.name}: head_dim {D} must be a multiple "
                             "of 16 (16 int8 codes per load)")
        if any(t.data_ptr() % 16 for t in (q, k_values, v_values)):
            raise ValueError("q and the pools must be 16-byte aligned")
        if block_table.shape[0] != B or seq_lens.shape[0] != B:
            raise ValueError("block_table / seq_lens batch != q batch")
        if alibi_slopes is not None:
            build.require(alibi_slopes, "alibi_slopes", dtype=torch.float32,
                          ndim=1, device=dev)
        MB = block_table.shape[1]
        part, counters, pps, splits = launch_args(q, KV, MB, BS)
        out = torch.empty_like(q)
        err = self._launcher()(
            build.dtype_code(q), q.data_ptr(), k_values.data_ptr(),
            k_scales.data_ptr(), v_values.data_ptr(), v_scales.data_ptr(),
            block_table.data_ptr(), seq_lens.data_ptr(),
            alibi_slopes.data_ptr() if alibi_slopes is not None else None,
            out.data_ptr(), part, counters, B, H, KV, D, BS, MB, pps, splits,
            int(sliding_window), int(alibi_slopes is not None),
            build.stream_of(dev))
        build.check_launch(self.name, err)
        self.launches += 1
        return out


paged_attention_quant = PagedAttentionQuant()
