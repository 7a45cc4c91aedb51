"""Wrappers of the hand-written Hopper flash-attention kernels:

* ``flash_attention_chunk`` / ``flash_attention_chunk_int8``
  (``csrc/flash_attention_chunk.cu``) replace the JAX package's Pallas
  ``kernels/flash_attention.py :: flash_attention_chunk``, bf16/f32 pools
  and int8 pools; one instance each, so a run's launch counts tell which
  branch ran;
* ``flash_attention`` (``csrc/flash_attention.cu``) replaces its static
  ``flash_attention`` (whole-prompt prefill, GPTQ calibration and the
  trainer's forward).  ``FlashAttentionFn`` is its autograd rule: the
  forward launches the kernel; the backward differentiates the plain
  version (``ref.flash_attention_ref``) recomputed on the saved q, k, v,
  because the JAX package's Pallas kernel has no backward either (no
  ``custom_vjp``): its trainer differentiates the XLA reference.

The bf16 bodies of both run on the tensor cores and are built for the
head dims that ``MMA_HEAD_DIMS`` lists for each kernel: the chunk kernel
on mma.sync, the static kernel on wgmma with TMA loads and warp
specialisation (``csrc/hopper.cuh``), also at head dims 80, 120 (staged
in boxes of 64 values, TMA filling the pad with zeros) and 256; their f32
bodies (CUDA cores) take any multiple of 8.

CUDA tensors only; ``kernels/ops.py`` sends CPU tensors to the plain
versions in ``kernels/ref.py``.
"""
from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional

import torch

from repro_torch.kernels import build

ROWS_PER_BLOCK = 48   # f32 bodies: query rows (tokens x heads) per block
# the bf16 (tensor-core) instantiations of each attention kernel
MMA_HEAD_DIMS = {"flash_attention": (64, 80, 120, 128, 256),
                 "flash_attention_chunk": (64, 128),
                 "flash_attention_chunk_int8": (64, 128),
                 "paged_attention": (64, 128),
                 "paged_attention_quant": (64, 128)}


def _block_q(W: int, G: int) -> int:
    """Query tokens per block of the f32 bodies."""
    return max(1, min(W, ROWS_PER_BLOCK // G))


class FlashAttentionChunk:
    """Callable kernel wrapper of one pool format (``int8`` or the
    activation dtype); ``launches`` counts kernel launches."""

    def __init__(self, int8: bool = False):
        self.int8 = int8
        self.name = "flash_attention_chunk" + ("_int8" if int8 else "")
        self.launches = 0
        self._fn = None

    def _launcher(self):
        if self._fn is None:
            fn = getattr(build.load("flash_attention_chunk"),
                         self.name + "_launch")
            nptr = 12 if self.int8 else 10
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * nptr
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
        """q [1, W, H, D]; k_pool/v_pool [NB, BS, KV, D] (one layer; int8
        with k_scales/v_scales [NB, KV] f32 for the int8 instance, q's
        dtype otherwise); block_table [1, MB] int32; q_offset / total_len
        0-d int32 device tensors (read by the kernel, never by the host);
        k_raw/v_raw [1, W, KV, D] in q's dtype.  Returns [1, W, H, D]; rows
        at or past ``total_len - q_offset`` hold garbage, as in the JAX
        kernel."""
        if (k_scales is not None) != self.int8 \
                or (v_scales is not None) != self.int8:
            raise ValueError(f"{self.name} takes "
                             + ("int8 pools with scales" if self.int8
                                else "unscaled pools"))
        dev = q.device
        pool_dtype = torch.int8 if self.int8 else q.dtype
        build.require(q, "q", ndim=4)
        for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
            build.require(t, name, dtype=pool_dtype, ndim=4, device=dev)
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
        check_head_dim(D, q.dtype, self.name)
        if self.int8 and D % 16:
            raise ValueError(f"{self.name}: head_dim {D} must be a multiple "
                             "of 16 (16 int8 codes per load)")
        if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool, k_raw, v_raw)):
            raise ValueError("q, pools and raw K/V must be 16-byte aligned")
        pools = [k_pool.data_ptr(), v_pool.data_ptr()]
        if self.int8:
            for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
                build.require(t, name, dtype=torch.float32, ndim=2,
                              device=dev)
                if t.shape != (NB, KV):
                    raise ValueError(f"{name} must be {(NB, KV)}")
            pools = [k_pool.data_ptr(), k_scales.data_ptr(),
                     v_pool.data_ptr(), v_scales.data_ptr()]
        if alibi_slopes is not None:
            build.require(alibi_slopes, "alibi_slopes", dtype=torch.float32,
                          ndim=1, device=dev)
        out = torch.empty_like(q)
        err = self._launcher()(
            build.dtype_code(q), q.data_ptr(), *pools,
            block_table.data_ptr(), q_offset.data_ptr(),
            total_len.data_ptr(), k_raw.data_ptr(), v_raw.data_ptr(),
            alibi_slopes.data_ptr() if alibi_slopes is not None else None,
            out.data_ptr(), W, H, KV, D, BS, block_table.shape[1],
            _block_q(W, H // KV), int(sliding_window),
            int(alibi_slopes is not None), build.stream_of(dev))
        build.check_launch(self.name, err)
        self.launches += 1
        return out


def check_head_dim(D: int, dtype: torch.dtype,
                   name: str = "flash_attention") -> None:
    """Raise unless kernel ``name`` takes head dim ``D`` in ``dtype``: the
    bf16 (tensor-core) bodies of the attention kernels are instantiated for
    ``MMA_HEAD_DIMS[name]``, the f32 (CUDA-core) bodies take any multiple
    of 8."""
    dims = MMA_HEAD_DIMS[name]
    if dtype == torch.bfloat16 and D not in dims:
        raise ValueError(f"{name}: bf16 head_dim {D} is not built; its "
                         f"tensor-core kernel takes {dims} (another head "
                         "dim is a follow-up in ROADMAP B)")
    if D % 8:
        raise ValueError(f"{name}: head_dim {D} must be a multiple of 8")


class FlashAttention:
    """Callable wrapper of the static prefill kernel; ``launches`` counts
    kernel launches, ``launch_kinds`` counts them by (head dim, causal,
    ALiBi)."""

    name = "flash_attention"

    def __init__(self):
        self.launches = 0
        self.launch_kinds: Counter = Counter()
        self._fn = None

    def _launcher(self):
        if self._fn is None:
            fn = build.load("flash_attention").flash_attention_launch
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                           + [ctypes.c_int] * 11 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 alibi_slopes: Optional[torch.Tensor] = None, *,
                 causal: bool = True, sliding_window: int = 0,
                 q_offset: int = 0) -> torch.Tensor:
        """q [B, Sq, H, D]; k/v [B, Sk, KV, D] in q's dtype; q_offset a
        host int (query i sits at position q_offset + i).  Returns
        [B, Sq, H, D]."""
        dev = q.device
        build.require(q, "q", ndim=4)
        build.require(k, "k", dtype=q.dtype, ndim=4, device=dev)
        build.require(v, "v", dtype=q.dtype, ndim=4, device=dev)
        B, Sq, H, D = q.shape
        Sk, KV = k.shape[1], k.shape[2]
        if v.shape != k.shape or k.shape[0] != B or k.shape[3] != D \
                or H % KV:
            raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                             f"{tuple(q.shape)}")
        check_head_dim(D, q.dtype)
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("q/k/v must be 16-byte aligned")
        if alibi_slopes is not None:
            build.require(alibi_slopes, "alibi_slopes", dtype=torch.float32,
                          ndim=1, device=dev)
        out = torch.empty_like(q)
        err = self._launcher()(
            build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            alibi_slopes.data_ptr() if alibi_slopes is not None else None,
            out.data_ptr(), B, Sq, Sk, H, KV, D, _block_q(Sq, H // KV),
            int(q_offset), int(causal), int(sliding_window),
            int(alibi_slopes is not None), build.stream_of(dev))
        build.check_launch(self.name, err)
        self.launches += 1
        self.launch_kinds[(D, bool(causal), alibi_slopes is not None)] += 1
        return out


class FlashAttentionFn(torch.autograd.Function):
    """The static kernel under autograd.  ``forward`` launches
    ``flash_attention`` (one launch, counted by the wrapper) and saves
    q, k, v; ``backward`` recomputes the plain version on them under
    ``enable_grad`` and returns its ``torch.autograd.grad``: dq, dk, dv
    are exactly the plain version's gradients at the same inputs (no
    backward kernel yet: ROADMAP B)."""

    @staticmethod
    def forward(ctx, q, k, v, alibi_slopes, causal, sliding_window,
                q_offset):
        ctx.save_for_backward(q, k, v, alibi_slopes)
        ctx.kw = dict(causal=causal, sliding_window=sliding_window,
                      q_offset=q_offset)
        return flash_attention(q, k, v, alibi_slopes, **ctx.kw)

    @staticmethod
    def backward(ctx, d_out):
        from repro_torch.kernels.ref import flash_attention_ref
        q, k, v, slopes = ctx.saved_tensors
        needs = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip((q, k, v), needs)]
            out = flash_attention_ref(*ins, alibi_slopes=slopes, **ctx.kw)
            grads = iter(torch.autograd.grad(
                out, [t for t, n in zip(ins, needs) if n], d_out))
        return (*(next(grads) if n else None for n in needs),
                None, None, None, None)


flash_attention_chunk = FlashAttentionChunk()
flash_attention_chunk_int8 = FlashAttentionChunk(int8=True)
flash_attention = FlashAttention()
