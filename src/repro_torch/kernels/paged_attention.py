"""Wrapper of the hand-written Hopper paged decode-attention kernel
(``csrc/paged_attention.cu``; replaces the JAX package's Pallas
``kernels/paged_attention.py :: paged_attention``), and the planner of its
bf16 split page walk.

CUDA tensors only; ``ops.paged_attention`` sends CPU tensors to the plain
version in ``kernels/ref.py``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import check_head_dim

MAX_G = 16     # grouped query heads per KV head: the 16 rows of an mma tile
MAX_D = 128    # head_dim of the f32 body: one output column per thread
SPLIT_TOKENS = 128   # keys a split walks at least (two 64-key tiles)
MAX_SPLITS = 64      # splits of a long table (the kernel holds 575 at D 64)


class Plan(NamedTuple):
    """How the bf16 body covers a batch: ``pps`` pages per split,
    ``splits`` splits per (sequence, KV head), the launch ``grid``
    (B, KV, splits) and the f32 ``scratch`` of the splits' partials
    (B, KV, splits, G, D + 2)."""
    pps: int
    splits: int
    grid: Tuple[int, int, int]
    scratch: Tuple[int, int, int, int, int]

    @property
    def launches(self) -> int:
        """Kernel launches per call: the last block of each (sequence, KV
        head) combines the partials inside the same launch."""
        return 1


@functools.lru_cache(maxsize=1024)
def plan(B: int, KV: int, G: int, D: int, MB: int, BS: int) -> Plan:
    """Split the page walk from the table's shape alone (``seq_lens`` stay
    on the device): each split walks at least SPLIT_TOKENS keys, and a
    table of many pages gets at most MAX_SPLITS splits."""
    pps = min(MB, max(math.ceil(SPLIT_TOKENS / BS),
                      math.ceil(MB / MAX_SPLITS)))
    splits = math.ceil(MB / pps)
    return Plan(pps, splits, (B, KV, splits), (B, KV, splits, G, D + 2))


_SCRATCH: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def scratch(device: torch.device, p: Plan
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The f32 partials and the int32 arrival counters of plan ``p`` on
    ``device`` and its current stream, allocated at the first call of each
    (device, stream, shape) and kept: nothing is allocated per call.  Both
    wrappers share them, as launches on one stream run in order; another
    stream gets its own.

    The counters are zeroed once, and the block that combines a (sequence,
    KV head) resets its own.  A launch that dies part way (a device fault,
    which is sticky: every later CUDA call of the process raises) can
    leave one above zero; a later launch that found one so would trap,
    not combine early.  ``_SCRATCH.clear()`` drops the cache.

    A step graph (``serving/step_graph.py``) runs its warm-up on its
    capture stream, so the scratch its captured launches use is allocated
    there, before and outside the capture; every launch, replayed or not,
    leaves the counters at zero for the next."""
    key = (device, build.stream_of(device), p.scratch)
    if key not in _SCRATCH:
        B, KV = p.scratch[:2]
        _SCRATCH[key] = (
            torch.empty(p.scratch, dtype=torch.float32, device=device),
            torch.zeros(B * KV, dtype=torch.int32, device=device))
    return _SCRATCH[key]


def drop_scratch(stream: int) -> None:
    """Forget the scratch cached for the stream whose handle is ``stream``
    (a closed runner's capture stream)."""
    for key in [k for k in _SCRATCH if k[1] == stream]:
        del _SCRATCH[key]


def check_heads(H: int, KV: int, D: int, dtype: torch.dtype,
                name: str = "paged_attention") -> None:
    """Raise unless the decode kernel takes these heads in ``dtype``: G =
    H / KV <= MAX_G; bf16 a head dim of ``MMA_HEAD_DIMS[name]`` (tensor
    cores), f32 any multiple of 8 up to MAX_D."""
    if H % KV or H // KV > MAX_G:
        raise ValueError(f"{name}: unsupported heads H={H} KV={KV} (need "
                         f"G = H / KV <= {MAX_G})")
    check_head_dim(D, dtype, name)
    if D > MAX_D:
        raise ValueError(f"{name}: head_dim {D} > {MAX_D}")


def launch_args(q: torch.Tensor, KV: int, MB: int, BS: int) -> list:
    """(scratch pointer, counters pointer, pps, splits) of a call: the
    plan's for bf16, unused by the f32 body."""
    B, H, D = q.shape
    if q.dtype != torch.bfloat16:
        return [None, None, MB, 1]
    p = plan(B, KV, H // KV, D, MB, BS)
    part, counters = scratch(q.device, p)
    return [part.data_ptr(), counters.data_ptr(), p.pps, p.splits]


class PagedAttention:
    """Callable kernel wrapper; ``launches`` counts kernel launches."""

    name = "paged_attention"

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _launcher(self):
        if self._fn is None:
            fn = build.load("paged_attention").paged_attention_launch
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                           + [ctypes.c_int] * 10 + [ctypes.c_void_p])
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
        check_heads(H, KV, D, q.dtype, self.name)
        if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
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
            build.dtype_code(q), q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), block_table.data_ptr(), seq_lens.data_ptr(),
            alibi_slopes.data_ptr() if alibi_slopes is not None else None,
            out.data_ptr(), part, counters, B, H, KV, D, BS, MB, pps, splits,
            int(sliding_window), int(alibi_slopes is not None),
            build.stream_of(dev))
        build.check_launch(self.name, err)
        self.launches += 1
        return out


paged_attention = PagedAttention()
