"""Wrapper of the hand-written Hopper W4A16 GPTQ matmul kernel
(``csrc/gptq_matmul.cu``; replaces the JAX package's Pallas
``kernels/gptq_matmul.py :: gptq_matmul``), and the planner of its bf16
bodies.

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
ROUTES = {"wgmma": 0, "mma": 1}          # ROUTE_WGMMA / ROUTE_MMA
# the wgmma body: BN weight columns a block, token tiles NT, its stages'
# bytes a block by the blocks an SM holds (GTile::MIN_BLOCKS)
BN = 128
TOKEN_TILES = (8, 16, 32, 64, 128, 256)
MAX_STAGES = 8
RING_BUDGET = {2: 96 * 1024, 1: 200 * 1024}
MAX_SPLITS = 16
MAX_PARTIAL = 64 << 20  # bytes of split-K partials a call
COUNTERS = 4096        # split-K tile counters a (device, stream)
# The planner's cost model, in us on an H100 SXM (cold L2), by token tile:
# a block's time a 64-wide k tile, and the split-K fix-up's time a split
# (the last block reads every split's partials of its tile from L2).
# Fitted to the plan sweeps of chip_b3_plans.py at qwen2-1.5b's and
# command-r-plus-104b's linears.
TILE_US = {8: 0.5, 16: 0.5, 32: 0.52, 64: 0.57, 128: 0.86, 256: 0.97}
FIX_US = {8: 0.2, 16: 0.25, 32: 0.45, 64: 0.8, 128: 1.7, 256: 3.8}
LONG_SPLIT = 64        # k tiles a split from which decode blocks overlap
# the mma.sync body (an N that is not a multiple of 4): mt -> (BM, BN)
TILES = {1: (16, 64), 8: (128, 128)}
DECODE_BLOCKS_PER_SM = 4


class Plan(NamedTuple):
    """How a bf16 body covers one product.  ``route`` "wgmma" (``tile`` =
    NT tokens a block) or "mma" (an N that is not a multiple of 4, which
    no served linear has: ``tile`` = m16 tiles a block); ``bm`` x ``bn``
    output tiles (rows of y, columns of y); ``kt_per`` 64-wide k tiles
    per split, ``splits`` blocks along K per output tile; ``sr`` scale
    rows staged per k tile; ``stages`` the wgmma ring's depth (0 for
    mma, whose stages are fixed)."""
    route: str
    tile: int
    bm: int
    bn: int
    kt_per: int
    splits: int
    sr: int
    stages: int

    @property
    def launches(self) -> int:
        """Kernel launches per call: one; the last split of each output
        tile sums the partials inside the same launch."""
        return 1


def scale_rows(gs: int) -> int:
    """The most groups a 64-wide k tile spans (over one period of the
    tiles against the groups)."""
    period = BK * gs // math.gcd(BK, gs)
    return max((k0 + BK - 1) // gs - k0 // gs + 1
               for k0 in range(0, period, BK))


def stage_bytes(nt: int, sr: int) -> int:
    """One wgmma stage: x [nt][64] bf16, codes [8][BN] int32, scale and
    zero rows [sr][BN] f32 (``GTile::stage_bytes``)."""
    return nt * 128 + (BK // PACK) * BN * 4 + 2 * sr * BN * 4


def _cost(nt: int, tiles: int, kt: int, splits: int, sms: int,
          one_row_tile: bool = True) -> float:
    """The model's time of ``tiles`` output tiles of token tile ``nt``
    over ``kt`` k tiles in ``splits`` splits: waves of blocks times a
    split's k tiles, plus the fix-up.  Decode tiles run two blocks an SM,
    and where one tile holds every row their long splits (bound by bytes
    in flight, not by the SM) count waves at twice that."""
    slots = sms * (2 if nt <= 32 else 1)
    kt_per = math.ceil(kt / splits)
    if nt <= 32 and one_row_tile and kt_per >= LONG_SPLIT:
        slots *= 2
    waves = math.ceil(tiles * splits / slots)
    return (waves * kt_per * TILE_US[nt]
            + (FIX_US[nt] * splits if splits > 1 else 0.0))


@functools.lru_cache(maxsize=4096)
def plan(M: int, K: int, N: int, gs: int, sms: int) -> Plan:
    """The route, the token tile and the split of K across blocks for (M,
    K, N): the cheapest (tile, splits) by ``_cost``, ties to the larger
    tile and the fewer splits.  Any token tile up to the smallest that
    holds M (a smaller one gives a small product more blocks), under 64
    rows only up to M 64.  K splits only where the tile's output tiles
    leave block slots idle.  An N that is not a multiple of 4 takes the
    mma.sync body (16-row tiles up to M 256), split until its blocks fill
    DECODE_BLOCKS_PER_SM an SM (mt 1) or one (mt 8)."""
    kt = math.ceil(K / BK)
    sr = scale_rows(gs)
    if N % 4:
        mt = 1 if M <= 256 else 8
        bm, bn = TILES[mt]
        tiles = max(1, math.ceil(M / bm) * math.ceil(N / bn))
        want = sms * (DECODE_BLOCKS_PER_SM if mt == 1 else 1)
        splits = 1 if tiles >= want else min(kt, math.ceil(want / tiles))
        kt_per = math.ceil(kt / splits)
        return Plan("mma", mt, bm, bn, kt_per, math.ceil(kt / kt_per), sr, 0)
    top = next((t for t in TOKEN_TILES if t >= M), TOKEN_TILES[-1])
    tiles_of = lambda nt: max(1, math.ceil(M / nt) * math.ceil(N / BN))
    # tiles under 64 rows re-read the weights a row tile: up to M 64 only
    cands = [t for t in TOKEN_TILES if t <= top and (t >= 64 or M <= 64)]

    def splits_of(nt):
        # K splits only where the output tiles leave the SMs' block slots
        # idle, and the partials stay under MAX_PARTIAL bytes
        if tiles_of(nt) >= sms * (2 if nt <= 32 else 1):
            return range(1, 2)
        most = min(kt, MAX_SPLITS, max(1, MAX_PARTIAL // (4 * M * N)))
        return range(1, most + 1)

    nt, splits = min(
        ((t, s) for t in cands for s in splits_of(t)),
        key=lambda c: (_cost(c[0], tiles_of(c[0]), kt, c[1], sms, M <= c[0]),
                       -c[0], c[1]))
    kt_per = math.ceil(kt / splits)
    per_sm = 2 if nt <= 32 else 1
    stages = max(1, min(MAX_STAGES, kt_per,
                        RING_BUDGET[per_sm] // stage_bytes(nt, sr)))
    return Plan("wgmma", nt, nt, BN, kt_per, math.ceil(kt / kt_per), sr,
                stages)


_COUNTERS: Dict[Tuple, torch.Tensor] = {}


def counters(device: torch.device) -> torch.Tensor:
    """The split-K tile counters of ``device`` and its current stream:
    COUNTERS int32, zeroed once at the first bf16 call on that stream and
    kept; the block that sums a tile resets its counter, so every launch
    leaves them at zero.  Launches on one stream run in order; another
    stream gets its own.  A step graph runs its warm-up on its capture
    stream, so the counters its captured launches use are allocated
    there, before and outside the capture; an allocation inside a capture
    (memory the graph's pool would hand out again) raises."""
    key = (device, build.stream_of(device))
    if key not in _COUNTERS:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("gptq_matmul: its split-K counters for this "
                               "stream must be allocated before a CUDA-graph "
                               "capture (run one call on the stream first)")
        _COUNTERS[key] = torch.zeros(COUNTERS, dtype=torch.int32,
                                     device=device)
    return _COUNTERS[key]


def drop_counters(stream: int) -> None:
    """Forget the counters kept for the stream whose handle is ``stream``
    (a closed runner's capture stream)."""
    for key in [k for k in _COUNTERS if k[1] == stream]:
        del _COUNTERS[key]


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
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                           + [ctypes.c_int] * 9 + [ctypes.c_void_p])
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

    def plan_for(self, x: torch.Tensor, N: int, gs: int) -> Plan:
        """The plan of a bf16 call on x [M, K] at N columns."""
        dev = x.device
        if dev not in self._sms:
            self._sms[dev] = torch.cuda.get_device_properties(
                dev).multi_processor_count
        return plan(x.shape[0], x.shape[1], N, gs, self._sms[dev])

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
        partial = ctr = None
        route = tile = sr = kt_per = stages = 0
        if x.dtype == torch.bfloat16:           # the tensor-core bodies
            if any(t.data_ptr() % 16 for t in (x, qweight, scales, zeros)):
                raise ValueError("x, qweight, scales and zeros must be "
                                 "16-byte aligned")
            p = self.plan_for(x, N, gs)
            route, tile, sr = ROUTES[p.route], p.tile, p.sr
            kt_per, stages = p.kt_per, p.stages
            ctr = counters(dev)
            if p.splits > 1:
                # allocated per call; under a step graph's capture it comes
                # from the graph's private pool, as every temporary does,
                # and a replay reuses the same memory
                partial = torch.empty((p.splits, M, N), dtype=torch.float32,
                                      device=dev)
        err = self._launcher()(
            build.dtype_code(x), x.data_ptr(), qweight.data_ptr(),
            scales.data_ptr(), zeros.data_ptr(), y.data_ptr(),
            None if partial is None else partial.data_ptr(),
            None if ctr is None else ctr.data_ptr(), M, K, N, gs, route,
            tile, sr, kt_per, stages, build.stream_of(dev))
        build.check_launch(self.name, err)
        self.launches += 1
        return y


gptq_matmul = GptqMatmul()
