"""Wrappers of the hand-written Hopper time-scan kernels
(``csrc/time_scan.cu``): the Mamba-1 selective scan and the RG-LRU's
linear recurrence, one launch per layer and call, and their reverse-time
backward kernels behind the autograd rules ``SsmScanFn`` (the fused
Mamba-1 mixer core, the trainer's path), ``SelectiveScanFn`` (the scan
alone) and ``LinearScanFn``.  They replace no Pallas kernel: the JAX
package scans time with ``lax.scan`` (``models/ssm.py``:
``_chunked_time_scan``, ``_ssm_inner``, ``_rglru_scan``) and XLA
differentiates it.

CUDA tensors only: ``ops.selective_scan`` (the scan alone, contiguous
f32), ``ops.ssm_scan`` (the fused Mamba-1 mixer core, f32 or bf16, its
B, C and z read in place) and ``ops.linear_scan`` send CPU tensors to the
plain versions in ``kernels/ref.py``, and a call on the card that autograd
records to the autograd rules.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build

# the state sizes the selective scan is instantiated for (falcon-mamba-7b)
STATE_SIZES = (16,)


# the selective scan's threads a block and time steps a staged tile
# (csrc/time_scan.cu: THREADS, TT_WAVE); its channel counts a block
# (THREADS x states a lane / N: 128 or 64) are multiples of
# CHANNEL_MULTIPLE
THREADS = 256
TT_WAVE = 16
CHANNEL_MULTIPLE = 64
LANE_STATES = (8, 4)
# the selective scan's backward (csrc/time_scan.cu: BWD_NS, BWD_THREADS,
# BWD_CH, BWD_PART_A): states a lane, threads and channels a block, floats
# a (sequence, channel) of its per-sequence partial sums; it walks the
# forward's staged tiles, whose entering states (the checkpoints) the
# forward stores under autograd
BWD_STATES = 4
BWD_THREADS = 256
BWD_CHANNELS = 64
BWD_PART_A = 20
# tiles a backward block's arrival at its sequence's counter covers
# (csrc/time_scan.cu: BWD_GROUP)
BWD_GROUP = 4


def tiles(S: int) -> int:
    """The forward's staged tiles over S steps: its checkpoints a
    sequence (a decode step's one-step tile is one as well)."""
    return -(-S // TT_WAVE)


def plan(Bt: int, din: int, sms: int = 132) -> int:
    """The states a lane of a selective-scan launch: 8 (the fewest lanes a
    channel, the least overhead a state) if its grid of Bt x din / 128
    blocks still gives nearly every SM one (7/8 of them), as at the
    serve's waves and decode steps (8 sequences), else 4 (64 channels a
    block), as for a single prompt at din 8192 (128 blocks).  The kernel's
    launcher takes a tile of TT_WAVE steps, or of 1 at decode (S = 1)."""
    N = STATE_SIZES[0]
    for ns in LANE_STATES:
        ch = THREADS * ns // N
        if din % ch == 0 and Bt * (din // ch) >= sms * 7 // 8:
            break
    return ns


def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def token_rows(t: torch.Tensor, name: str, shape, dtype) -> int:
    """The element stride between consecutive tokens of a [Bt, S, n] view
    whose rows the fused kernel reads in place: contiguous within a row,
    one stride between rows, each row on a 16-byte boundary (its cp.async
    vectors); raises on anything else."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    Bt, S, _ = shape
    row = t.stride(1) if S > 1 else t.stride(0)
    if t.stride(2) != 1 or (Bt > 1 and t.stride(0) != S * row):
        raise ValueError(f"{name} must be rows of contiguous values at one "
                         f"token stride, got strides {t.stride()}")
    if (row * t.element_size()) % 16 or t.data_ptr() % 16:
        raise ValueError(f"{name}: its rows must start on 16-byte "
                         f"boundaries (token stride {row}, address "
                         f"{t.data_ptr():#x})")
    return row


class _Launcher:
    """Lazily bound C entry point of ``libtime_scan``."""

    def __init__(self, symbol: str, argtypes):
        self._symbol, self._argtypes = symbol, argtypes
        self._fn = None

    def __call__(self, *args) -> int:
        if self._fn is None:
            fn = getattr(build.load("time_scan"), self._symbol)
            fn.argtypes = self._argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn(*args)


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


class Counter:
    """A backward kernel's launch count, listed in ``ops.KERNELS`` beside
    the forward wrappers."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _require_grad_in(t: Optional[torch.Tensor], name: str, shape,
                     dev) -> None:
    """An incoming gradient: None, or a contiguous f32 CUDA tensor of the
    output's shape on ``dev``."""
    if t is None:
        return
    build.require(t, name, dtype=torch.float32, ndim=len(shape), device=dev)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


_COUNTERS: Dict[Tuple, torch.Tensor] = {}


def counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` int32 arrival counters of ``selective_scan_bwd`` for
    ``device`` and its current stream, zeroed when allocated and kept (the
    block that arrives last resets its counter, so every launch leaves
    them at zero; launches on one stream run in order, another stream gets
    its own).  Grown, zeroed again, when a launch needs more."""
    key = (device, build.stream_of(device))
    have = _COUNTERS.get(key)
    if have is None or have.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("selective_scan_bwd: its counters for this "
                               "stream must be allocated before a CUDA-graph "
                               "capture (run one call on the stream first)")
        _COUNTERS[key] = have = torch.zeros(max(n, 4096), dtype=torch.int32,
                                            device=device)
    return have


def bwd_scratch_sizes(Bt: int, S: int, din: int, N: int
                      ) -> Tuple[int, int]:
    """The backward's scratch: floats of its partial sums (each block's gC,
    gB of each tile, then each sequence's gA, g_dt_bias and gD of each
    channel) and its arrival counters (one a (sequence, group of BWD_GROUP
    tiles), then one a block column)."""
    nblk, nt = din // BWD_CHANNELS, tiles(S)
    return (Bt * nt * nblk * TT_WAVE * 2 * N + Bt * din * BWD_PART_A,
            Bt * -(-nt // BWD_GROUP) + nblk)


def _bwd_scratch(Bt: int, S: int, din: int, N: int, dev
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    floats, n = bwd_scratch_sizes(Bt, S, din, N)
    return (torch.empty(floats, dtype=torch.float32, device=dev),
            counters(dev, n))


def _checkpoints(Bt: int, S: int, din: int, N: int, dev) -> torch.Tensor:
    return torch.empty((Bt, tiles(S), din, N), dtype=torch.float32,
                       device=dev)


class SelectiveScan:
    """Callable kernel wrapper of the Mamba-1 selective scan (the scan
    alone) with ``fused``, the mixer core around it; ``launches`` counts
    the kernel launches of both, ``bwd.launches`` those of the backward
    kernel's scan-alone entry (``backward``) and ``fused_bwd.launches``
    those of its fused entry (``fused_backward``)."""

    name = "selective_scan"

    def __init__(self):
        self.launches = 0
        self._launch = _Launcher("selective_scan_launch",
                                 [_P] * 9 + [_I] * 5 + [_P])
        self._launch_fused = _Launcher("selective_scan_fused_launch",
                                       [_P] * 13 + [_L] * 3 + [_I] * 6
                                       + [_P])
        self.bwd = Counter("selective_scan_bwd")
        self.fused_bwd = Counter("selective_scan_bwd[fused]")
        self._launch_bwd = _Launcher("selective_scan_bwd_launch",
                                     [_P] * 17 + [_I] * 4 + [_P])
        self._launch_fused_bwd = _Launcher("selective_scan_fused_bwd_launch",
                                           [_P] * 23 + [_L] * 3 + [_I] * 5
                                           + [_P])

    @staticmethod
    def _check_sizes(din: int, N: int) -> None:
        if N not in STATE_SIZES:
            raise ValueError(f"selective_scan has no instantiation for "
                             f"state size {N} (has {STATE_SIZES})")
        if din % CHANNEL_MULTIPLE:
            raise ValueError(f"selective_scan takes din a multiple of "
                             f"{CHANNEL_MULTIPLE}, got {din}")

    def _check_scan(self, dt, u, B, C, A, h0=None
                    ) -> Tuple[int, int, int, int]:
        """The scan alone's checks (forward and backward, which passes no
        h0): returns (Bt, S, din, N)."""
        dev = dt.device
        for t, name, nd in ((dt, "dt", 3), (u, "u", 3), (B, "B", 3),
                            (C, "C", 3), (A, "A", 2), (h0, "h0", 3)):
            if t is not None:
                build.require(t, name, dtype=torch.float32, ndim=nd,
                              device=dev)
        Bt, S, din = dt.shape
        N = A.shape[1]
        self._check_sizes(din, N)
        if (u.shape != dt.shape or B.shape != (Bt, S, N)
                or C.shape != B.shape or A.shape != (din, N)
                or (h0 is not None and h0.shape != (Bt, din, N))):
            raise ValueError(f"shapes dt {tuple(dt.shape)}, u "
                             f"{tuple(u.shape)}, B {tuple(B.shape)}, C "
                             f"{tuple(C.shape)}, A {tuple(A.shape)}"
                             + ("" if h0 is None else
                                f", h0 {tuple(h0.shape)}") + " do not fit")
        return Bt, S, din, N

    def __call__(self, dt: torch.Tensor, u: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, A: torch.Tensor, h0: torch.Tensor,
                 checkpoints: bool = False) -> Tuple[torch.Tensor, ...]:
        """dt, u [Bt, S, din]; B, C [Bt, S, N]; A [din, N]; h0 [Bt, din,
        N], all f32.  Returns (y [Bt, S, din], h_last [Bt, din, N]), and
        with ``checkpoints`` the state entering each staged tile, ck [Bt,
        tiles(S), din, N] (what ``backward`` recomputes from)."""
        dev = dt.device
        Bt, S, din, N = self._check_scan(dt, u, B, C, A, h0)
        y = torch.empty_like(dt)
        h_last = torch.empty_like(h0)
        ck = _checkpoints(Bt, S, din, N, dev) if checkpoints else None
        ns = plan(Bt, din, _sms(dev))
        err = self._launch(dt.data_ptr(), u.data_ptr(), B.data_ptr(),
                           C.data_ptr(), A.data_ptr(), h0.data_ptr(),
                           y.data_ptr(), h_last.data_ptr(), _ptr(ck), Bt, S,
                           din, N, ns, build.stream_of(dev))
        build.check_launch(self.name, err)
        self.launches += 1
        return (y, h_last) if ck is None else (y, h_last, ck)

    def _check_bwd(self, Bt: int, S: int, din: int, N: int, ck, dev
                   ) -> None:
        if din % BWD_CHANNELS:
            raise ValueError(f"selective_scan_bwd takes din a multiple of "
                             f"{BWD_CHANNELS}, got {din}")
        _require_grad_in(ck, "ck", (Bt, tiles(S), din, N), dev)

    def backward(self, dt: torch.Tensor, u: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, A: torch.Tensor, ck: torch.Tensor,
                 gy: torch.Tensor, g_hlast: Optional[torch.Tensor] = None,
                 h_end: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, ...]:
        """The scan alone's backward (``ref.selective_scan_bwd_ref`` from
        h0 = ck[:, 0]), one launch of ``selective_scan_bwd``: the forward's
        inputs as ``__call__`` takes them but its checkpoints ck in place
        of h0, gy [Bt, S, din] and g_hlast [Bt, din, N] (or None: zero),
        f32.  Returns (gdt, gu, gB, gC, gA, gh0).  ``h_end`` (or None), a
        [Bt, tiles(S), din, N] f32 tensor, receives the recomputed state at
        the end of each tile."""
        dev = dt.device
        Bt, S, din, N = self._check_scan(dt, u, B, C, A)
        self._check_bwd(Bt, S, din, N, ck, dev)
        _require_grad_in(gy, "gy", (Bt, S, din), dev)
        _require_grad_in(g_hlast, "g_hlast", (Bt, din, N), dev)
        _require_grad_in(h_end, "h_end", tuple(ck.shape), dev)
        gdt, gu = torch.empty_like(dt), torch.empty_like(u)
        gB, gC = torch.empty_like(B), torch.empty_like(C)
        gA = torch.empty_like(A)
        gh0 = torch.empty((Bt, din, N), dtype=torch.float32, device=dev)
        part, ctr = _bwd_scratch(Bt, S, din, N, dev)
        err = self._launch_bwd(
            dt.data_ptr(), u.data_ptr(), B.data_ptr(), C.data_ptr(),
            A.data_ptr(), ck.data_ptr(), gy.data_ptr(), _ptr(g_hlast),
            gdt.data_ptr(), gu.data_ptr(), gB.data_ptr(), gC.data_ptr(),
            gA.data_ptr(), gh0.data_ptr(), part.data_ptr(), ctr.data_ptr(),
            _ptr(h_end), Bt, S, din, N, build.stream_of(dev))
        build.check_launch(self.bwd.name, err)
        self.bwd.launches += 1
        return gdt, gu, gB, gC, gA, gh0

    def _check_fused(self, dt_lin, dt_bias, xc, B, C, z, A_log, D, h0=None
                     ) -> Tuple[int, int, int, int, int, int, int]:
        """The fused entry's checks (forward and backward, which passes no
        h0): returns (Bt, S, din, N, b_row, c_row, z_row)."""
        dev = xc.device
        act = xc.dtype
        if act not in (torch.float32, torch.bfloat16):
            raise TypeError(f"selective_scan takes float32 or bfloat16 "
                            f"activations, got {act}")
        for t, name in ((dt_lin, "dt_lin"), (xc, "xc")):
            build.require(t, name, dtype=act, ndim=3, device=dev)
        Bt, S, din = xc.shape
        N = A_log.shape[-1]
        self._check_sizes(din, N)
        for t, name, shape in ((dt_bias, "dt_bias", (din,)), (D, "D", (din,)),
                               (A_log, "A_log", (din, N)),
                               (h0, "h0", (Bt, din, N))):
            if t is None:
                continue
            build.require(t, name, dtype=torch.float32, ndim=len(shape),
                          device=dev)
            if tuple(t.shape) != shape:
                raise ValueError(f"{name} must have shape {shape}, got "
                                 f"{tuple(t.shape)}")
        if dt_lin.shape != xc.shape:
            raise ValueError(f"dt_lin {tuple(dt_lin.shape)} and xc "
                             f"{tuple(xc.shape)} differ")
        for t, name in ((B, "B"), (C, "C"), (z, "z")):
            if not t.is_cuda or t.device != dev:
                raise ValueError(f"{name} must be a CUDA tensor on {dev}, "
                                 f"got {t.device}")
        return (Bt, S, din, N, token_rows(B, "B", (Bt, S, N), act),
                token_rows(C, "C", (Bt, S, N), act),
                token_rows(z, "z", (Bt, S, din), act))

    def fused(self, dt_lin: torch.Tensor, dt_bias: torch.Tensor,
              xc: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
              z: torch.Tensor, A_log: torch.Tensor, D: torch.Tensor,
              h0: torch.Tensor, mask: Optional[torch.Tensor] = None,
              checkpoints: bool = False) -> Tuple[torch.Tensor, ...]:
        """The Mamba-1 mixer core after its two matmuls (``ref.
        ssm_scan_ref``), one launch: dt_lin, xc [Bt, S, din] contiguous,
        f32 or bf16; B, C [Bt, S, N] and z [Bt, S, din] in that dtype, read
        in place as rows at one token stride (the column views of x_proj's
        and in_proj's outputs); dt_bias, D [din], A_log [din, N], h0 [Bt,
        din, N] f32; mask [Bt, S] bool or None.  Returns (the gated y [Bt,
        S, din] in xc's dtype, h_last [Bt, din, N] f32), and with
        ``checkpoints`` ck as ``__call__`` gives it."""
        dev = xc.device
        Bt, S, din, N, b_row, c_row, z_row = self._check_fused(
            dt_lin, dt_bias, xc, B, C, z, A_log, D, h0)
        if mask is not None:
            build.require(mask, "mask", dtype=torch.bool, ndim=2, device=dev)
            if tuple(mask.shape) != (Bt, S):
                raise ValueError(f"mask must have shape {(Bt, S)}, got "
                                 f"{tuple(mask.shape)}")
        y = torch.empty_like(xc)
        h_last = torch.empty_like(h0)
        ck = _checkpoints(Bt, S, din, N, dev) if checkpoints else None
        ns = plan(Bt, din, _sms(dev))
        err = self._launch_fused(
            dt_lin.data_ptr(), dt_bias.data_ptr(), xc.data_ptr(),
            B.data_ptr(), C.data_ptr(), z.data_ptr(), A_log.data_ptr(),
            D.data_ptr(), h0.data_ptr(),
            None if mask is None else mask.data_ptr(), y.data_ptr(),
            h_last.data_ptr(), _ptr(ck), b_row, c_row, z_row, Bt, S, din, N,
            ns, build.dtype_code(xc), build.stream_of(dev))
        build.check_launch(self.name, err)
        self.launches += 1
        return (y, h_last) if ck is None else (y, h_last, ck)

    def fused_backward(self, dt_lin: torch.Tensor, dt_bias: torch.Tensor,
                       xc: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                       z: torch.Tensor, A_log: torch.Tensor, D: torch.Tensor,
                       ck: torch.Tensor, g_out: torch.Tensor,
                       g_hlast: Optional[torch.Tensor] = None,
                       h_end: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, ...]:
        """The fused mixer core's backward (``ref.ssm_scan_bwd_ref`` from
        h0 = ck[:, 0]), one launch of ``selective_scan_bwd``: the forward's
        inputs as ``fused`` takes them (no mask) but its checkpoints ck in
        place of h0, g_out [Bt, S, din] contiguous in xc's dtype (the gated
        output's gradient) and g_hlast [Bt, din, N] f32 (or None: zero).
        Returns the gradients of (dt_lin, dt_bias, xc, B, C, z, A_log, D,
        h0): those of the activations in xc's dtype, contiguous (B's, C's
        and z's of their [Bt, S, n] shapes), the rest f32.  ``h_end`` as in
        ``backward``."""
        dev = xc.device
        act = xc.dtype
        Bt, S, din, N, b_row, c_row, z_row = self._check_fused(
            dt_lin, dt_bias, xc, B, C, z, A_log, D)
        self._check_bwd(Bt, S, din, N, ck, dev)
        build.require(g_out, "g_out", dtype=act, ndim=3, device=dev)
        if g_out.shape != xc.shape:
            raise ValueError(f"g_out {tuple(g_out.shape)} and xc "
                             f"{tuple(xc.shape)} differ")
        _require_grad_in(g_hlast, "g_hlast", (Bt, din, N), dev)
        _require_grad_in(h_end, "h_end", tuple(ck.shape), dev)
        g_dt_lin, g_xc, gz = (torch.empty_like(xc) for _ in range(3))
        gB = torch.empty((Bt, S, N), dtype=act, device=dev)
        gC = torch.empty_like(gB)
        g_dt_bias, gD = torch.empty_like(dt_bias), torch.empty_like(D)
        g_A_log = torch.empty_like(A_log)
        gh0 = torch.empty((Bt, din, N), dtype=torch.float32, device=dev)
        part, ctr = _bwd_scratch(Bt, S, din, N, dev)
        err = self._launch_fused_bwd(
            dt_lin.data_ptr(), dt_bias.data_ptr(), xc.data_ptr(),
            B.data_ptr(), C.data_ptr(), z.data_ptr(), A_log.data_ptr(),
            D.data_ptr(), ck.data_ptr(), g_out.data_ptr(), _ptr(g_hlast),
            g_dt_lin.data_ptr(), g_dt_bias.data_ptr(), g_xc.data_ptr(),
            gB.data_ptr(), gC.data_ptr(), gz.data_ptr(), g_A_log.data_ptr(),
            gD.data_ptr(), gh0.data_ptr(), part.data_ptr(), ctr.data_ptr(),
            _ptr(h_end), b_row, c_row, z_row, Bt, S, din, N,
            build.dtype_code(xc), build.stream_of(dev))
        build.check_launch(self.fused_bwd.name, err)
        self.fused_bwd.launches += 1
        return (g_dt_lin, g_dt_bias, g_xc, gB, gC, gz, g_A_log, gD, gh0)


class LinearScan:
    """Callable kernel wrapper; ``launches`` counts kernel launches."""

    name = "linear_scan"

    def __init__(self):
        self.launches = 0
        self._launch = _Launcher("linear_scan_launch",
                                 [_P] * 5 + [_I] * 3 + [_P])
        self.bwd = Counter("linear_scan_bwd")
        self._launch_bwd = _Launcher("linear_scan_bwd_launch",
                                     [_P] * 8 + [_I] * 3 + [_P])

    @staticmethod
    def _check(a, g, h0) -> Tuple[int, int, int]:
        dev = a.device
        for t, name, nd in ((a, "a", 3), (g, "g", 3), (h0, "h0", 2)):
            build.require(t, name, dtype=torch.float32, ndim=nd, device=dev)
        Bt, S, w = a.shape
        if g.shape != a.shape or h0.shape != (Bt, w):
            raise ValueError(f"shapes a {tuple(a.shape)}, g "
                             f"{tuple(g.shape)}, h0 {tuple(h0.shape)} do "
                             "not fit")
        return Bt, S, w

    def __call__(self, a: torch.Tensor, g: torch.Tensor, h0: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """a, g [Bt, S, w]; h0 [Bt, w], all f32.  Returns (hs [Bt, S, w],
        h_last [Bt, w])."""
        dev = a.device
        Bt, S, w = self._check(a, g, h0)
        hs = torch.empty_like(a)
        h_last = torch.empty_like(h0)
        err = self._launch(a.data_ptr(), g.data_ptr(), h0.data_ptr(),
                           hs.data_ptr(), h_last.data_ptr(), Bt, S, w,
                           build.stream_of(dev))
        build.check_launch(self.name, err)
        self.launches += 1
        return hs, h_last


    def backward(self, a: torch.Tensor, hs: torch.Tensor, h0: torch.Tensor,
                 ghs: torch.Tensor, g_hlast: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The recurrence's backward (``ref.linear_scan_bwd_ref``), one
        launch of ``linear_scan_bwd``: a, hs (the forward's output), ghs
        [Bt, S, w]; h0 and g_hlast (or None: zero) [Bt, w], all f32.
        Returns (ga, gg, gh0)."""
        dev = a.device
        Bt, S, w = self._check(a, hs, h0)
        _require_grad_in(ghs, "ghs", (Bt, S, w), dev)
        _require_grad_in(g_hlast, "g_hlast", (Bt, w), dev)
        ga, gg = torch.empty_like(a), torch.empty_like(a)
        gh0 = torch.empty_like(h0)
        err = self._launch_bwd(a.data_ptr(), hs.data_ptr(), h0.data_ptr(),
                               ghs.data_ptr(), _ptr(g_hlast), ga.data_ptr(),
                               gg.data_ptr(), gh0.data_ptr(), Bt, S, w,
                               build.stream_of(dev))
        build.check_launch(self.bwd.name, err)
        self.bwd.launches += 1
        return ga, gg, gh0


selective_scan = SelectiveScan()
linear_scan = LinearScan()


def _grad_or_zeros(g: Optional[torch.Tensor], like: torch.Tensor
                   ) -> torch.Tensor:
    return torch.zeros_like(like) if g is None else g.contiguous()


class LinearScanFn(torch.autograd.Function):
    """``linear_scan`` under autograd on the card: the forward kernel, and
    in the backward one launch of ``linear_scan_bwd`` on the saved a, hs
    and h0.  There is no plain backward on this path."""

    @staticmethod
    def forward(ctx, a, g, h0):
        hs, h_last = linear_scan(a, g, h0)
        ctx.save_for_backward(a, hs, h0)
        ctx.set_materialize_grads(False)
        return hs, h_last

    @staticmethod
    def backward(ctx, ghs, g_hlast):
        a, hs, h0 = ctx.saved_tensors
        ga, gg, gh0 = linear_scan.backward(
            a, hs, h0, _grad_or_zeros(ghs, hs),
            None if g_hlast is None else g_hlast.contiguous())
        return ga, gg, gh0


class SelectiveScanFn(torch.autograd.Function):
    """The scan alone (``selective_scan``) under autograd on the card: the
    forward kernel, storing its checkpoints, and in the backward one
    launch of ``selective_scan_bwd`` on the saved dt, u, B, C, A and
    checkpoints.  There is no plain backward on this path."""

    @staticmethod
    def forward(ctx, dt, u, B, C, A, h0):
        y, h_last, ck = selective_scan(dt, u, B, C, A, h0, checkpoints=True)
        ctx.save_for_backward(dt, u, B, C, A, ck)
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, gy, g_hlast):
        dt, u, B, C, A, ck = ctx.saved_tensors
        return selective_scan.backward(
            dt, u, B, C, A, ck, _grad_or_zeros(gy, dt),
            None if g_hlast is None else g_hlast.contiguous())


class SsmScanFn(torch.autograd.Function):
    """The fused Mamba-1 mixer core (``selective_scan.fused``) under
    autograd on the card, the trainer's path: the forward kernel, storing
    its checkpoints, and in the backward one launch of the fused
    ``selective_scan_bwd`` on the saved inputs and checkpoints (the
    softplus', D skip's and gate's derivatives in the kernel).  There is
    no plain backward and no torch composition on this path."""

    @staticmethod
    def forward(ctx, dt_lin, dt_bias, xc, B, C, z, A_log, D, h0):
        y, h_last, ck = selective_scan.fused(dt_lin, dt_bias, xc, B, C, z,
                                             A_log, D, h0, checkpoints=True)
        ctx.save_for_backward(dt_lin, dt_bias, xc, B, C, z, A_log, D, ck)
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, g_out, g_hlast):
        dt_lin, dt_bias, xc, B, C, z, A_log, D, ck = ctx.saved_tensors
        return selective_scan.fused_backward(
            dt_lin, dt_bias, xc, B, C, z, A_log, D, ck,
            _grad_or_zeros(g_out, xc),
            None if g_hlast is None else g_hlast.contiguous())
