"""The Mamba-1 backward kernel (``selective_scan_bwd`` in
``csrc/time_scan.cu``), its checkpoint schedule and its wrapper on the
CPU.

* The checkpoint schedule: the forward stores the state entering each of
  its TT_WAVE-step tiles, and a backward that recomputes each tile from
  its checkpoint, walking the tiles from the last, gives
  ``selective_scan_bwd_ref``'s result bit for bit in f32.
* The recompute: the backward's halved form h = fma(ex2(dt A log2(e) + 1)
  / 2, h, dt u B) from the checkpoints equals the forward kernel's scaled
  tile arithmetic (state kept times 2^(tt + 1), unscaled at the tile's
  end) at every step, bit for bit: what ``chip_smoke.py`` checks on the
  card through the kernel's ``h_end``.
* The kernel's arithmetic order (its exponential, 4 states a lane, its
  FMAs, each lane's sums added pairwise) stays within ``chip_smoke.py``'s
  1e-4 of each output's RMS of ``selective_scan_bwd_ref`` over ragged rows
  at the dt softplus gives.
* The fused entry's plain version in bf16 (``ssm_scan_bwd_ref``: an f32
  chain, the outputs rounded once; the card's yardstick) against bf16
  autograd of the plain composition, which rounds every intermediate
  gradient: the gap between the yardstick and the second witness
  ``chip_smoke.py`` records beside it.
* The source's constants and scratch layout against the wrapper's, and
  the wrapper's refusals.

The CUDA kernel itself runs only on the card, where ``chip_smoke.py``
holds both of its entries against their plain versions.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref, time_scan
from repro_torch.kernels.time_scan import selective_scan


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Run this file on one torch intra-op thread (ROADMAP C13, C15)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SOURCE = (Path(time_scan.__file__).parent / "csrc" / "time_scan.cu"
          ).read_text()
TT = time_scan.TT_WAVE
SCAN_BWD_REL_TOL = 1e-4       # chip_smoke.py's limit for the f32 backward
LOG2E = np.float32(1.4426950408889634)


def _fma(a, b, c):
    """fmaf in f32: the exact a * b + c (f64 holds the product of two f32
    exactly), rounded to f32."""
    return (a.double() * b.double() + c.double()).float()


def _inputs(Bt=3, S=70, din=8, N=16, seed=0, ragged=True):
    """dt from a softplus over falcon-mamba's init (dt_bias drawn
    log-uniform in [0.001, 0.1], dt_lin ~ N(0, 0.5)), A = -(1 .. N), rows
    past their lengths masked (dt = 0, u = 0, gy = 0), a random h0 and
    random cotangents of y and h_last."""
    rng = np.random.default_rng(seed)
    lo, hi = math.log(0.001), math.log(0.1)
    bias = np.log(np.expm1(np.exp(rng.random(din) * (hi - lo) + lo)))
    lin = rng.normal(scale=0.5, size=(Bt, S, din))
    dt = torch.from_numpy(np.log1p(np.exp(lin + bias)).astype(np.float32))
    lens = np.array([S, S * 2 // 3, 5][:Bt]) if ragged else np.full(Bt, S)
    mask = torch.from_numpy(np.arange(S)[None] < lens[:, None])[..., None]
    f = lambda *shape: torch.from_numpy(
        rng.normal(size=shape).astype(np.float32))
    u, gy = f(Bt, S, din) * mask, f(Bt, S, din) * mask
    B, C = f(Bt, S, N), f(Bt, S, N)
    A = -torch.arange(1, N + 1, dtype=torch.float32).repeat(din, 1)
    return dt * mask, u, B, C, A, f(Bt, din, N), gy, f(Bt, din, N)


def _tiled_bwd(dt, u, B, C, A, ck, gy, g_hlast):
    """``selective_scan_bwd_ref``'s arithmetic on the kernel's schedule:
    the tiles from the last, each tile's states recomputed from its
    checkpoint ck[:, k], then the tile's steps walked back."""
    S = dt.shape[1]
    lam = g_hlast
    gdt, gu = torch.empty_like(dt), torch.empty_like(u)
    gB, gC = torch.empty_like(B), torch.empty_like(C)
    gA = torch.zeros_like(A)
    for k in range(ck.shape[1] - 1, -1, -1):
        t0, t1 = k * TT, min(S, (k + 1) * TT)
        hs = [ck[:, k]]
        for t in range(t0, t1):
            da = torch.exp(dt[:, t, :, None] * A[None])
            hs.append(da * hs[-1] + (dt[:, t] * u[:, t])[..., None]
                      * B[:, t, None, :])
        for t in range(t1 - 1, t0 - 1, -1):
            da = torch.exp(dt[:, t, :, None] * A[None])
            hp = hs[t - t0]
            lam = lam + gy[:, t, :, None] * C[:, t, None, :]
            dtu = dt[:, t] * u[:, t]
            gC[:, t] = torch.einsum("bd,bdn->bn", gy[:, t], hs[t - t0 + 1])
            gB[:, t] = torch.einsum("bdn,bd->bn", lam, dtu)
            sb = torch.einsum("bdn,bn->bd", lam, B[:, t])
            gu[:, t] = dt[:, t] * sb
            q = lam * da * hp
            gdt[:, t] = (q * A[None]).sum(-1) + u[:, t] * sb
            gA = gA + (q * dt[:, t, :, None]).sum(0)
            lam = da * lam
    return gdt, gu, gB, gC, gA, lam


@pytest.mark.parametrize("S", [1, 16, 37, 50])
def test_checkpoint_schedule_gives_the_plain_backward_bitwise(S):
    """Recomputing each tile from the forward's every-TT-step states gives
    ``selective_scan_bwd_ref`` (which recomputes from h0) bit for bit in
    f32, ragged last tile and all."""
    dt, u, B, C, A, h0, gy, ghl = _inputs(S=S)
    ck = ref.scan_checkpoints(dt, u, B, A, h0, TT)
    assert ck.shape == (3, time_scan.tiles(S), 8, 16)
    assert torch.equal(ck[:, 0], h0)
    got = _tiled_bwd(dt, u, B, C, A, ck, gy, ghl)
    want = ref.selective_scan_bwd_ref(dt, u, B, C, A, h0, gy, ghl)
    for name, g, w in zip(("gdt", "gu", "gB", "gC", "gA", "gh0"), got, want):
        assert torch.equal(g, w), name


def _decay_half(dt, a2):
    """The backward's decay: ex2(fma(dt, A log2(e), 1)) / 2."""
    return torch.exp2(_fma(dt, a2, torch.ones_like(dt))) * 0.5


def test_halved_recompute_is_the_forward_bitwise():
    """The forward kernel keeps a tile's state scaled by 2^(tt + 1) (its
    decay ex2(x + 1) unhalved, dt u scaled by 2^(tt + 1), the state scaled
    back by 2^-nt at the tile's end) and stores the state entering each
    tile; the backward recomputes each tile from that checkpoint in the
    halved form.  Every step's state and every tile's end (the next
    checkpoint, h_last) are the same bits."""
    dt, u, B, _, A, h0, _, _ = _inputs(Bt=2, S=45, din=16)
    a2 = (A * torch.tensor(LOG2E))[None].expand_as(h0)
    ones = torch.ones_like(h0)
    h, ck, fwd = h0.clone(), [], []
    for t in range(dt.shape[1]):                    # the forward kernel
        tt = t % TT
        if tt == 0:
            ck.append(h.clone())
        e = torch.exp2(_fma(dt[:, t, :, None].expand_as(h0), a2, ones))
        dxs = (dt[:, t] * u[:, t]) * 2.0 ** (tt + 1)
        h = _fma(e, h, dxs[..., None] * B[:, t, None, :])
        fwd.append(h * 2.0 ** -(tt + 1))
        if tt == TT - 1 or t == dt.shape[1] - 1:
            h = h * 2.0 ** -(tt + 1)
    h_last = h
    for k in range(len(ck)):                        # the backward's recompute
        hb = ck[k].clone()
        for t in range(k * TT, min(dt.shape[1], (k + 1) * TT)):
            e = _decay_half(dt[:, t, :, None].expand_as(h0), a2)
            hb = _fma(e, hb, ((dt[:, t] * u[:, t])[..., None]
                              * B[:, t, None, :]))
            assert torch.equal(hb, fwd[t]), t
        assert torch.equal(hb, ck[k + 1] if k + 1 < len(ck) else h_last)


def _kernel_order_bwd(dt, u, B, C, A, h0, gy, g_hlast, ns=4):
    """The backward in the kernel's arithmetic order: the recompute and the
    step back with the decay ex2(fma(dt, A log2(e), 1)) / 2, FMAs as the
    kernel's, lambda e formed once, each lane's sum_n lambda B and sum_n A
    q an FMA chain over its ns states and the lanes' sums added pairwise
    (sums over channels in torch's order)."""
    Bt, S, din = dt.shape
    N = A.shape[1]
    lanes = N // ns
    a2 = (A * torch.tensor(LOG2E))[None].expand(Bt, din, N)
    Ae = A[None].expand(Bt, din, N)
    ones = torch.ones(Bt, din, N)
    hs = [h0]
    for t in range(S):
        e = _decay_half(dt[:, t, :, None].expand(Bt, din, N), a2)
        dx = dt[:, t] * u[:, t]
        hs.append(_fma(e, hs[-1], dx[..., None] * B[:, t, None, :]))
    lam = g_hlast.clone()
    gA = torch.zeros(Bt, din, N)
    gdt, gu = torch.empty_like(dt), torch.empty_like(u)
    gB, gC = torch.empty_like(B), torch.empty_like(C)

    def lane_sums(x, y, acc0):       # sum_n x y: chains, then pairwise
        xr, yr = (v.reshape(Bt, din, lanes, ns) for v in (x, y))
        acc = xr[..., 0] * yr[..., 0] if acc0 is None else acc0
        for j in range(0 if acc0 is not None else 1, ns):
            acc = _fma(xr[..., j], yr[..., j], acc)
        m = 1
        while m < lanes:
            acc = acc.clone()
            idx = torch.arange(0, lanes, 2 * m)
            acc[..., idx] = acc[..., idx] + acc[..., idx + m]
            m *= 2
        return acc[..., 0]

    for t in range(S - 1, -1, -1):
        dtv = dt[:, t, :, None].expand(Bt, din, N)
        e = _decay_half(dtv, a2)
        g = gy[:, t, :, None].expand(Bt, din, N)
        dx = (dt[:, t] * u[:, t])[..., None].expand(Bt, din, N)
        lam = _fma(g, C[:, t, None, :].expand(Bt, din, N), lam)
        gC[:, t] = (g * hs[t + 1]).sum(1)
        gB[:, t] = (lam * dx).sum(1)
        le = lam * e
        q = le * hs[t]
        zero = torch.zeros(Bt, din, lanes)
        sb = lane_sums(lam, B[:, t, None, :].expand(Bt, din, N), zero)
        sq = lane_sums(Ae, q, zero)
        gA = _fma(dtv, q, gA)
        lam = le
        gu[:, t] = dt[:, t] * sb
        gdt[:, t] = _fma(u[:, t], sb, sq)
    del ones
    return gdt, gu, gB, gC, gA.sum(0), lam


def _rel(got, want):
    return ((got.double() - want.double()).abs().max()
            / want.double().pow(2).mean().sqrt()).item()


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_order_within_scan_bwd_tolerance(seed):
    """The kernel's order (its exponential, 4-state lanes, FMAs, lambda e
    formed once, pairwise lane sums) stays within chip_smoke's 1e-4 of each
    output's RMS of ``selective_scan_bwd_ref`` over ragged rows from a
    random state."""
    args = _inputs(S=150, din=16, seed=seed)
    got = _kernel_order_bwd(*args)
    want = ref.selective_scan_bwd_ref(*args)
    for name, g, w in zip(("gdt", "gu", "gB", "gC", "gA", "gh0"), got, want):
        assert _rel(g, w) <= SCAN_BWD_REL_TOL, name


def _core_inputs(dtype, S=40, Bt=2, din=16, N=16, seed=3):
    """The fused core's inputs as the trainer forms them in ``dtype``: B, C
    columns of one x_proj-like output, z a column view of in_proj's."""
    rng = np.random.default_rng(seed)
    f = lambda *shape, scale=1.0: torch.from_numpy(
        rng.normal(scale=scale, size=shape).astype(np.float32))
    lo, hi = math.log(0.001), math.log(0.1)
    bias = torch.from_numpy(np.log(np.expm1(np.exp(
        rng.random(din) * (hi - lo) + lo))).astype(np.float32))
    dbc = f(Bt, S, 8 + 2 * N).to(dtype)
    xz = f(Bt, S, 2 * din).to(dtype)
    A_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32)
                      .repeat(din, 1))
    return (f(Bt, S, din, scale=0.5).to(dtype), bias,
            f(Bt, S, din).to(dtype), dbc[..., 8:8 + N], dbc[..., 8 + N:],
            xz[..., din:], A_log, torch.ones(din) + f(din, scale=0.1),
            f(Bt, din, N)), (f(Bt, S, din).to(dtype), f(Bt, din, N))


def test_bf16_plain_backward_against_bf16_autograd():
    """In bf16 the fused backward's yardstick (an f32 chain whose outputs
    round once; the card holds the kernel to it at FUSED_BWD_BF16_TOL,
    0.15 of each output's RMS) and the plain composition's autograd (each
    intermediate gradient rounded to bf16, then cast; the card records it
    as a second witness) part by more than f32's limit and by at most
    0.25 of each output's RMS at this size; in f32 the two are one
    computation (1e-5)."""
    for dtype, limit, floor in ((torch.bfloat16, 0.25, 1e-4),
                                (torch.float32, 1e-5, 0.0)):
        args, (g_out, ghl) = _core_inputs(dtype)
        ins = [a.detach().clone().requires_grad_(True) for a in args]
        y, h = ref.ssm_scan_ref(*ins)
        want = torch.autograd.grad((y, h), ins, (g_out, ghl))
        got = ref.ssm_scan_bwd_ref(*args, g_out, ghl)
        rels = [_rel(g, w) for g, w in zip(got, want)]
        assert max(rels) <= limit, (dtype, rels)
        assert max(rels) >= floor, (dtype, rels)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape


def test_source_constants_match_the_wrapper():
    """The backward's states a lane, threads, channels a block, tile (the
    forward's), per-sequence partial width and arrival group are the
    wrapper's; the forward stores the unscaled state entering each tile;
    the entry points place the per-sequence partials after the per-tile
    ones as ``bwd_scratch_sizes`` counts them; the backward's device
    function keeps the name the launch accounting reads."""
    const = {k: v for k, v in re.findall(r"constexpr int (\w+) = (\w+);",
                                         SOURCE)}
    assert const["BWD_NS"] == str(time_scan.BWD_STATES)
    assert const["BWD_THREADS"] == str(time_scan.BWD_THREADS)
    assert const["BWD_TT"] == "TT_WAVE"
    assert const["BWD_GROUP"] == str(time_scan.BWD_GROUP)
    assert time_scan.BWD_THREADS * time_scan.BWD_STATES // 16 \
        == time_scan.BWD_CHANNELS
    assert "constexpr int BWD_CH = BWD_THREADS / BWD_LANES;" in SOURCE
    assert "constexpr int BWD_LANES = N_STATE / BWD_NS;" in SOURCE
    assert "constexpr int BWD_PART_A = N_STATE + 4;" in SOURCE
    assert time_scan.BWD_PART_A == 16 + 4
    assert "if (p.ck != nullptr)        // the state entering tile k" in SOURCE
    assert SOURCE.count(
        "part + Bt * tiles * din * BWD_TT * 2 * N_STATE / BWD_CH") == 2
    assert "selective_scan_bwd_kernel(const BwdArgs p)" in SOURCE
    assert "return ex2_approx(fmaf(dt, a2, 1.f)) * 0.5f;" in SOURCE
    for Bt, S, din in ((8, 512, 8192), (8, 333, 8192), (1, 1, 64)):
        floats, n = time_scan.bwd_scratch_sizes(Bt, S, din, 16)
        nt, nblk = -(-S // TT), din // time_scan.BWD_CHANNELS
        assert floats == Bt * nt * din * TT * 2 * 16 // \
            time_scan.BWD_CHANNELS + Bt * din * 20
        assert n == Bt * -(-nt // time_scan.BWD_GROUP) + nblk


@pytest.mark.parametrize("S,tiles", [(0, 0), (1, 1), (16, 1), (17, 2),
                                     (512, 32), (333, 21)])
def test_tiles(S, tiles):
    assert time_scan.tiles(S) == tiles


def test_backward_wrappers_refuse_cpu_tensors():
    """Both backward entries launch on CUDA tensors or raise, and count no
    launch when they raise; each entry has a counter of its own."""
    dt, u, B, C, A, h0, gy, ghl = _inputs(Bt=2, S=5, din=64)
    ck = ref.scan_checkpoints(dt, u, B, A, h0, TT)
    counters = (selective_scan.bwd, selective_scan.fused_bwd)
    before = [k.launches for k in counters]
    with pytest.raises(ValueError, match="CUDA"):
        selective_scan.backward(dt, u, B, C, A, ck, gy, ghl)
    args, (g_out, _) = _core_inputs(torch.bfloat16, S=5, din=64)
    with pytest.raises(ValueError, match="CUDA"):
        selective_scan.fused_backward(*args[:8], ck, g_out, ghl)
    assert [k.launches for k in counters] == before
    assert selective_scan.fused_bwd.name == "selective_scan_bwd[fused]"


def test_planted_fault_and_variant_texts_occur_once():
    """Every text ``chip_faults.py`` plants a fault or an ablation in
    occurs exactly once in ``time_scan.cu``: an edit of the source that
    duplicates or drops one would make it refuse the copy on the card."""
    import sys
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_faults
    finally:
        sys.path.remove(str(root))
    texts = [old for _, old, *_ in chip_faults.SCAN_FAULTS]
    texts += [old for _, old, _ in chip_faults.SCAN_BWD_FAULTS]
    texts += [old for edits in chip_faults.SCAN_BWD_VARIANTS.values()
              for old, _ in edits]
    for old in texts:
        assert SOURCE.count(old) == 1, old
