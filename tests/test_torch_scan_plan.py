"""The Mamba-1 selective-scan kernel (``csrc/time_scan.cu``), its
host-side arithmetic and its fused entry's plain version on the CPU.

* ``ops.ssm_scan``'s plain version (``ref.ssm_scan_ref``), which
  ``models/ssm.py :: _ssm_inner`` now calls after its two projections,
  gives bit for bit what the torch composition it replaced gave (a copy of
  that composition lives here): bf16 and f32, masked and not, S = 1, 17
  and 300.
* The kernel's arithmetic order emulated in torch: a channel's states
  split over lanes of NS (8, 4), each step's decay exp2(dt A log2(e) +
  1) / 2 with the + 1 in an FMA, the state update and each lane's partial
  y as FMAs, the lanes' partials added pairwise in a fixed order; within
  1e-4 of the RMS of ``selective_scan_ref`` over ragged masks.
* The error a same-signed bias of the exponential adds over 1,024 steps
  at the dt that softplus gives (1, 2 and 4 ulps a factor): why the
  kernel feeds ex2.approx dt A log2(e) + 1 rather than the bare product,
  whose truncated fraction biases every factor of a slow state (the
  card's readings, chip_smoke.py, are what the kernel is held to).
* From a random state a long live row at a dt constant in time is below
  f32's resolution for that limit: the plain f32 scan is itself further
  than 1e-4 of the RMS from a float64 scan.
* The fused entry's bf16 prologue (softplus of dt_lin plus the bias, the
  mask) and epilogue (the D skip, the SiLU gate), emulated at the
  kernel's rounding points from the same f32 y, bitwise equal to the
  plain version.
* The wrapper: its lane plan at every shape ``chip_smoke.py`` runs, the
  constants it shares with the source, and its refusals (CPU tensors,
  dtypes, shapes, token strides it cannot read in place).

The CUDA kernel itself runs only on the card, where ``chip_smoke.py``
holds both entries against their plain versions.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs.registry import get_config, get_reduced
from repro_torch.kernels import ops, ref, time_scan
from repro_torch.kernels.time_scan import selective_scan
from repro_torch.models import ssm as S


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Run this file on one torch intra-op thread.  With torch's default
    of a thread per core in each of several test processes sharing the
    same cores, every small op waits at a barrier for threads the other
    processes hold, and the file runs several times slower (ROADMAP C13,
    C15)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SOURCE = (Path(time_scan.__file__).parent / "csrc" / "time_scan.cu"
          ).read_text()
SCAN_REL_TOL = 1e-4          # chip_smoke.py's limit for the f32 scans
LOG2E = np.float32(1.4426950408889634)
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _old_ssm_inner(cfg, p, xc, z, h0, mask=None):
    """``_ssm_inner`` as it was before the fused entry: the softplus, the
    mask, A, the scan in f32, the D skip and the gate in torch."""
    R, N = S.dt_rank(cfg), cfg.ssm_state
    dbc = xc @ p["x_proj"].to(xc.dtype)
    dt_r, b_ssm, c_ssm = dbc.split([R, N, N], dim=-1)
    dt = F.softplus(dt_r @ p["dt_proj"].to(xc.dtype)
                    + p["dt_bias"].to(xc.dtype)).float()
    if mask is not None:
        dt = torch.where(mask[..., None], dt, 0.0)
    A = -torch.exp(p["A_log"].float())
    y, h = ref.selective_scan_ref(dt.contiguous(), xc.float().contiguous(),
                                  b_ssm.float().contiguous(),
                                  c_ssm.float().contiguous(), A.contiguous(),
                                  h0.float().contiguous())
    y = y.to(xc.dtype) + xc * p["D"].to(xc.dtype)
    return y * F.silu(z), h


@pytest.fixture(scope="module")
def mamba_layer():
    """Reduced falcon-mamba-7b's mixer (din 128, state 4, dt rank 16) from
    the port's seeded init."""
    cfg = get_reduced("falcon-mamba-7b", dtype="float32")
    gen = torch.Generator().manual_seed(0)
    return cfg, S.ssm_init(gen, cfg)


def _inner_inputs(cfg, dtype, steps, seed=1):
    rng = np.random.default_rng(seed)
    Bt, din, N = 3, cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    xz = torch.from_numpy(rng.normal(size=(Bt, steps, 2 * din))
                          .astype(np.float32)).to(TDT[dtype])
    h0 = torch.from_numpy(rng.normal(size=(Bt, din, N)).astype(np.float32))
    lens = np.array([steps, max(steps // 2, 1), 1])
    mask = torch.from_numpy(np.arange(steps)[None] < lens[:, None])
    # xc as the conv hands it over (contiguous), z a column view of xz
    return xz[..., :din].contiguous(), xz[..., din:], h0, mask


@pytest.mark.parametrize("steps", [1, 17, 300])
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fused_plain_is_the_old_composition(mamba_layer, dtype, masked,
                                            steps):
    """``_ssm_inner`` through ``ops.ssm_scan`` on the CPU gives bit for
    bit what the composition it replaced gave."""
    cfg, p = mamba_layer
    xc, z, h0, mask = _inner_inputs(cfg, dtype, steps)
    m = mask if masked else None
    got = S._ssm_inner(cfg, p, xc, z, h0, mask=m)
    want = _old_ssm_inner(cfg, p, xc, z, h0, mask=m)
    assert got[0].dtype == TDT[dtype] and got[1].dtype == torch.float32
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _fma(a, b, c):
    """fmaf in f32: the exact a * b + c (f64 holds the product of two f32
    exactly), rounded once to f32."""
    return (a.double() * b.double() + c.double()).float()


def _exp_factor(dt, a2, ex2=torch.exp2):
    """The kernel's decay from dt [..] and A log2(e) [..]: ex2(fma(dt, a2,
    1)) / 2."""
    return ex2(_fma(dt, a2, torch.ones_like(dt))) * 0.5


def _kernel_order(dt, u, B, C, A, h0, ns, ex2=torch.exp2):
    """The selective scan in the kernel's arithmetic order: lanes of ns
    states, per state da = ex2(dt A log2(e) + 1) / 2 and h = fma(da, h,
    (dt u) B), a lane's partial y an fma chain over its states, the lanes'
    partials added pairwise in a fixed order."""
    Bt, Sq, din = dt.shape
    N = A.shape[1]
    lanes = N // ns
    a2 = (A * torch.tensor(LOG2E))                  # rounded once, as f32
    h = h0.clone()
    y = torch.empty_like(dt)
    for t in range(Sq):
        dtv = dt[:, t, :, None].expand(Bt, din, N)
        dx = (dt[:, t] * u[:, t])[..., None]
        da = _exp_factor(dtv, a2[None].expand(Bt, din, N), ex2)
        h = _fma(da, h, dx * B[:, t, None, :])
        hr = h.reshape(Bt, din, lanes, ns)
        cr = C[:, t, None, :].expand(Bt, din, N).reshape(Bt, din, lanes, ns)
        acc = hr[..., 0] * cr[..., 0]
        for j in range(1, ns):
            acc = _fma(hr[..., j], cr[..., j], acc)
        m = 1
        while m < lanes:
            idx = torch.arange(0, lanes, 2 * m)
            acc = acc.clone()
            acc[..., idx] = acc[..., idx] + acc[..., idx + m]
            m *= 2
        y[:, t] = acc[..., 0]
    return y, h


def test_scaled_state_is_the_halved_one_bitwise():
    """The kernel keeps a tile's state scaled by 2^(tt + 1) so that each
    step's decay is ex2(x + 1) itself, not ex2(x + 1) / 2: with dt u B
    scaled by 2^(tt + 1) and y and the state scaled back by 2^-(tt + 1) and
    2^-nt, every value is a power of two times the halved form's, so the
    bits are the same (powers of two scale f32 exactly)."""
    dt, u, B, C, A, h0 = _scan_inputs(Bt=2, Sq=40, din=16)
    a2 = A * torch.tensor(LOG2E)
    half, scaled = h0.clone(), h0.clone()
    TT = time_scan.TT_WAVE
    for t in range(dt.shape[1]):
        tt = t % TT
        e = torch.exp2(_fma(dt[:, t, :, None].expand_as(h0),
                            a2[None].expand_as(h0), torch.ones_like(h0)))
        dxb = (dt[:, t] * u[:, t])[..., None] * B[:, t, None, :]
        half = _fma(e * 0.5, half, dxb)
        scaled = _fma(e, scaled, (dt[:, t] * u[:, t] * 2.0 ** (tt + 1))
                      [..., None] * B[:, t, None, :])
        y_half = (half * C[:, t, None, :]).sum(-1)
        y_scaled = (scaled * C[:, t, None, :]).sum(-1) * 2.0 ** -(tt + 1)
        assert torch.equal(y_half, y_scaled)
        if tt == TT - 1 or t == dt.shape[1] - 1:
            scaled = scaled * 2.0 ** -(tt + 1)
            assert torch.equal(half, scaled)


def _scan_inputs(Bt=3, Sq=260, din=32, N=16, seed=2):
    """dt from a softplus over falcon-mamba's init (dt_bias: dt drawn
    log-uniform in [0.001, 0.1]; dt_lin ~ N(0, 0.5)), A = -(1 .. N), ragged
    rows masked (dt = 0, u = 0) as ``ssm_prefill`` passes them."""
    rng = np.random.default_rng(seed)
    r = rng.random(din)
    lo, hi = math.log(0.001), math.log(0.1)
    bias = np.log(np.expm1(np.exp(r * (hi - lo) + lo)))
    lin = rng.normal(scale=0.5, size=(Bt, Sq, din))
    dt = torch.from_numpy(np.log1p(np.exp(lin + bias)).astype(np.float32))
    lens = np.array([Sq, Sq * 2 // 3, 5][:Bt])
    mask = torch.from_numpy(np.arange(Sq)[None] < lens[:, None])[..., None]
    u = torch.from_numpy(rng.normal(size=(Bt, Sq, din)).astype(np.float32))
    dt, u = dt * mask, u * mask
    B = torch.from_numpy(rng.normal(size=(Bt, Sq, N)).astype(np.float32))
    C = torch.from_numpy(rng.normal(size=(Bt, Sq, N)).astype(np.float32))
    A = -torch.arange(1, N + 1, dtype=torch.float32).repeat(din, 1)
    h0 = torch.from_numpy(rng.normal(size=(Bt, din, N)).astype(np.float32))
    return dt, u, B, C, A, h0


def _rel(got, want):
    return ((got - want).abs().max() / want.pow(2).mean().sqrt()).item()


@pytest.mark.parametrize("ns", time_scan.LANE_STATES)
def test_kernel_order_within_scan_tolerance(ns):
    """The kernel's order (lanes, FMAs, the pairwise y, exp2 on A log2(e)
    plus 1) stays within chip_smoke's 1e-4 of the RMS of
    ``selective_scan_ref`` over ragged rows; a masked step leaves the
    state bitwise as it was."""
    args = _scan_inputs()
    got = _kernel_order(*args, ns=ns)
    want = ref.selective_scan_ref(*args)
    for g, w in zip(got, want):
        assert _rel(g, w) <= SCAN_REL_TOL
    dt, u, B, C, A, h0 = args
    short = _kernel_order(dt[2:, :5], u[2:, :5], B[2:, :5], C[2:, :5], A,
                          h0[2:], ns=ns)
    assert torch.equal(got[1][2:], short[1])      # row 2: 5 live steps
    assert torch.equal(_exp_factor(torch.zeros(4), torch.full((4,), -3.)),
                       torch.ones(4))


@pytest.fixture(scope="module")
def long_scan():
    """1,024 steps from a zero state, and the plain version's h_last."""
    dt, u, B, C, A, h0 = _scan_inputs(Bt=2, Sq=1024, din=64)
    args = (dt, u, B, C, A, torch.zeros_like(h0))
    return args, ref.selective_scan_ref(*args)[1]


@pytest.mark.parametrize("ulps", [1, 2, 4])
def test_same_signed_exp_bias_over_1024_steps(long_scan, ulps):
    """The error a biased exponential adds against torch.exp, at the dt
    that softplus gives falcon-mamba's init, accumulated over 1,024 steps:
    every factor exp(dt A) made smaller by ``ulps`` units in its last
    place, the same sign on every step, as an exponential that truncates
    its argument's fraction would.  A slow state (dt |A| ~ 1e-3) remembers
    ~1,000 steps and is the largest, so even one ulp breaches the check's
    1e-4 of h_last's RMS, and more ulps breach it further.  That is why the
    kernel feeds ex2.approx dt A log2(e) + 1 (a fraction it takes whole)
    and halves the result, rather than the bare product (the fraction 1 +
    x of a negative x, truncated): ``_kernel_order`` above, rounded to
    nearest, stays within the limit."""
    (dt, u, B, C, A, h0), want = long_scan
    errs = []
    for k in (1, ulps):
        h = h0.clone()
        shrink = 1.0 - k * 2.0 ** -24
        for t in range(dt.shape[1]):
            da = torch.exp(dt[:, t, :, None] * A) * shrink
            h = da * h + (dt[:, t] * u[:, t])[..., None] * B[:, t, None, :]
        errs.append(_rel(h, want))
    assert SCAN_REL_TOL < errs[0] <= errs[1], errs
    if ulps == 4:
        assert errs[1] > 1.5 * errs[0], errs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_state_long_row_is_below_f32_resolution(seed):
    """From a random state, one live row of 1,024 steps at a dt constant in
    time (falcon-mamba's init draws: dt_lin ~ 0 beside the bias) with
    inputs of the init's size: the plain f32 scan's h_last is itself more
    than chip_smoke's 1e-4 of its RMS from a float64 scan (a rounding of
    exp(dt A) that repeats every step, on slow states that outlive the
    decayed rest), and the kernel's order is within 4x of that distance.
    So no case of chip_smoke.py holds such a row to that limit: its random
    states are held on the ragged wave (short rows keep the RMS up) and at
    decode, and the single prompt starts from a zero state."""
    rng = np.random.default_rng(seed)
    Sq, din, N = 1024, 64, 16
    lo, hi = math.log(0.001), math.log(0.1)
    dt = np.exp(rng.random(din) * (hi - lo) + lo)
    dt = torch.from_numpy(np.broadcast_to(dt, (1, Sq, din))
                          .astype(np.float32).copy())
    u, B, C = (torch.from_numpy(rng.normal(scale=0.005, size=shape)
                                .astype(np.float32))
               for shape in ((1, Sq, din), (1, Sq, N), (1, Sq, N)))
    A = -torch.arange(1, N + 1, dtype=torch.float32).repeat(din, 1)
    h0 = torch.from_numpy(rng.normal(size=(1, din, N)).astype(np.float32))
    args = (dt, u, B, C, A, h0)
    exact = ref.selective_scan_ref(*(a.double() for a in args))[1]
    plain = _rel(ref.selective_scan_ref(*args)[1].double(), exact)
    kernel = _rel(_kernel_order(*args, ns=8)[1].double(), exact)
    assert SCAN_REL_TOL < plain and kernel <= 4 * plain, (plain, kernel)


def _emulated_prologue(dt_lin, bias, mask, dtype):
    """The kernel's dt: T(softplus(T(dt_lin + T(bias)))) in f32 registers,
    0 where masked."""
    t = TDT[dtype]
    x = (dt_lin.float() + bias.to(t).float()).to(t).float()
    sp = torch.where(x > 20.0, x, torch.log1p(torch.exp(x))).to(t).float()
    return sp if mask is None else torch.where(mask[..., None], sp, 0.0)


def _emulated_epilogue(y, xc, z, D, dtype):
    """The kernel's out = T(T(T(y) + T(xc T(D))) T(silu(z))) in f32."""
    t = TDT[dtype]
    rnd = lambda v: v.to(t).float()
    skip = rnd(xc.float() * rnd(D))
    s = rnd(rnd(y) + skip)
    zf = z.float()
    g = rnd(zf / (1.0 + torch.exp(-zf)))
    return (s * g).to(t)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_bf16_prologue_epilogue_rounding_points(mamba_layer, masked):
    """The softplus, bias and mask before the scan and the D skip and gate
    after it, each rounded where the kernel rounds, give the plain
    version's dt and output bitwise from the same f32 y (din 128: every
    element of torch's CPU loops vectorised, as the kernel's inputs are
    whole rows)."""
    cfg, p = mamba_layer
    dtype = "bfloat16"
    xc, z, h0, mask = _inner_inputs(cfg, dtype, 40, seed=3)
    m = mask if masked else None
    R, N = S.dt_rank(cfg), cfg.ssm_state
    dbc = xc @ p["x_proj"].to(xc.dtype)
    dt_r, b_ssm, c_ssm = dbc.split([R, N, N], dim=-1)
    dt_lin = dt_r @ p["dt_proj"].to(xc.dtype)
    dt = _emulated_prologue(dt_lin, p["dt_bias"], m, dtype)
    A = -torch.exp(p["A_log"].float())
    y, h = ref.selective_scan_ref(dt, xc.float(), b_ssm.float().contiguous(),
                                  c_ssm.float().contiguous(), A, h0)
    out = _emulated_epilogue(y, xc, z, p["D"], dtype)
    want = ref.ssm_scan_ref(dt_lin, p["dt_bias"], xc, b_ssm, c_ssm, z,
                            p["A_log"], p["D"], h0, m)
    assert torch.equal(out, want[0]) and torch.equal(h, want[1])


# ------------------------------------------------------------ the wrapper

# (rows, width) of every selective-scan shape chip_smoke.py runs at din
# 8192: the serve's wave, the ragged wave, decode, a single prompt
CARD_SHAPES = [(8, 960), (8, 1024), (8, 1), (1, 4096)]


@pytest.mark.parametrize("rows,width", CARD_SHAPES)
def test_plan_fills_the_card(rows, width):
    """At falcon-mamba's din the plan takes the most states a lane whose
    grid still gives 7/8 of the H100's 132 SMs a block, and its channels a
    block divide din."""
    din, N = 8192, 16
    ns = time_scan.plan(rows, din)
    ch = time_scan.THREADS * ns // N
    assert din % ch == 0 and ch % time_scan.CHANNEL_MULTIPLE == 0
    assert rows * din // ch >= 132 * 7 // 8
    assert ns == (4 if rows == 1 else 8)


def test_plan_falls_back_to_four_states_a_lane():
    """A grid too small at 8 states a lane takes 4 (twice the blocks)."""
    assert time_scan.plan(1, 1024) == 4
    assert time_scan.plan(2, 8192) == 8


def test_source_constants_match_the_wrapper():
    """THREADS, TT_WAVE and the states a lane the launcher dispatches are
    the wrapper's; the launcher takes a one-step tile at decode; the
    kernels keep the names the launch accounting reads
    (``selective_scan_kernel``)."""
    assert re.search(rf"constexpr int THREADS = {time_scan.THREADS};",
                     SOURCE)
    assert re.search(rf"constexpr int TT_WAVE = {time_scan.TT_WAVE};",
                     SOURCE)
    dispatched = {int(n) for n in re.findall(r"if \(ns == (\d)\)", SOURCE)}
    assert "const bool decode = p.S == 1;" in SOURCE
    assert dispatched == set(time_scan.LANE_STATES)
    assert "selective_scan_kernel(" in SOURCE
    assert "ex2.approx.ftz.f32" in SOURCE
    assert "ex2_approx(fmaf(dtv, a2[j], 1.f))" in SOURCE
    assert "pow2(tt + 1)" in SOURCE and "pow2(-(tt + 1))" in SOURCE
    assert "h[j] *= pow2(-nt)" in SOURCE


def _fused_args(dtype=torch.bfloat16, Bt=2, Sq=5, din=64, N=16):
    xz = torch.zeros(Bt, Sq, 2 * din, dtype=dtype)
    dbc = torch.zeros(Bt, Sq, 8 + 2 * N, dtype=dtype)
    return [torch.zeros(Bt, Sq, din, dtype=dtype), torch.zeros(din),
            xz[..., :din].contiguous(), dbc[..., 8:8 + N],
            dbc[..., 8 + N:], xz[..., din:], torch.zeros(din, N),
            torch.zeros(din), torch.zeros(Bt, din, N),
            torch.ones(Bt, Sq, dtype=torch.bool)]


def test_fused_wrapper_refuses_cpu_and_dtypes():
    """The fused wrapper launches on CUDA tensors or raises: CPU tensors,
    and activations that are neither f32 nor bf16."""
    with pytest.raises(ValueError, match="CUDA"):
        selective_scan.fused(*_fused_args())
    args = _fused_args()
    args[2] = args[2].half()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        selective_scan.fused(*args)
    assert selective_scan.launches == 0


@pytest.mark.parametrize("case", ["dtype", "shape", "inner", "token",
                                  "aligned"])
def test_token_rows_refusals(case):
    """B, C and z are read in place only as rows of contiguous values at
    one token stride, each row on a 16-byte boundary."""
    Bt, Sq, N = 2, 5, 16
    dbc = torch.zeros(Bt, Sq, 40, dtype=torch.bfloat16)
    good = dbc[..., 8:8 + N]
    assert time_scan.token_rows(good, "B", (Bt, Sq, N),
                                torch.bfloat16) == 40
    assert time_scan.token_rows(dbc[:, :1, 8:8 + N], "B", (Bt, 1, N),
                                torch.bfloat16) == 40 * Sq
    bad, err = {
        "dtype": (good.float(), TypeError),
        "shape": (good[:, :4], ValueError),
        "inner": (dbc[..., 8:40:2], ValueError),
        "token": (torch.zeros(Bt * (Sq * 40 + 8), dtype=torch.bfloat16)
                  .as_strided((Bt, Sq, N), (Sq * 40 + 8, 40, 1)),
                  ValueError),
        "aligned": (dbc[..., 4:4 + N], ValueError)}[case]
    with pytest.raises(err):
        time_scan.token_rows(bad, "B", (Bt, Sq, N), torch.bfloat16)


def test_ops_ssm_scan_plain_on_cpu_under_autograd(mamba_layer):
    """On the CPU ``ops.ssm_scan`` is the plain version, differentiable
    (the kernel refuses autograd on the card, as every serving kernel)."""
    cfg, p = mamba_layer
    xc, z, h0, mask = _inner_inputs(cfg, "float32", 6, seed=4)
    xc.requires_grad_(True)
    R, N = S.dt_rank(cfg), cfg.ssm_state
    dbc = xc @ p["x_proj"]
    dt_r, b_ssm, c_ssm = dbc.split([R, N, N], dim=-1)
    y, _ = ops.ssm_scan(dt_r @ p["dt_proj"], p["dt_bias"], xc, b_ssm, c_ssm,
                        z, p["A_log"], p["D"], h0, mask)
    y.sum().backward()
    assert xc.grad is not None and bool(torch.isfinite(xc.grad).all())


def test_full_width_layer_fits_the_kernel():
    """falcon-mamba-7b's mixer: din 8192 and state 16 are what the kernel
    is instantiated for, and x_proj's rows (dt rank 256 + 2 x 16 = 288
    values) put B and C on 16-byte boundaries in bf16 and f32."""
    cfg = get_config("falcon-mamba-7b")
    din, N, R = cfg.ssm_expand * cfg.d_model, cfg.ssm_state, S.dt_rank(cfg)
    assert N in time_scan.STATE_SIZES
    assert din % time_scan.CHANNEL_MULTIPLE == 0
    for esize in (2, 4):
        assert (R + 2 * N) * esize % 16 == 0
        assert R * esize % 16 == 0 and (R + N) * esize % 16 == 0
        assert 2 * din * esize % 16 == 0 and din * esize % 16 == 0
