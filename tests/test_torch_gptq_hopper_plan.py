"""The int4 matmul's wgmma body (``gptq_wgmma_kernel`` of
``csrc/gptq_matmul.cu``), its host-side arithmetic on the CPU.

* A Python copy of the plan and the grid (``kernels/gptq_matmul.plan`` and
  ``launch_wgmma`` / ``launch_mma``): at every linear, group size and M of
  ``chip_smoke.py``'s int4 shapes (qwen2-1.5b, h2o-danube-3-4b,
  recurrentgemma-2b, falcon-mamba-7b, llava-next-mistral-7b, hubert-xlarge,
  command-r-plus-104b and the ragged check shape) the blocks' column, row
  and k ranges partition N, M and K, so every (row, column, k) of the
  product is covered once; K is split only where the output tiles leave
  the SMs' block slots idle; every call is one launch; the stages fit
  shared memory; the cost model picks a cheapest plan.
* The A fragments: the kernel's byte permute, lop3 and half-select steps
  emulated bit for bit on a tile of random code words give, for every
  consumer thread, k step and register half, the code that mma.sync's A
  layout puts there: a bijection onto the tile's 128 columns x 64 k.  x is
  staged in the same (natural) k order, so the product of the emulated
  fragments and x equals the plain product exactly.
* The dequant's rounding (an f32 FMA of 128 + q with the scale and
  -(128 + z) x scale, rounded to bf16 once), emulated in plain torch,
  within the bound the kernel's header states of the exact weight, and
  against the JAX package's Pallas
  ``gptq_matmul`` in interpret mode at the bf16 tolerance of
  ``tests/test_kernels.py`` (2e-2): group sizes 32, 96 and 128, symmetric
  (8) and asymmetric f32 zeros, M 1, 8 and 200.
* The split-K fix-up: whichever split arrives last sums the partials in
  split order, so two calls give the same bits.

The copy is checked against the kernel's source text.  The CUDA kernel
itself runs only on the card, where ``chip_smoke.py`` holds it against
the plain version.
"""
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.kernels.gptq_matmul import gptq_matmul as j_gptq
from repro_torch.core.quant import pack_int4, unpack_int4
from repro_torch.kernels.gptq_matmul import (BK, BN, COUNTERS, MAX_PARTIAL,
                                             MAX_SPLITS, PACK, TOKEN_TILES,
                                             _cost, plan, scale_rows,
                                             stage_bytes)


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


SRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
       / "kernels" / "csrc" / "gptq_matmul.cu")
SMS = 132                          # H100 SXM
SMEM = 232448                      # shared memory a block can use
TOL = 2e-2


def test_copy_reads_as_the_kernel_source():
    src = SRC.read_text()
    for text in (
            "constexpr int BN = 128;",
            "constexpr int Q_BYTES = KW * BN * 4;",
            "MIN_BLOCKS = NT <= 32 ? 2 : 1",
            "X_BYTES = NT * 128;",
            "return X_BYTES + Q_BYTES + 2 * sr * BN * 4;",
            "return 1024 + (size_t)ring_bytes(sr, stages) + 16 * stages + 16;",
            "OUT_BYTES = NT * OUT_STRIDE * 2;",
            "constexpr int OUT_STRIDE = BN + 8;",
            "n0 = blockIdx.x * BN, m0 = blockIdx.y * NT",
            "kt0 = blockIdx.z * kt_per;",
            "n_tiles = min(kt0 + kt_per, KT) - kt0;",
            "splits = (KT + kt_per - 1) / kt_per;",
            "dim3 grid((N + BN - 1) / BN, (M + NT - 1) / NT, splits);",
            "dim3 grid((N + TL::BN - 1) / TL::BN, (M + TL::BM - 1) / TL::BM, "
            "splits);",
            "ROUTE_WGMMA = 0, ROUTE_MMA = 1",
            "col_a = cw * 64 + w * 16 + 2 * g;",
            "sel = t | t << 4 | (4 + t) << 8 | (4 + t) << 12;",
            "lo = (b & 0x000F000Fu) | MAGIC;",
            "hi = ((b >> 4) & 0x000F000Fu) | MAGIC;",
            "MAGIC = 0x43004300;",
            "r0 = *reinterpret_cast<const uint2*>(qs + 2 * kk * BN + col_a);",
            "*reinterpret_cast<const uint2*>(qs + (2 * kk + 1) * BN + col_a);",
            "nibbles(r0.x, r1.x, sel, lo_a, hi_a);",
            "nibbles(r0.y, r1.y, sel, lo_b, hi_b);",
            "an[kk][0] = dequant<0>(lo_a, hi_a, sa, ca);",
            "an[kk][1] = dequant<0>(lo_b, hi_b, sb, cb);",
            "an[kk][2] = dequant<1>(lo_a, hi_a, sa, ca);",
            "an[kk][3] = dequant<1>(lo_b, hi_b, sb, cb);",
            "HALF ? lo & 0xFFFF0000u : lo << 16",
            "HALF ? hi & 0xFFFF0000u : hi << 16",
            "return rt::pack_bf16(fmaf(k0, s, c), fmaf(k1, s, c));",
            "ca = fmaf(-z2.x, sa, -128.f * sa);",
            "hp::desc_sw128(xs + kk * 32, 16, 1024)",
            "hp::tma_load_2d(st, &tx, bar, kt * BK, m0);",
            "os + (8 * j + 2 * t + e) * OUT_STRIDE + col_a) =",
            "rt::pack_bf16(acc[4 * j + e], acc[4 * j + e + 2]);",
            "for (int z = 0; z < splits; ++z)",
            "acc[q][0] = z ? acc[q][0] + a.x : a.x;",
            "const int n = atomicAdd(counter, 1);"):
        assert text in src, text
    # one launch a call: the f32, mma.sync and wgmma bodies each launch
    # once, and nothing else is launched
    assert src.count("<<<") == 3
    assert "splitk_reduce" not in src


def _shapes():
    """(label, K, N, gs, M) of every int4 product chip_smoke.py checks."""
    lists = {"qwen2": chip_smoke.GPTQ_SHAPES,
             "danube": chip_smoke.DANUBE_GPTQ_SHAPES,
             "rgemma": chip_smoke.RGEMMA_GPTQ_SHAPES,
             "mamba": chip_smoke.MAMBA_GPTQ_SHAPES,
             "llava": chip_smoke.LLAVA_GPTQ_SHAPES,
             "hubert": chip_smoke.HUBERT_GPTQ_SHAPES,
             "cmdr": chip_smoke.CMDR_GPTQ_SHAPES}
    return [pytest.param(K, N, gs, M, id=f"{model}-{lname}-M{M}")
            for model, shapes in lists.items()
            for lname, K, N, gs, ms in shapes for M in ms]


def _partition(ranges, n):
    """The ranges are non-empty and tile [0, n) in order."""
    edge = 0
    for lo, hi in ranges:
        assert lo == edge and hi > lo
        edge = hi
    assert edge == n


@pytest.mark.parametrize("K,N,gs,M", _shapes())
def test_plan_covers_every_product_once(K, N, gs, M):
    p = plan(M, K, N, gs, SMS)
    assert p.launches == 1
    assert (p.route == "wgmma") == (N % 4 == 0)
    kt = math.ceil(K / BK)
    # the grid of launch_wgmma / launch_mma: blockIdx.x -> columns n0 =
    # x BN, y -> rows m0 = y NT, z -> k tiles kt0 = z kt_per .. min(kt0 +
    # kt_per, KT): each a partition
    gx, gy = math.ceil(N / p.bn), math.ceil(M / p.bm)
    gz = math.ceil(kt / p.kt_per)
    _partition([(x * p.bn, min((x + 1) * p.bn, N)) for x in range(gx)], N)
    _partition([(y * p.bm, min((y + 1) * p.bm, M)) for y in range(gy)], M)
    _partition([(z * p.kt_per * BK, min(min((z + 1) * p.kt_per, kt) * BK, K))
                for z in range(gz)], K)
    assert gz == math.ceil(kt / p.kt_per) == p.splits
    if p.route == "mma":
        return
    nt = p.tile
    assert nt == p.bm and p.bn == BN and nt in TOKEN_TILES
    top = next((t for t in TOKEN_TILES if t >= M), 256)
    assert nt <= top and (nt >= 64 or M <= 64)
    per_sm = 2 if nt <= 32 else 1
    slots = SMS * per_sm
    # K splits only where the output tiles leave block slots idle
    assert p.splits == 1 or gx * gy < slots
    assert p.splits == 1 or 4 * M * N * p.splits <= MAX_PARTIAL
    assert p.splits <= MAX_SPLITS and (p.splits == 1 or gx * gy <= COUNTERS)
    # the groups of every k tile are staged; the ring (and the epilogue's
    # tile in it) and the barriers fit per_sm blocks an SM
    assert p.sr == scale_rows(gs) and 1 <= p.sr <= BK // PACK
    assert 1 <= p.stages <= p.kt_per
    ring = max(p.stages * stage_bytes(nt, p.sr), nt * (BN + 8) * 2)
    smem = 1024 + ring + 16 * p.stages + 16
    assert per_sm * (smem + 1024) <= 233472 and smem <= SMEM


@pytest.mark.parametrize("gs", [8, 16, 24, 32, 64, 96, 128])
def test_scale_rows_stage_every_group_of_a_k_tile(gs):
    """``sr`` rows from the group of a tile's first k hold every group the
    tile's 64 k touch, and no fewer rows would."""
    sr = scale_rows(gs)
    K = 64 * gs
    spans = [(min(k0 + BK, K) - 1) // gs - k0 // gs + 1
             for k0 in range(0, K, BK)]
    assert max(spans) == sr


# ------------------------------------------------------------- fragments

def _byte_perm(a, b, s):
    """CUDA's __byte_perm: byte i of the result is byte (s >> 4i) & 7 of
    the 8 bytes b:a."""
    v = a | b << 32
    return sum(((v >> 8 * ((s >> 4 * i) & 7)) & 0xFF) << 8 * i
               for i in range(4))


def _fragments(qs):
    """{(column, k): code} as the kernel's consumer threads build their A
    registers from one stage's codes qs [8][BN] (Python ints), each
    register half placed where mma.sync's A layout (warp w's rows 16w ..
    16w + 15) puts it: a0 / a1 rows g / g + 8 at k 2t, 2t + 1 of the
    16-k step, a2 / a3 the same rows at k 2t + 8, 2t + 9; rows g and
    g + 8 of warp w of warpgroup cw hold columns 64 cw + 16 w + 2g and
    the next (``col_a``, ``col_a + 1``)."""
    got = {}
    for ct in range(256):
        cw, w, g, t = ct // 128, ct // 32 % 4, (ct & 31) >> 2, ct & 3
        col_a = cw * 64 + w * 16 + 2 * g
        col_b = col_a + 1
        sel = t | t << 4 | (4 + t) << 8 | (4 + t) << 12
        for kk in range(4):
            regs = []
            for col in (col_a, col_b):
                b = _byte_perm(qs[2 * kk][col], qs[2 * kk + 1][col], sel)
                lo = (b & 0x000F000F) | 0x43004300
                hi = ((b >> 4) & 0x000F000F) | 0x43004300
                # dequant<HALF>: (lo, hi)'s low halves, then their high
                regs.append(((lo & 0xFFFF) | (hi & 0xFFFF) << 16,
                             lo >> 16 | (hi >> 16) << 16))
            an = [regs[0][0], regs[1][0], regs[0][1], regs[1][1]]
            for e, r in enumerate(an):
                row = col_a + (e & 1)          # the column this row holds
                for half in range(2):
                    bits = r >> 16 * half & 0xFFFF
                    assert bits >> 4 == 0x430          # 128 + q, q < 16
                    k = 16 * kk + 2 * t + 8 * (e >> 1) + half
                    assert (row, k) not in got
                    got[(row, k)] = bits & 0xF
    return got


def test_fragments_are_a_bijection_onto_the_tile():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 16, (BK, BN)).astype(np.uint8)
    codes[7::8] = 15                              # words with the top bit set
    qs = pack_int4(codes).view(np.uint32).astype(np.int64).tolist()
    got = _fragments(qs)
    assert len(got) == BN * BK
    want = {(n, k): int(codes[k, n]) for n in range(BN) for k in range(BK)}
    assert got == want


def test_fragment_product_is_the_plain_product():
    """y^T = A x^T with A placed by the fragment map and x staged in
    natural k order equals x @ W exactly (small integers in f64)."""
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 16, (BK, BN)).astype(np.uint8)
    qs = pack_int4(codes).view(np.uint32).astype(np.int64).tolist()
    a = np.zeros((BN, BK))
    for (n, k), q in _fragments(qs).items():
        a[n, k] = q - 8
    x = rng.integers(-4, 5, (16, BK)).astype(np.float64)
    np.testing.assert_array_equal((a @ x.T).T,
                                  x @ (codes.astype(np.float64) - 8))


# -------------------------------------------------------------- rounding

def _emulated(x, qweight, scales, zeros):
    """The wgmma body's arithmetic: c = -(128 + z) s as one f32 FMA, each
    weight the f32 FMA (128 + q) s + c (exact in f64, then rounded to f32)
    rounded to bf16; x @ w in f32; bf16 out."""
    K = x.shape[-1]
    gs = K // scales.shape[0]
    codes = unpack_int4(qweight, K).double()
    s = scales.double()
    c = (-zeros.double() * s - 128 * s).float().double()
    w = ((codes + 128) * s.repeat_interleave(gs, 0)
         + c.repeat_interleave(gs, 0)).float().bfloat16()
    return (x.float() @ w.float()).bfloat16(), w


def _operands(rng, M, K, N, gs, zeros):
    codes = rng.integers(0, 16, (K, N)).astype(np.uint8)
    codes[7::8, : N // 2] = 15                    # negative int32 words
    qw = pack_int4(codes)
    scales = rng.uniform(0.01, 0.1, (K // gs, N)).astype(np.float32)
    z = (np.full((K // gs, N), 8.0, np.float32) if zeros == "sym"
         else rng.uniform(0, 15, (K // gs, N)).astype(np.float32))
    x = jnp.asarray(rng.normal(size=(M, K)), jnp.bfloat16)
    return x, qw, scales, z


@pytest.mark.parametrize("zeros", ["sym", "asym"])
@pytest.mark.parametrize("gs", [32, 96, 128])
def test_dequant_rounding_within_its_stated_bound(gs, zeros):
    """|w - (q - z) s| <= 2^-8 |(q - z) s| at every weight, to within the
    f32 FMA's own rounding (bf16 keeps 8 significant bits: a rounding is
    off by at most 2^-8 of what it rounds), the bound of the kernel's
    header."""
    rng = np.random.default_rng(gs)
    K, N = 384, 128
    _, qw, scales, z = _operands(rng, 1, K, N, gs, zeros)
    qwt, st, zt = (torch.from_numpy(a) for a in (qw, scales, z))
    _, w = _emulated(torch.zeros(1, K), qwt, st, zt)
    codes = unpack_int4(qwt, K).double()
    s = st.double().repeat_interleave(gs, 0)
    zz = zt.double().repeat_interleave(gs, 0)
    exact = (codes - zz) * s
    wd = w.double()
    bound = exact.abs() * 2 ** -8 + (144 + zz.abs()) * s * 2 ** -22
    assert bool(((wd - exact).abs() <= bound).all())


@pytest.mark.parametrize("M", [1, 8, 200])
@pytest.mark.parametrize("zeros", ["sym", "asym"])
@pytest.mark.parametrize("gs", [32, 96, 128])
def test_dequant_rounding_within_tolerance_of_pallas(gs, zeros, M):
    rng = np.random.default_rng(gs + M)
    K, N = 384, 128
    x, qw, scales, z = _operands(rng, M, K, N, gs, zeros)
    want = np.asarray(j_gptq(x, jnp.asarray(qw), jnp.asarray(scales),
                             jnp.asarray(z), interpret=True), np.float32)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    got, _ = _emulated(xt, torch.from_numpy(qw), torch.from_numpy(scales),
                       torch.from_numpy(z))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL * scale,
                               rtol=TOL)


# ---------------------------------------------------------------- split-K

@pytest.mark.parametrize("splits", [2, 3, 16])
def test_split_sum_is_the_same_bits_whichever_split_is_last(splits):
    """Each split's f32 partial of a tile, summed by the block that
    arrives last in split order (``sum_splits``), gives the same bits for
    every arrival order."""
    rng = np.random.default_rng(splits)
    parts = torch.from_numpy(
        rng.normal(size=(splits, 8, 128)).astype(np.float32) * 1e3)

    def fix_up(arrival):
        done = torch.zeros_like(parts)
        for z in arrival:
            done[z] = parts[z]
        assert sorted(arrival) == list(range(splits))
        s = done[0].clone()
        for z in range(1, splits):                # split order
            s += done[z]
        return s.bfloat16()

    first = fix_up(list(range(splits)))
    for seed in range(4):
        order = list(np.random.default_rng(seed).permutation(splits))
        assert torch.equal(fix_up(order), first)


@pytest.mark.parametrize("K,N,gs,M", [(1536, 256, 32, 256), (1536, 8960, 32, 8),
                                      (33792, 12288, 128, 256),
                                      (8960, 1536, 32, 8)])
def test_plan_is_a_cheapest_by_its_cost_model(K, N, gs, M):
    """No (tile, splits) the planner may take costs less by ``_cost``."""
    p = plan(M, K, N, gs, SMS)
    kt = math.ceil(K / BK)

    def cost(nt, s):
        return _cost(nt, max(1, math.ceil(M / nt) * math.ceil(N / BN)), kt,
                     s, SMS, M <= nt)

    top = next((t for t in TOKEN_TILES if t >= M), 256)
    tiles = [t for t in TOKEN_TILES if t <= top and (t >= 64 or M <= 64)]
    best = cost(p.tile, p.splits)
    for nt in tiles:
        slots = SMS * (2 if nt <= 32 else 1)
        underfill = math.ceil(M / nt) * math.ceil(N / BN) < slots
        for s in range(1, (min(kt, MAX_SPLITS) if underfill else 1) + 1):
            if 4 * M * N * s <= MAX_PARTIAL or s == 1:
                assert best <= cost(nt, s) + 1e-12, (nt, s)
