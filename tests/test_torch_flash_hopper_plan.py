"""The static attention kernel's wgmma body (``flash_attention_mma_kernel``
of ``csrc/flash_attention.cu``), its host-side arithmetic on the CPU.

* A Python copy of the kernel's tile arithmetic: the wide block (128
  query tokens, two consumer warpgroups of 64 rows, BK 128 keys a stage,
  64 at head dim 256) or, where the wide blocks would not fill the SMs
  once, the narrow one (64 query tokens, one consumer, BK 64); the band's
  first and last key tile, which tiles a warpgroup masks, and the order
  of the blocks.  At danube's window 8192
  over Sk 10240, an offset window, a ragged 333, hubert's non-causal 1500
  and recurrentgemma's 2048: every live (query, key) pair of the plain
  mask lies in exactly one visited tile of its block, no visited tile
  lies wholly outside the band, a tile left unmasked has every pair of
  the warpgroup's rows live, and the blocks that read one (sequence, KV
  head)'s K / V run together, heaviest query tile first, the G query
  heads of a tile side by side.
* The kernel's arithmetic emulated in plain torch at each built head dim
  (tiles of 128 rows and BK keys, scores in f32, exp2 with log2 e folded
  into the scale, the mask on edge tiles only, P rounded to bf16 before
  P V, O and the row sums in f32) against the JAX package's Pallas kernel
  in interpret mode at the bf16 tolerance of ``tests/test_kernels.py``
  (2e-2): causal, a window at a q_offset, and ALiBi (causal, where the
  port's |q - k| and the Pallas kernel's max(q - k, 0) agree, C3).

The copy is checked against the kernel's source text (the band and edge
expressions must read as the copy computes them), so an edit to one must
be made in the other.  The CUDA kernel itself runs only on the card,
where ``chip_smoke.py`` holds it against the plain version.
"""
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.alibi import alibi_slopes as j_alibi
from repro.kernels.flash_attention import flash_attention as j_flash
from repro_torch.core.alibi import alibi_slopes
from repro_torch.kernels.flash_attention import MMA_HEAD_DIMS


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
       / "kernels" / "csrc" / "flash_attention.cu")
WG_ROWS = 64              # query rows a consumer warpgroup
SMS = 132                 # H100 SXM
NEG_INF = -0.7 * float(np.finfo(np.float32).max)
LOG2E = 1.4426950408889634
TOL = 2e-2


def _narrow(B, H, Sq):
    """Whether ``launch_mma`` takes the narrow block: the wide blocks
    would not fill the SMs once."""
    return B * H * -(-Sq // 128) < SMS


def _tile(D, narrow):
    """(query tokens a block, keys a stage) of ``FaTile<D, SMALL>``."""
    return (64 if narrow else 128), (64 if narrow or D > 128 else 128)


def _band(q0, Sq, Sk, q_offset, causal, window, BQ, BK):
    """The key tiles one block visits, as the kernel derives them."""
    q_lo = q_offset + q0
    q_hi = q_offset + min(q0 + BQ, Sq) - 1
    k_end = min(Sk, q_hi + 1) if causal else Sk
    k_begin = max(0, q_lo - window + 1) // BK * BK if window > 0 else 0
    n_tiles = (k_end - k_begin - 1) // BK + 1 if k_end > k_begin else 0
    return [k_begin + i * BK for i in range(n_tiles)]


def _edge(k0, w_lo, w_hi, Sk, causal, window, BK):
    """Whether a warpgroup whose rows sit at positions w_lo .. w_hi masks
    the tile at k0."""
    return (k0 + BK > Sk or (causal and k0 + BK - 1 > w_lo)
            or (window > 0 and k0 < w_hi - window + 1))


def _block_order(B, H, KV, Sq, BQ):
    """(query head, sequence, first query token) of every block in launch
    order, decoded from blockIdx.x as the kernel decodes it: the G heads
    of a KV head fastest, then the query tiles heaviest (last) first, then
    the KV head, then the sequence."""
    G, nq = H // KV, -(-Sq // BQ)
    order = []
    for x in range(B * H * nq):
        kvh, b = x // (G * nq) % KV, x // (G * nq * KV)
        order.append((kvh * G + x % G, b, (nq - 1 - x // G % nq) * BQ))
    return order


def test_copy_reads_as_the_kernel_source():
    src = SRC.read_text()
    for text in (
            "BQ = 64 * NCW",
            "NCW = SMALL ? 1 : 2",
            "BK = SMALL || D > 128 ? 64 : 128",
            "MMA_BQ = 128",
            "wide = (long long)B * H * ((Sq + MMA_BQ - 1) / MMA_BQ)",
            "wide < sms ? launch_tiles<D, true>",
            "G = H / KV, nq = (Sq + T::BQ - 1) / T::BQ",
            "kvh = blockIdx.x / (G * nq) % KV, b = blockIdx.x / (G * nq * KV)",
            "h = kvh * G + blockIdx.x % G",
            "q0 = (nq - 1 - blockIdx.x / G % nq) * T::BQ",
            "q_hi = q_offset + min(q0 + T::BQ, Sq) - 1",
            "k_end = causal ? min(Sk, q_hi + 1) : Sk",
            "window > 0 ? max(0, q_lo - window + 1) / T::BK * T::BK : 0",
            "(k_end - k_begin - 1) / T::BK + 1 : 0",
            "w_lo = q_lo + cw * 64",
            "w_hi = q_offset + min(q0 + cw * 64 + 64, Sq) - 1",
            "k0 + T::BK > Sk ||",
            "(causal && k0 + T::BK - 1 > w_lo) ||",
            "(window > 0 && k0 < w_hi - window + 1)",
            "blocks = B * H * ((Sq + T::BQ - 1) / T::BQ)"):
        assert text in src, text


# (label, head dim, Sq, Sk, q_offset, causal, window)
PLANS = [
    ("danube window 8192 at Sk 10240", 120, 10240, 10240, 0, True, 8192),
    ("q_offset 64, window 100", 128, 200, 333, 64, True, 100),
    ("ragged 333", 128, 333, 333, 0, True, 0),
    ("hubert non-causal 1500", 80, 1500, 1500, 0, False, 0),
    ("rgemma 2048, window 2048", 256, 2048, 2048, 0, True, 2048),
]
# each plan at each block
PLAN_BLOCKS = [pytest.param(*p, narrow,
                            id=f"{p[0]}-{'narrow' if narrow else 'wide'}")
               for p in PLANS for narrow in (False, True)]


@pytest.mark.parametrize("label,D,Sq,Sk,q_offset,causal,window,narrow",
                         PLAN_BLOCKS)
def test_tiles_cover_every_live_pair_once(label, D, Sq, Sk, q_offset,
                                          causal, window, narrow):
    BQ, BK = _tile(D, narrow)
    keys = np.arange(Sk)
    for q0 in range(0, Sq, BQ):
        tiles = _band(q0, Sq, Sk, q_offset, causal, window, BQ, BK)
        # tiles are disjoint, BK apart, and start on a BK boundary
        assert all(t % BK == 0 for t in tiles)
        assert all(b - a == BK for a, b in zip(tiles, tiles[1:]))
        rows = np.arange(q0, min(q0 + BQ, Sq))
        q_pos = q_offset + rows
        dist = q_pos[:, None] - keys[None]
        live = np.ones_like(dist, dtype=bool)
        if causal:
            live &= dist >= 0
        if window > 0:
            live &= dist < window
        seen = np.zeros(Sk, np.int64)
        for k0 in tiles:
            seen[k0:k0 + BK] += 1
            # no visited tile lies wholly outside the block's band
            assert live[:, k0:k0 + BK].any(), (q0, k0)
            for w in range(BQ // WG_ROWS):
                wr = slice(w * WG_ROWS, (w + 1) * WG_ROWS)
                if q0 + w * WG_ROWS >= Sq:
                    continue                       # no row to store
                w_lo = q_offset + q0 + w * WG_ROWS
                w_hi = q_offset + min(q0 + (w + 1) * WG_ROWS, Sq) - 1
                if not _edge(k0, w_lo, w_hi, Sk, causal, window, BK):
                    # unmasked: every pair live, every key inside Sk
                    assert k0 + BK <= Sk and live[wr, k0:k0 + BK].all(), \
                        (q0, w, k0)
        # every live pair of the block's rows in exactly one visited tile
        assert (seen[live.any(0)] == 1).all(), q0


@pytest.mark.parametrize("label,D,Sq,Sk,q_offset,causal,window,narrow",
                         PLAN_BLOCKS)
def test_blocks_run_by_kv_head_heaviest_first(label, D, Sq, Sk, q_offset,
                                              causal, window, narrow):
    heads = {120: (32, 8), 128: (12, 2), 80: (16, 16), 256: (10, 1)}[D]
    H, KV = heads
    G, B = H // KV, 2
    BQ, BK = _tile(D, narrow)
    order = _block_order(B, H, KV, Sq, BQ)
    assert sorted(order) == sorted(
        (h, b, q0) for h in range(H) for b in range(B)
        for q0 in range(0, Sq, BQ))                # every block once
    # the blocks that read one (sequence, KV head)'s K / V are one run
    groups = [(b, h // G) for h, b, _ in order]
    runs = [g for i, g in enumerate(groups) if i == 0 or g != groups[i - 1]]
    assert len(runs) == len(set(runs)) == B * KV
    for b, kvh in runs:
        mine = [q0 for h, bb, q0 in order if (bb, h // G) == (b, kvh)]
        work = [len(_band(q0, Sq, Sk, q_offset, causal, window, BQ, BK))
                for q0 in mine]
        assert all(x >= y for x, y in zip(work, work[1:]))   # heaviest first
    # the G query heads of a KV head are G consecutive blocks over the
    # same (sequence, query tile), so they read the same K / V tiles
    for i in range(0, len(order), G):
        grp = order[i:i + G]
        assert len({(h // G, b, q0) for h, b, q0 in grp}) == 1


def _emulate(q, k, v, *, causal, window, q_offset, slopes, narrow):
    """The wgmma body's arithmetic in plain torch.  q [B, Sq, H, D], k / v
    [B, Sk, KV, D] (bf16 values held in f32); slopes [H] or None."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    BQ, BK = _tile(D, narrow)
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32) * LOG2E
    out = torch.zeros_like(q)
    kp = torch.cat([k, torch.zeros(B, BK, KV, D)], 1)   # TMA's zero fill
    vp = torch.cat([v, torch.zeros(B, BK, KV, D)], 1)
    for b in range(B):
        for h in range(H):
            slope = 0.0 if slopes is None else float(slopes[h]) * LOG2E
            for q0 in range(0, Sq, BQ):
                tiles = _band(q0, Sq, Sk, q_offset, causal, window, BQ, BK)
                for w in range(BQ // WG_ROWS):
                    r0 = q0 + w * WG_ROWS
                    if r0 >= Sq:
                        continue                   # no row to store
                    rows = torch.arange(r0, min(r0 + WG_ROWS, Sq))
                    qp = q_offset + rows
                    w_lo, w_hi = int(qp[0]), int(qp[-1])
                    m = torch.full((len(rows),), NEG_INF)
                    l = torch.zeros(len(rows))
                    o = torch.zeros(len(rows), D)
                    for k0 in tiles:
                        keys = torch.arange(k0, k0 + BK)
                        kt = kp[b, k0:k0 + BK, h // G]
                        vt = vp[b, k0:k0 + BK, h // G]
                        x = (q[b, rows, h] @ kt.T) * scale
                        d = qp[:, None] - keys[None]
                        if slope != 0.0:
                            x = x - slope * d.abs().float()
                        if _edge(k0, w_lo, w_hi, Sk, causal, window, BK):
                            live = keys[None] < Sk
                            if causal:
                                live = live & (d >= 0)
                            if window > 0:
                                live = live & (d < window)
                            x = torch.where(live, x, torch.tensor(NEG_INF))
                        mx = torch.maximum(m, x.amax(-1))
                        alpha = torch.exp2(m - mx)
                        p = torch.exp2(x - mx[:, None])
                        l = l * alpha + p.sum(-1)
                        m = mx
                        o = o * alpha[:, None] + p.bfloat16().float() @ vt
                    out[b, rows, h] = (o / l.clamp(min=1e-30)[:, None]) \
                        .bfloat16().float()
    return out


# (label, Sq, Sk, kwargs)
EMULATED = [("causal", 300, 300, {}),
            ("q_offset 64, window 100", 200, 333,
             {"q_offset": 64, "sliding_window": 100}),
            ("ALiBi, causal", 300, 300, {"alibi": True})]


@pytest.mark.parametrize("case", EMULATED, ids=[c[0] for c in EMULATED])
@pytest.mark.parametrize("D,narrow", [
    pytest.param(d, narrow, id=f"{d}-{'narrow' if narrow else 'wide'}")
    for d in MMA_HEAD_DIMS["flash_attention"] for narrow in (False, True)])
def test_emulated_wgmma_body_matches_pallas(D, narrow, case):
    label, Sq, Sk, kw = case
    rng = np.random.default_rng(D + Sk)
    B, H, KV = 1, 4, 2
    q, k, v = (jnp.asarray(rng.normal(size=sh), jnp.bfloat16)
               for sh in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D)))
    alibi = kw.get("alibi", False)
    window, q_offset = kw.get("sliding_window", 0), kw.get("q_offset", 0)
    want = np.asarray(j_flash(q, k, v, j_alibi(H) if alibi else None,
                              causal=True, sliding_window=window,
                              q_offset=q_offset, interpret=True), np.float32)
    qt, kt, vt = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                  for a in (q, k, v))
    got = _emulate(qt, kt, vt, causal=True, window=window,
                   q_offset=q_offset,
                   slopes=alibi_slopes(H) if alibi else None, narrow=narrow)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("B,Sq,H,narrow", [
    (8, 960, 12, False), (4, 512, 12, False), (8, 512, 12, False),
    (8, 8192, 32, False), (8, 1500, 16, False), (8, 2048, 10, False),
    (4, 3080, 32, False), (2, 512, 12, True), (2, 200, 32, True),
    (2, 333, 10, True), (1, 10240, 32, False)])
def test_narrow_block_only_below_one_wave(B, Sq, H, narrow):
    """The serving, calibration and training shapes take the wide block;
    only calls whose wide grid would leave SMs idle take the narrow one."""
    assert _narrow(B, H, Sq) == narrow
