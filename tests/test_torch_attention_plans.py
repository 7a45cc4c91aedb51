"""Host-side logic of the port's tensor-core attention kernels, on the CPU.

* The split page walk of the bf16 decode kernel
  (``kernels/paged_attention.plan`` and the key ranges that
  ``paged_attention_mma_kernel`` derives from it): every live key is
  computed exactly once, every live page is read by exactly one split, no
  page at or past ``ceil(seq_len / BS)`` is read, and the whole call is
  one launch.
* The tile ranges of the bf16 chunk kernel (``chunk_attention_mma_kernel``):
  every (query, key) pair a query may see lies in exactly one staged tile
  of its block.
* The arithmetic the two kernels add, emulated in plain torch, against the
  JAX package's Pallas kernels (interpret mode) at the bf16 tolerance of
  ``tests/test_kernels.py`` (2e-2): per-split partials with P rounded to
  bf16 before P @ V and the sums in f32, merged in split order, over the
  bf16 and the int8 pool; the chunk kernel's int8 staging (code x scale
  rounded once to bf16).
* The bf16 head-dim checks of the paged and chunk wrappers.

The coverage tests check a Python copy of the kernels' index arithmetic
(``_decode_walk`` of ``paged_attention.cu``, lines 234-238 and 298;
``_chunk_tiles`` of ``flash_attention_chunk.cu``, lines 176-183), not the
CUDA code: an edit to one must be made in the other.  The CUDA kernels
themselves run only on the card, where ``chip_smoke.py`` holds them
against their plain versions on the cases these tests walk (a sequence
ending inside a split, a window, a prefix to the end of the table).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.alibi import alibi_slopes as j_alibi
from repro.kernels.flash_attention import flash_attention_chunk as j_chunk
from repro.kernels.paged_attention import paged_attention as j_paged
from repro.kernels.paged_attention_quant import \
    paged_attention_quant as j_paged_quant
from repro_torch.core.alibi import alibi_slopes
from repro_torch.kernels.flash_attention import MMA_HEAD_DIMS, check_head_dim
from repro_torch.kernels.paged_attention import (MAX_SPLITS, SPLIT_TOKENS,
                                                 check_heads, plan)


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

TK, BK = 16, 64      # paged_attention.cu: keys per warp tile / staged tile
CHUNK_BK = 64        # flash_attention_chunk.cu: keys per staged tile
TOL = 2e-2


def _decode_walk(p, seq_len, BS, MB, window=0):
    """(keys computed, {split: pages staged}) of one (sequence, KV head),
    derived from blockIdx.z as ``paged_attention_mma_kernel`` derives
    them: a split's live keys, its 64-key staged tiles from the window's
    first warp tile, the 4 warps' 16-key tiles that hold a live key."""
    q_pos = seq_len - 1
    keys, pages = [], {}
    for sp in range(p.splits):
        k_begin = sp * p.pps * BS
        k_end = min(min((sp + 1) * p.pps, MB) * BS, seq_len)
        k_lo = max(k_begin, q_pos - window + 1) if window > 0 else k_begin
        t_begin = k_begin + max(k_lo - k_begin, 0) // TK * TK
        n_tiles = -(-(k_end - t_begin) // BK) if k_end > t_begin else 0
        for it in range(n_tiles):
            t0 = t_begin + it * BK
            pages.setdefault(sp, set()).update(
                k // BS for k in range(t0, min(t0 + BK, k_end)))
            for w in range(BK // TK):
                k0 = t0 + w * TK
                if k0 < k_end and (window <= 0 or k0 + TK - 1 > q_pos - window):
                    keys += [k for k in range(k0, k0 + TK) if k < k_end
                             and (window <= 0 or q_pos - k < window)]
    return keys, pages


@pytest.mark.parametrize("MB,BS", [(64, 16), (4, 16), (8, 32)])
@pytest.mark.parametrize("B", [1, 8])
def test_decode_plan_covers_every_live_page_once(B, MB, BS):
    KV, G, D = 2, 6, 128
    p = plan(B, KV, G, D, MB, BS)
    assert p.splits * p.pps >= MB > (p.splits - 1) * p.pps
    assert p.grid == (B, KV, p.splits) and p.launches == 1
    assert p.scratch == (B, KV, p.splits, G, D + 2)
    assert p.splits <= MAX_SPLITS
    assert p.pps * BS >= min(SPLIT_TOKENS, MB * BS)
    if (B, MB, BS) == (8, 64, 16):          # the serving shape
        assert math.prod(p.grid) >= 64
    for seq_len in range(MB * BS + 1):
        keys, pages = _decode_walk(p, seq_len, BS, MB)
        assert sorted(keys) == list(range(seq_len)), seq_len
        live = -(-seq_len // BS)
        seen = sorted(pg for s in pages.values() for pg in s)
        assert seen == list(range(live)), seq_len   # once each, none past


@pytest.mark.parametrize("window", [1, 100, 200])
def test_decode_walk_covers_the_window_once(window):
    MB, BS = 64, 16
    p = plan(8, 2, 6, 128, MB, BS)
    for seq_len in range(0, MB * BS + 1, 7):
        keys, _ = _decode_walk(p, seq_len, BS, MB, window)
        assert sorted(keys) == list(range(max(0, seq_len - window),
                                          seq_len)), seq_len


def _chunk_tiles(q0, BQ, W, q_off, tlen, MB, BS, window):
    """Key positions of every tile one block of the bf16 chunk kernel
    stages, as ``chunk_attention_mma_kernel`` derives them."""
    n_pool, n_raw = min(q_off, MB * BS), min(W, tlen - q_off)
    q_lo, q_hi = q_off + q0, q_off + min(q0 + BQ, W) - 1
    k_lo = max(0, q_lo - window + 1) if window > 0 else 0
    p_begin, p_end = k_lo // CHUNK_BK, -(-n_pool // CHUNK_BK)
    r_begin = max(0, k_lo - q_off) // CHUNK_BK
    r_end = min(max(n_raw, 0) + CHUNK_BK - 1, q_hi - q_off + CHUNK_BK) \
        // CHUNK_BK
    tiles = [range(t * CHUNK_BK, min((t + 1) * CHUNK_BK, n_pool))
             for t in range(p_begin, p_end)]
    tiles += [range(q_off + j * CHUNK_BK,
                    q_off + min((j + 1) * CHUNK_BK, n_raw))
              for j in range(r_begin, r_end)]
    return tiles


@pytest.mark.parametrize("q_off,n,window", [
    (0, 256, 0), (5, 256, 0), (300, 100, 0), (768, 256, 0), (1000, 24, 0),
    (300, 256, 200), (768, 256, 64)])
def test_chunk_tiles_cover_every_visible_key_once(q_off, n, window):
    W, MB, BS, BQ = 256, 64, 16, 64     # BQ: 4 warps of 16 query tokens
    tlen = q_off + n
    for q0 in range(0, W, BQ):
        tiles = _chunk_tiles(q0, BQ, W, q_off, tlen, MB, BS, window)
        staged = [k for t in tiles for k in t]
        assert len(staged) == len(set(staged))       # each key once
        for qi in range(q0, min(q0 + BQ, n)):
            q_pos = q_off + qi
            want = {k for k in range(q_pos + 1)
                    if window <= 0 or q_pos - k < window}
            assert want <= set(staged), (q0, qi)


# ------------------------------------------------ the split combine, emulated

def _pair(a, dtype=jnp.bfloat16):
    j = jnp.asarray(a, dtype)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32)))


def _int8_pool(rng, shape):
    """Normal K or V blocks [NB, BS, KV, D] quantized as the serving path
    writes them: int8 codes and one f32 scale (max |x| / 127) per block
    and KV head."""
    x = rng.normal(size=shape).astype(np.float32)
    scale = np.abs(x).max(axis=(1, 3)) / 127.0
    codes = np.round(x / scale[:, None, :, None]).astype(np.int8)
    return codes, scale.astype(np.float32)


def _emulate_split_decode(q, kc, vc, seq_len, p, BS, MB, slopes, window):
    """One (sequence, KV head) as the bf16 decode kernel computes it: per
    split, scores in f32 on bf16 inputs, ALiBi by max(q_pos - k_pos, 0), P
    rounded to bf16 before P @ V, row sums in f32; then the partials
    merged in split order.  q [G, D]; kc / vc [MB * BS, D] (bf16 values in
    f32); slopes [G] or None."""
    G, D = q.shape
    q_pos = seq_len - 1
    parts = []
    for sp in range(p.splits):
        k_end = min(min((sp + 1) * p.pps, MB) * BS, seq_len)
        keys = torch.arange(sp * p.pps * BS, max(k_end, sp * p.pps * BS))
        if window > 0:
            keys = keys[keys > q_pos - window]
        if len(keys) == 0:
            continue                                   # an empty partial
        s = (q @ kc[keys].T) / math.sqrt(D)
        if slopes is not None:
            s = s - slopes[:, None] * (q_pos - keys).clamp(min=0)[None]
        m = s.amax(-1)
        pr = torch.exp(s - m[:, None])
        parts.append((m, pr.sum(-1), pr.bfloat16().float() @ vc[keys]))
    if not parts:
        return torch.zeros((G, D))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    L = sum(l * torch.exp(m - M) for m, l, _ in parts)
    O = sum(o * torch.exp(m - M)[:, None] for m, _, o in parts)
    return (O / L[:, None]).bfloat16().float()


@pytest.mark.parametrize("case", ["plain", "alibi", "window"])
@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_split_combine_matches_pallas(pool, case):
    """seq_len 0, a partial page, a split's last key, the first key of the
    next split, and a long row, over 3 splits of 8 pages."""
    rng = np.random.default_rng(3 if pool == "int8" else 4)
    B, H, KV, D, BS, MB = 5, 12, 2, 64, 16, 24
    G, NB = H // KV, B * MB + 2
    p = plan(B, KV, G, D, MB, BS)
    assert p.splits == 3
    sl = np.array([0, 13, 128, 129, 300], np.int32)
    bt = rng.permutation(NB)[:B * MB].reshape(B, MB).astype(np.int32)
    qj, qt = _pair(rng.normal(size=(B, H, D)))
    kw, slopes = {}, None
    if case == "alibi":
        kw["alibi_slopes"] = j_alibi(H)
        slopes = alibi_slopes(H)
    window = 100 if case == "window" else 0
    if pool == "int8":
        (c0, s0), (c1, s1) = (_int8_pool(rng, (NB, BS, KV, D))
                              for _ in range(2))
        codes, scales = (c0, c1), (s0, s1)
        want = j_paged_quant(qj, jnp.asarray(codes[0]), jnp.asarray(scales[0]),
                             jnp.asarray(codes[1]), jnp.asarray(scales[1]),
                             jnp.asarray(bt), jnp.asarray(sl),
                             kw.get("alibi_slopes"), sliding_window=window,
                             interpret=True)
        # the kernel's staging: code x scale in f32, rounded once to bf16
        kv = [(torch.from_numpy(c).float()
               * torch.from_numpy(s)[:, None, :, None]).bfloat16().float()
              for c, s in zip(codes, scales)]
    else:
        pools = [_pair(rng.normal(size=(NB, BS, KV, D))) for _ in range(2)]
        want = j_paged(qj, pools[0][0], pools[1][0], jnp.asarray(bt),
                       jnp.asarray(sl), kw.get("alibi_slopes"),
                       sliding_window=window, interpret=True)
        kv = [t for _, t in pools]
    got = torch.zeros((B, H, D))
    for b in range(B):
        kc, vc = (x[torch.from_numpy(bt[b]).long()].reshape(MB * BS, KV, D)
                  for x in kv)
        for h in range(KV):
            got[b, h * G:(h + 1) * G] = _emulate_split_decode(
                qt[b, h * G:(h + 1) * G], kc[:, h], vc[:, h], int(sl[b]), p,
                BS, MB, None if slopes is None else slopes[h * G:(h + 1) * G],
                window)
    want = np.asarray(want, np.float32)
    assert (got[0] == 0).all()               # seq_len 0: exact zeros
    np.testing.assert_allclose(got[1:].numpy(), want[1:], atol=TOL, rtol=0)


def test_chunk_int8_staging_matches_pallas():
    """The chunk kernel's int8 prefix (code x page scale rounded once to
    bf16, then the bf16 attention with P rounded to bf16) against the
    Pallas chunk kernel's quantized branch, which dequantizes in f32."""
    rng = np.random.default_rng(7)
    W, H, KV, D, BS, MB = 24, 12, 2, 64, 8, 12
    G, NB = H // KV, MB + 3
    q_off, n = 37, 20                        # unaligned, a partial chunk
    qj, qt = _pair(rng.normal(size=(1, W, H, D)))
    krj, krt = _pair(rng.normal(size=(1, W, KV, D)))
    vrj, vrt = _pair(rng.normal(size=(1, W, KV, D)))
    (c0, s0), (c1, s1) = (_int8_pool(rng, (NB, BS, KV, D))
                          for _ in range(2))
    codes, scales = (c0, c1), (s0, s1)
    bt = rng.permutation(NB)[:MB][None].astype(np.int32)
    want = np.asarray(j_chunk(
        qj, jnp.asarray(codes[0]), jnp.asarray(codes[1]), jnp.asarray(bt),
        jnp.int32(q_off), jnp.int32(q_off + n), krj, vrj,
        k_scales=jnp.asarray(scales[0]), v_scales=jnp.asarray(scales[1]),
        block_q=8, interpret=True), np.float32)
    tbl = torch.from_numpy(bt[0]).long()
    k, v = ((torch.from_numpy(c).float()
             * torch.from_numpy(s)[:, None, :, None]).bfloat16().float()[tbl]
            .reshape(MB * BS, KV, D)[:q_off]
            for c, s in zip(codes, scales))
    k = torch.cat([k, krt[0]])               # the chunk's raw keys follow
    v = torch.cat([v, vrt[0]])
    pos = torch.arange(q_off + W)
    q_pos = q_off + torch.arange(W)
    live = (pos[None] <= q_pos[:, None]) & (pos[None] < q_off + n)
    kg = k.repeat_interleave(G, 1)           # [keys, H, D]
    vg = v.repeat_interleave(G, 1)
    s = torch.einsum("qhd,khd->hqk", qt[0], kg) / math.sqrt(D)
    s = s.masked_fill(~live[None], -1e30)
    pr = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("hqk,khd->qhd", pr.bfloat16().float(), vg)
    got = (o / pr.sum(-1).T[..., None]).bfloat16().float()
    np.testing.assert_allclose(got[:n].numpy(), want[0, :n], atol=TOL,
                               rtol=0)


# ----------------------------------------------------------- head-dim checks

@pytest.mark.parametrize("D,dtype,ok", [
    (128, torch.bfloat16, True), (64, torch.bfloat16, True),
    (96, torch.bfloat16, False), (16, torch.bfloat16, False),
    (120, torch.bfloat16, False), (120, torch.float32, True),
    (16, torch.float32, True), (96, torch.float32, True),
    (12, torch.float32, False)])
@pytest.mark.parametrize("kernel", ["paged_attention",
                                    "flash_attention_chunk"])
def test_attention_head_dim_checks(kernel, D, dtype, ok):
    """bf16 takes the built head dims only (no fallback; 120 is built for
    the static kernel alone), f32 any multiple of 8."""
    assert MMA_HEAD_DIMS[kernel] == (64, 128)
    if kernel == "paged_attention":
        def check():
            check_heads(12, 2, D, dtype)
    else:
        def check():
            check_head_dim(D, dtype, kernel)
    if ok:
        check()
    else:
        with pytest.raises(ValueError, match="head_dim"):
            check()


def test_decode_heads_check_refuses_more_than_16_groups():
    check_heads(32, 2, 128, torch.bfloat16)              # G = 16
    with pytest.raises(ValueError, match="G = H / KV"):
        check_heads(34, 2, 128, torch.bfloat16)          # G = 17
