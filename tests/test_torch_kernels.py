"""The port's kernel entry points (``repro_torch.kernels.ops``) on the CPU
against the JAX package: its Pallas kernels in interpret mode and its
``ref.py`` oracles, on the same numpy inputs.

On the CPU the port's ops take their plain versions; the CUDA kernels
themselves are held against those plain versions on the card by
``chip_smoke.py``.  Tolerances are those of ``tests/test_kernels.py``:
5e-5 for f32, 2e-2 for bf16.  An int8 pool is compared at the f32
tolerance: both sides dequantize the same codes and scales exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.alibi import alibi_slopes as j_alibi
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.flash_attention import flash_attention_chunk as j_chunk
from repro.kernels.gptq_matmul import gptq_matmul as j_gptq
from repro.kernels.paged_attention import paged_attention as j_paged
from repro.kernels.paged_attention_quant import \
    paged_attention_quant as j_paged_quant
from repro.models.ssm import CHUNK as J_CHUNK
from repro.models.ssm import _chunked_time_scan as j_time_scan
from repro_torch.core.alibi import alibi_slopes
from repro_torch.core.quant import dequantize, pack_int4, unpack_int4
from repro_torch.kernels import ops, ref


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

TOL = {"float32": 5e-5, "bfloat16": 2e-2, "int8": 5e-5}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, JDT[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        TDT[dtype])


def _close(t: torch.Tensor, j, dtype: str, rows=None):
    a = t.float().numpy()
    b = np.asarray(jnp.asarray(j, jnp.float32))
    if rows is not None:
        a, b = a[rows], b[rows]
    np.testing.assert_allclose(a, b, atol=TOL[dtype], rtol=0)


def test_alibi_slopes_match():
    for h in (4, 12, 6):
        np.testing.assert_array_equal(alibi_slopes(h).numpy(),
                                      np.asarray(j_alibi(h)))


def _int8_pool(rng, shape):
    """Random int8 codes [..., NB, BS, KV, D] and f32 scales [..., NB, KV]
    as (jax, torch) pairs."""
    codes = rng.integers(-127, 128, shape).astype(np.int8)
    scales = rng.uniform(0.005, 0.05, shape[:-3] + shape[-2:-1]) \
        .astype(np.float32)
    return ((jnp.asarray(codes), torch.from_numpy(codes)),
            (jnp.asarray(scales), torch.from_numpy(scales)))


def _paged_pools(rng, shape, dtype):
    """One layer's K and V pools in ``dtype``, or int8 codes + scales:
    returns {"j": jax args, "t": torch args} in the kernels' order."""
    if dtype == "int8":
        (kj, kt), (ksj, kst) = _int8_pool(rng, shape)
        (vj, vt), (vsj, vst) = _int8_pool(rng, shape)
        return {"j": (kj, ksj, vj, vsj), "t": (kt, kst, vt, vst)}
    kj, kt = _pair(rng.normal(size=shape), dtype)
    vj, vt = _pair(rng.normal(size=shape), dtype)
    return {"j": (kj, vj), "t": (kt, vt)}


def _paged_all(q, tq, pools, bt, sl, dtype, **kw):
    """(port op, Pallas interpret, JAX ref) of the paged decode kernel of
    the pool format, on the same inputs."""
    sl_j = kw.pop("alibi_j", None)
    sl_t = kw.pop("alibi_t", None)
    tbt, tsl = torch.from_numpy(bt), torch.from_numpy(sl)
    jbt, jsl = jnp.asarray(bt), jnp.asarray(sl)
    if dtype == "int8":
        out = ops.paged_attention_quant(tq, *pools["t"], tbt, tsl, sl_t, **kw)
        pal = j_paged_quant(q, *pools["j"], jbt, jsl, sl_j, interpret=True,
                            **kw)
        orc = jref.paged_attention_quant_ref(q, *pools["j"], jbt, jsl,
                                             alibi_slopes=sl_j, **kw)
    else:
        out = ops.paged_attention(tq, *pools["t"], tbt, tsl, sl_t, **kw)
        pal = j_paged(q, *pools["j"], jbt, jsl, sl_j, interpret=True, **kw)
        orc = jref.paged_attention_ref(q, *pools["j"], jbt, jsl,
                                       alibi_slopes=sl_j, **kw)
    return out, pal, orc


# ------------------------------------------------------------ paged decode

@pytest.mark.parametrize("H,KV", [(4, 4), (12, 2)])          # G = 1, 6
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_paged_attention_vs_pallas_and_ref(H, KV, dtype):
    """bf16/f32 pools through ``paged_attention``; int8 pools (f32 q)
    through ``paged_attention_quant``."""
    rng = np.random.default_rng(11 + H)
    B, D, BS, MB = 4, 32, 8, 5
    NB = B * MB + 3
    q, tq = _pair(rng.normal(size=(B, H, D)),
                  "float32" if dtype == "int8" else dtype)
    pools = _paged_pools(rng, (NB, BS, KV, D), dtype)
    bt = rng.permutation(NB)[:B * MB].reshape(B, MB).astype(np.int32)
    # seq_len 0 (inactive) / partial page / page boundary / full table
    sl = np.array([0, 13, 2 * BS, MB * BS], np.int32)
    out, pal, orc = _paged_all(q, tq, pools, bt, sl, dtype)
    _close(out, orc, dtype)                 # every row, seq_len 0 included
    live = sl > 0                           # the kernels write zeros at 0
    _close(out, pal, dtype, rows=live)
    np.testing.assert_array_equal(np.asarray(pal, np.float32)[~live], 0)


@pytest.mark.parametrize("H,KV", [(12, 12), (12, 2)])        # G = 1, 6
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_paged_attention_alibi_and_window(H, KV, dtype):
    rng = np.random.default_rng(5)
    B, D, BS, MB = 2, 16, 8, 5
    NB = B * MB
    q, tq = _pair(rng.normal(size=(B, H, D)), "float32")
    pools = _paged_pools(rng, (NB, BS, KV, D), dtype)
    bt = rng.permutation(NB).reshape(B, MB).astype(np.int32)
    sl = np.array([37, 12], np.int32)
    out, pal, orc = _paged_all(q, tq, pools, bt, sl, dtype,
                               alibi_j=j_alibi(H), alibi_t=alibi_slopes(H),
                               sliding_window=16)
    _close(out, pal, "float32")
    _close(out, orc, "float32")


# ------------------------------------------------------------ chunk prefill

@pytest.mark.parametrize("H,KV", [(2, 2), (12, 2)])          # G = 1, 6
@pytest.mark.parametrize("q_off", [0, 16, 5])   # 0 / aligned / unaligned
@pytest.mark.parametrize("alibi,win", [(False, 0), (True, 0), (False, 12)])
@pytest.mark.parametrize("pool", ["float32", "int8"])
def test_chunk_prefill_attention_vs_pallas_and_ref(H, KV, q_off, alibi, win,
                                                   pool):
    rng = np.random.default_rng(3 + q_off + H)
    L, NB, BS, D, MB, W = 2, 12, 8, 16, 6, 16
    total = q_off + int(rng.integers(1, W + 1))
    q, tq = _pair(rng.normal(size=(1, W, H, D)), "float32")
    kr, tkr = _pair(rng.normal(size=(1, W, KV, D)), "float32")
    vr, tvr = _pair(rng.normal(size=(1, W, KV, D)), "float32")
    if pool == "int8":
        (kp, tkp), (ks, tks) = _int8_pool(rng, (L, NB, BS, KV, D))
        (vp, tvp), (vs, tvs) = _int8_pool(rng, (L, NB, BS, KV, D))
    else:
        kp, tkp = _pair(rng.normal(size=(L, NB, BS, KV, D)), "float32")
        vp, tvp = _pair(rng.normal(size=(L, NB, BS, KV, D)), "float32")
        ks = tks = vs = tvs = None
    bt = rng.permutation(NB)[:MB][None].astype(np.int32)
    layer = 1
    out = ops.chunk_prefill_attention(
        tq, tkp, tvp, tks, tvs, layer, torch.from_numpy(bt),
        torch.tensor(q_off, dtype=torch.int32),
        torch.tensor(total, dtype=torch.int32), tkr, tvr,
        alibi_slopes(H) if alibi else None, sliding_window=win)
    sl = j_alibi(H) if alibi else None
    pal = j_chunk(q, kp[layer], vp[layer], jnp.asarray(bt), jnp.int32(q_off),
                  jnp.int32(total), kr, vr, sl,
                  k_scales=None if ks is None else ks[layer],
                  v_scales=None if vs is None else vs[layer],
                  sliding_window=win, block_q=8, interpret=True)
    orc = jref.chunk_prefill_attention_ref(
        q, kp, vp, ks, vs, layer, jnp.asarray(bt), jnp.int32(q_off),
        jnp.int32(total), kr, vr, alibi_slopes=sl, sliding_window=win)
    live = total - q_off              # padded query rows: garbage on both
    _close(out[:, :live], pal[:, :live], "float32")
    _close(out[:, :live], orc[:, :live], "float32")


def test_chunk_prefill_attention_bf16():
    rng = np.random.default_rng(9)
    L, NB, BS, H, KV, D, MB, W, q_off = 1, 10, 8, 12, 2, 32, 5, 16, 11
    total = q_off + 9
    q, tq = _pair(rng.normal(size=(1, W, H, D)), "bfloat16")
    kr, tkr = _pair(rng.normal(size=(1, W, KV, D)), "bfloat16")
    vr, tvr = _pair(rng.normal(size=(1, W, KV, D)), "bfloat16")
    kp, tkp = _pair(rng.normal(size=(L, NB, BS, KV, D)), "bfloat16")
    vp, tvp = _pair(rng.normal(size=(L, NB, BS, KV, D)), "bfloat16")
    bt = rng.permutation(NB)[:MB][None].astype(np.int32)
    out = ops.chunk_prefill_attention(
        tq, tkp, tvp, None, None, 0, torch.from_numpy(bt),
        torch.tensor(q_off, dtype=torch.int32),
        torch.tensor(total, dtype=torch.int32), tkr, tvr)
    pal = j_chunk(q, kp[0], vp[0], jnp.asarray(bt), jnp.int32(q_off),
                  jnp.int32(total), kr, vr, block_q=8, interpret=True)
    _close(out[:, :total - q_off], pal[:, :total - q_off], "bfloat16")


# ------------------------------------------------------------ static prefill

@pytest.mark.parametrize("H,KV", [(4, 4), (12, 2)])          # G = 1, 6
@pytest.mark.parametrize("case", [
    dict(Sq=16, Sk=16),                                 # causal
    dict(Sq=8, Sk=20, q_offset=12),                     # q_offset > 0, Sq < Sk
    dict(Sq=16, Sk=16, sliding_window=5),               # sliding band
    dict(Sq=16, Sk=16, alibi=True),                     # ALiBi
    dict(Sq=13, Sk=13, alibi=True, sliding_window=6),   # ragged Sk
    dict(Sq=12, Sk=20, causal=False),                   # bidirectional
], ids=["causal", "offset", "window", "alibi", "ragged", "noncausal"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_vs_pallas_and_ref(H, KV, case, dtype):
    case = dict(case)
    Sq, Sk = case.pop("Sq"), case.pop("Sk")
    alibi = case.pop("alibi", False)
    rng = np.random.default_rng(Sq + Sk + H)
    B, D = 2, 16
    q, tq = _pair(rng.normal(size=(B, Sq, H, D)), dtype)
    k, tk = _pair(rng.normal(size=(B, Sk, KV, D)), dtype)
    v, tv = _pair(rng.normal(size=(B, Sk, KV, D)), dtype)
    out = ops.flash_attention(tq, tk, tv,
                              alibi_slopes(H) if alibi else None, **case)
    sl = j_alibi(H) if alibi else None
    pal = j_flash(q, k, v, sl, block_q=8, block_k=8, interpret=True, **case)
    orc = jref.flash_attention_ref(q, k, v, alibi_slopes=sl, **case)
    _close(out, pal, dtype)
    _close(out, orc, dtype)


@pytest.mark.parametrize("case", [
    dict(Sq=24, Sk=24),                                 # causal
    dict(Sq=24, Sk=24, sliding_window=7),               # sliding band
    dict(Sq=10, Sk=24, q_offset=14, sliding_window=9),  # band at an offset
], ids=["causal", "window", "offset-window"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_head_dim_120_vs_pallas_and_ref(case, dtype):
    """h2o-danube-3-4b's head dim (120: not a multiple of 16, which the
    bf16 kernel stages padded to 128) on the CPU path, 32 query heads over
    8 KV heads as the model has them."""
    case = dict(case)
    Sq, Sk = case.pop("Sq"), case.pop("Sk")
    rng = np.random.default_rng(Sq + Sk + 120)
    B, H, KV, D = 1, 32, 8, 120
    q, tq = _pair(rng.normal(size=(B, Sq, H, D)), dtype)
    k, tk = _pair(rng.normal(size=(B, Sk, KV, D)), dtype)
    v, tv = _pair(rng.normal(size=(B, Sk, KV, D)), dtype)
    out = ops.flash_attention(tq, tk, tv, None, **case)
    pal = j_flash(q, k, v, None, block_q=8, block_k=8, interpret=True,
                  **case)
    orc = jref.flash_attention_ref(q, k, v, **case)
    _close(out, pal, dtype)
    _close(out, orc, dtype)


@pytest.mark.parametrize("case", [
    dict(Sq=20, Sk=20, sliding_window=8),               # sliding band
    dict(Sq=8, Sk=20, q_offset=12, sliding_window=6),   # band at an offset
], ids=["window", "offset-window"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_head_dim_256_vs_pallas_and_ref(case, dtype):
    """recurrentgemma-2b's sliding layers: head dim 256, 10 query heads
    over 1 KV head (G = 10), windowed, on the CPU path."""
    case = dict(case)
    Sq, Sk = case.pop("Sq"), case.pop("Sk")
    rng = np.random.default_rng(Sq + Sk + 256)
    B, H, KV, D = 2, 10, 1, 256
    q, tq = _pair(rng.normal(size=(B, Sq, H, D)), dtype)
    k, tk = _pair(rng.normal(size=(B, Sk, KV, D)), dtype)
    v, tv = _pair(rng.normal(size=(B, Sk, KV, D)), dtype)
    out = ops.flash_attention(tq, tk, tv, None, **case)
    pal = j_flash(q, k, v, None, block_q=8, block_k=8, interpret=True,
                  **case)
    orc = jref.flash_attention_ref(q, k, v, **case)
    _close(out, pal, dtype)
    _close(out, orc, dtype)


# ------------------------------------------------------------ int4 matmul

def _codes(rng, K, N):
    """Random int4 codes with the top nibble at 15 in a band of columns:
    those words are negative as int32 and unpack only with unsigned
    shifts."""
    c = rng.integers(0, 16, (K, N)).astype(np.uint8)
    c[7::8, : N // 2] = 15
    return c


@pytest.mark.parametrize("M,K,N,gs", [(8, 64, 48, 32), (5, 96, 40, 16),
                                      (16, 128, 64, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_matmul_vs_pallas_and_ref(M, K, N, gs, dtype):
    rng = np.random.default_rng(M + K)
    codes = _codes(rng, K, N)
    qw = pack_int4(codes)
    assert (qw < 0).any()                     # the sign case is exercised
    scales = rng.uniform(0.01, 0.1, (K // gs, N)).astype(np.float32)
    zeros = rng.integers(0, 16, (K // gs, N)).astype(np.float32)
    g_idx = (np.arange(K) // gs).astype(np.int32)
    x, tx = _pair(rng.normal(size=(M, K)), dtype)
    jp = {"qweight": jnp.asarray(qw), "scales": jnp.asarray(scales),
          "zeros": jnp.asarray(zeros), "g_idx": jnp.asarray(g_idx)}
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    out = ops.quant_matmul(tx, tp)
    orc = jref.quant_matmul_ref(x, jp)
    pal = j_gptq(x, jp["qweight"], jp["scales"], jp["zeros"], interpret=True)
    scale = float(np.abs(np.asarray(orc, np.float32)).max())
    for j in (orc, pal):
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(j, np.float32),
                                   atol=TOL[dtype] * scale, rtol=2e-2)
    # the kernel's own plain version (f32 dequant) against the Pallas body
    own = ref.gptq_matmul_ref(tx, tp["qweight"], tp["scales"], tp["zeros"])
    np.testing.assert_allclose(own.float().numpy(),
                               np.asarray(pal, np.float32),
                               atol=TOL[dtype] * scale, rtol=2e-2)


def test_int4_pack_unpack_and_grouped_dequant_match_jax():
    from repro.core.quant import dequantize as j_deq
    from repro.core.quant import pack_int4 as j_pack
    from repro.core.quant import unpack_int4 as j_unpack
    rng = np.random.default_rng(1)
    K, N, gs = 64, 24, 16
    codes = _codes(rng, K, N)
    qw = pack_int4(codes)
    np.testing.assert_array_equal(qw, j_pack(codes))
    np.testing.assert_array_equal(unpack_int4(torch.from_numpy(qw), K),
                                  np.asarray(j_unpack(jnp.asarray(qw), K)))
    # a permuted (act-order style) g_idx: the plain path gathers through it
    g_idx = rng.permutation(np.arange(K) // gs).astype(np.int32)
    p = {"qweight": qw, "g_idx": g_idx,
         "scales": rng.uniform(0.01, 0.1, (K // gs, N)).astype(np.float32),
         "zeros": rng.integers(0, 16, (K // gs, N)).astype(np.float32)}
    want = np.asarray(j_deq({k: jnp.asarray(v) for k, v in p.items()}, K,
                            jnp.float32))
    got = dequantize({k: torch.from_numpy(v) for k, v in p.items()}, K,
                     torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers launch on CUDA tensors or raise; they never fall back
    to the plain version (the CPU path lives in ``ops`` alone)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_chunk, flash_attention_chunk_int8)
    from repro_torch.kernels.gptq_matmul import gptq_matmul
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.paged_attention_quant import \
        paged_attention_quant
    from repro_torch.kernels.time_scan import linear_scan, selective_scan
    q = torch.zeros(2, 4, 16)
    pool = torch.zeros(3, 8, 2, 16)
    pool8 = torch.zeros(3, 8, 2, 16, dtype=torch.int8)
    scales = torch.ones(3, 2)
    bt = torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention(q, pool, pool, bt, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_quant(q, pool8, scales, pool8, scales, bt,
                              torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        gptq_matmul(torch.zeros(2, 16), torch.zeros(2, 4, dtype=torch.int32),
                    torch.zeros(1, 4), torch.zeros(1, 4))
    zero = torch.tensor(0, dtype=torch.int32)
    chunk = (torch.zeros(1, 8, 4, 16), torch.zeros(1, 3, dtype=torch.int32),
             zero, zero, torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_chunk(chunk[0], pool, pool, *chunk[1:])
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_chunk_int8(chunk[0], pool8, pool8, *chunk[1:],
                                   k_scales=scales, v_scales=scales)
    with pytest.raises(ValueError, match="int8 pools"):
        flash_attention_chunk_int8(chunk[0], pool8, pool8, *chunk[1:])
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(torch.zeros(1, 8, 4, 16), torch.zeros(1, 8, 2, 16),
                        torch.zeros(1, 8, 2, 16))
    scan = torch.zeros(2, 5, 8)
    with pytest.raises(ValueError, match="CUDA"):
        selective_scan(scan, scan, torch.zeros(2, 5, 16),
                       torch.zeros(2, 5, 16), torch.zeros(8, 16),
                       torch.zeros(2, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        linear_scan(scan, scan, torch.zeros(2, 8))
    kernels = (paged_attention, paged_attention_quant, gptq_matmul,
               flash_attention_chunk, flash_attention_chunk_int8,
               flash_attention, selective_scan, linear_scan,
               selective_scan.bwd, selective_scan.fused_bwd, linear_scan.bwd)
    assert set(ops.KERNELS) == set(kernels)
    assert [k.launches for k in kernels] == [0] * len(kernels)
    with pytest.raises(ValueError, match="device"):
        ops.paged_attention(q.to("meta"), pool, pool, None, None)


@pytest.mark.parametrize("S", [1, 37, 300])
def test_linear_scan_ref_matches_the_reference_scan(S):
    """``linear_scan_ref`` (the RG-LRU's recurrence, ``ops.linear_scan``
    on the CPU) against the reference's chunked ``lax.scan`` of its step
    ``h = a h + g`` (300 steps cross its 128-step chunks), with
    state-transparent positions (a = 1, g = 0) among them.  The final
    state is held to the reference's last step, and to the reference's
    carry only where no padded last chunk feeds it (ROADMAP C14)."""
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, (3, S, 40)).astype(np.float32)
    g = rng.normal(size=(3, S, 40)).astype(np.float32)
    a[1, S // 2:], g[1, S // 2:] = 1.0, 0.0
    h0 = rng.normal(size=(3, 40)).astype(np.float32)

    def step(h, x_t):
        a_t, g_t = x_t
        h = a_t * h + g_t
        return h, h

    jh, jhs = j_time_scan(step, jnp.asarray(h0),
                          (jnp.asarray(a.transpose(1, 0, 2)),
                           jnp.asarray(g.transpose(1, 0, 2))), J_CHUNK)
    hs, h = ops.linear_scan(torch.from_numpy(a), torch.from_numpy(g),
                            torch.from_numpy(h0))
    want = np.asarray(jhs).transpose(1, 0, 2)
    _close(hs, want, "float32")
    _close(h, want[:, -1], "float32")
    assert torch.equal(h, hs[:, -1])
    if not (S > J_CHUNK and S % J_CHUNK):
        _close(h, jh, "float32")
    if S > 1:                     # the transparent half of row 1 holds
        held = hs[1, S // 2 - 1:S // 2].expand(S - S // 2, -1)
        assert torch.equal(hs[1, S // 2:], held)
