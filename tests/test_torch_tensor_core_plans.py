"""Host-side logic of the port's tensor-core kernels, on the CPU.

* The W4A16 planner (``kernels/gptq_matmul.plan``): for every qwen2-1.5b
  linear at decode, chunk and wave sizes, the blocks of the grid cover each
  (row, column, k) of the product exactly once, and K is split across
  blocks only when the output tiles alone leave the SMs' block slots
  idle (``tests/test_torch_gptq_hopper_plan.py`` holds the wgmma body's
  plan at every shape ``chip_smoke.py`` checks).
* The bf16 rounding the two kernels add, emulated in plain torch, against
  the JAX package's Pallas kernels (interpret mode) at the bf16 tolerance
  of ``tests/test_kernels.py`` (2e-2): the matmul rounds each dequantized
  weight to bf16 once; the attention rounds P to bf16 before P @ V.
* The static attention wrapper's head-dim check.

The CUDA kernels themselves run only on the card (``chip_smoke.py``).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.gptq_matmul import gptq_matmul as j_gptq
from repro_torch.core.quant import pack_int4, unpack_int4
from repro_torch.kernels.flash_attention import MMA_HEAD_DIMS, check_head_dim
from repro_torch.kernels.gptq_matmul import BK, PACK, plan


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

LINEARS = {"wq/wo": (1536, 1536), "wk/wv": (1536, 256),
           "gate/up": (1536, 8960), "down": (8960, 1536)}   # (K, N)
SMS = 132                                                     # H100 SXM


def _blocks(p, M, K, N):
    """The (rows, columns, k) ranges of every block of the grid, derived
    from ``blockIdx`` as ``gptq_wgmma_kernel`` derives them: x walks N by
    BN, y walks M by NT, z walks K by kt_per tiles of BK."""
    kt = math.ceil(K / BK)
    for z in range(p.splits):
        k0, k1 = z * p.kt_per * BK, min((z + 1) * p.kt_per, kt) * BK
        for y in range(math.ceil(M / p.bm)):
            for x in range(math.ceil(N / p.bn)):
                yield ((y * p.bm, min((y + 1) * p.bm, M)),
                       (x * p.bn, min((x + 1) * p.bn, N)),
                       (k0, min(k1, K)))


@pytest.mark.parametrize("M", [1, 8, 256, 7680])
@pytest.mark.parametrize("linear", sorted(LINEARS))
def test_gptq_plan_covers_every_output_once(linear, M):
    K, N = LINEARS[linear]
    p = plan(M, K, N, 32, SMS)
    assert p.route == "wgmma" and p.bm == p.tile
    assert p.tile == 8 if M <= 8 else 64 <= p.tile <= 256 or M <= 64
    gx, gy = math.ceil(N / p.bn), math.ceil(M / p.bm)
    slots = SMS * (2 if p.tile <= 32 else 1)
    assert p.splits == 1 or gx * gy < slots
    assert p.launches == 1
    rows = np.zeros(M, np.int64)
    cols = np.zeros(N, np.int64)
    k_cover = np.zeros((gy, gx, K), np.int16)
    for (m0, m1), (n0, n1), (k0, k1) in _blocks(p, M, K, N):
        assert m0 < m1 and n0 < n1 and k0 < k1, "an empty block"
        assert k0 % BK == 0
        k_cover[m0 // p.bm, n0 // p.bn, k0:k1] += 1
        if k0 == 0:
            rows[m0:m1] += n1 - n0
            cols[n0:n1] += m1 - m0
    assert (rows == N).all() and (cols == M).all()   # each (m, n) once
    assert (k_cover == 1).all()                      # each k once per tile


@pytest.mark.parametrize("gs", [8, 16, 24, 32, 64, 128])
def test_gptq_plan_stages_every_group_of_a_k_tile(gs):
    """``sr`` scale rows hold every group a 64-wide k tile touches."""
    K = 3 * 128 * 8                                  # a multiple of each gs
    p = plan(8, K, 256, gs, SMS)
    assert 1 <= p.sr <= BK // PACK
    for k0 in range(0, K, BK):
        groups = {k // gs for k in range(k0, min(k0 + BK, K))}
        assert len(groups) <= p.sr
        assert min(groups) == k0 // gs


def _codes(rng, K, N):
    c = rng.integers(0, 16, (K, N)).astype(np.uint8)
    c[7::8, : N // 2] = 15                   # negative int32 words
    return c


@pytest.mark.parametrize("M,K,N,gs", [(8, 128, 64, 32), (37, 256, 72, 64)])
def test_gptq_bf16_weight_rounding_within_tolerance(M, K, N, gs):
    """Rounding each f32 dequantized weight to bf16 once (the tensor-core
    bodies' A / B fragments) stays within the bf16 tolerance of the Pallas
    kernel, which multiplies the f32 weight by x in f32."""
    rng = np.random.default_rng(M + K)
    qw = pack_int4(_codes(rng, K, N))
    scales = rng.uniform(0.01, 0.1, (K // gs, N)).astype(np.float32)
    zeros = rng.integers(0, 16, (K // gs, N)).astype(np.float32)
    x = jnp.asarray(rng.normal(size=(M, K)), jnp.bfloat16)
    want = np.asarray(j_gptq(x, jnp.asarray(qw), jnp.asarray(scales),
                             jnp.asarray(zeros), interpret=True), np.float32)
    codes = unpack_int4(torch.from_numpy(qw), K).float()
    s = torch.from_numpy(scales).repeat_interleave(gs, 0)
    z = torch.from_numpy(zeros).repeat_interleave(gs, 0)
    w16 = ((codes - z) * s).bfloat16()
    xt = torch.from_numpy(np.array(x.astype(jnp.float32)))
    got = (xt @ w16.float()).bfloat16().float().numpy()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=2e-2 * scale, rtol=2e-2)


@pytest.mark.parametrize("D", MMA_HEAD_DIMS["flash_attention"])
def test_flash_bf16_probability_rounding_within_tolerance(D):
    """P rounded to bf16 before P @ V (the tensor-core body's A operand),
    with the row sums kept in f32, stays within the bf16 tolerance of the
    Pallas kernel at each built head dim."""
    rng = np.random.default_rng(D)
    B, S, H, KV = 1, 24, 4, 2
    q, k, v = (jnp.asarray(rng.normal(size=sh), jnp.bfloat16)
               for sh in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))
    want = np.asarray(j_flash(q, k, v, None, block_q=8, block_k=8,
                              interpret=True), np.float32)
    qt, kt, vt = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                  for a in (q, k, v))
    kt = kt.repeat_interleave(H // KV, 2)
    vt = vt.repeat_interleave(H // KV, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", qt, kt) / math.sqrt(D)
    s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bhqk,bkhd->bqhd", p.bfloat16().float(), vt)
    got = (o / p.sum(-1).transpose(1, 2)[..., None]).bfloat16().float()
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2, rtol=0)


@pytest.mark.parametrize("D,dtype,ok", [
    (128, torch.bfloat16, True), (64, torch.bfloat16, True),
    (120, torch.bfloat16, True),
    (96, torch.bfloat16, False), (16, torch.bfloat16, False),
    (16, torch.float32, True), (12, torch.float32, False)])
def test_flash_attention_head_dim_check(D, dtype, ok):
    if ok:
        check_head_dim(D, dtype)
    else:
        with pytest.raises(ValueError, match="head_dim"):
            check_head_dim(D, dtype)
