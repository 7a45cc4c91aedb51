"""Plain torch versions of every ported kernel (the ``ref.py`` contract).

These are the semantic definitions the CUDA kernels are held against,
and the path ``kernels/ops.py`` takes for tensors that lie on the CPU.
They repeat the kernels' arithmetic in plain torch ops and are no
yardstick of speed.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.core.gqa import decode_attention, grouped_attention
from repro_torch.core.kv_quant import (KVCache, gather_kv_quant,
                                       kv_gather_bounded)
from repro_torch.core.paged_cache import gather_kv
from repro_torch.core.quant import quant_matmul_ref as _qmm
from repro_torch.core.quant import unpack_int4


def flash_attention_ref(q, k, v, *, causal=True, sliding_window=0,
                        alibi_slopes=None, q_offset=0):
    """[B,S,H,D] x [B,S,KV,D]^2 -> [B,S,H,D]; O(S^2) reference."""
    return grouped_attention(q, k, v, causal=causal,
                             sliding_window=sliding_window,
                             alibi_slopes=alibi_slopes, q_offset=q_offset)


def paged_attention_ref(q, k_pool, v_pool, block_table, seq_lens, *,
                        alibi_slopes=None, sliding_window=0):
    """Decode attention over one layer's paged pool: gather the whole
    table, then the contiguous oracle.  q [B, H, D]; pools
    [NB, BS, KV, D]; block_table [B, MB]; seq_lens [B]."""
    max_len = block_table.shape[1] * k_pool.shape[1]
    kc = gather_kv(k_pool[None], 0, block_table, max_len)
    vc = gather_kv(v_pool[None], 0, block_table, max_len)
    return decode_attention(q, kc, vc, seq_lens, alibi_slopes=alibi_slopes,
                            sliding_window=sliding_window)


def paged_attention_quant_ref(q, k_values, k_scales, v_values, v_scales,
                              block_table, seq_lens, *, alibi_slopes=None,
                              sliding_window=0):
    """Decode attention over one layer's int8 pool: dequantize the
    gathered pages (one f32 scale per block and KV head), then the
    contiguous oracle.  q [B, H, D]; values [NB, BS, KV, D] int8; scales
    [NB, KV] f32; block_table [B, MB]; seq_lens [B]."""
    max_len = block_table.shape[1] * k_values.shape[1]
    kc = gather_kv_quant(k_values[None], k_scales[None], 0, block_table,
                         max_len)
    vc = gather_kv_quant(v_values[None], v_scales[None], 0, block_table,
                         max_len)
    return decode_attention(q, kc, vc, seq_lens, alibi_slopes=alibi_slopes,
                            sliding_window=sliding_window)


def chunk_prefill_attention_ref(q, k_pool, v_pool, k_scales, v_scales,
                                layer, block_table, q_offset, total_len,
                                k_raw, v_raw, *, alibi_slopes=None,
                                sliding_window=0):
    """Chunk-prefill attention: gather the pool's live pages
    (``ceil(total_len / BS)``; int8 pools dequantized, then cast to
    q.dtype), overlay the chunk's own raw K/V at ``[q_offset, q_offset +
    W)``, then the O(S^2) grouped reference with ``q_offset`` driving the
    causal mask.  Reads the offsets on the host.

    q [1, W, H, D]; pools [L, NB, BS, KV, D] (int8 when k_scales/v_scales
    [L, NB, KV] f32 are given); block_table [1, MB]; k_raw/v_raw
    [1, W, KV, D].
    """
    q_off, tlen = int(q_offset), int(total_len)
    cache = KVCache(k_pool, v_pool, k_scales, v_scales)
    bs = cache.block_size
    cap = block_table.shape[1] * bs
    W = q.shape[1]
    live = (tlen + bs - 1) // bs
    out = []
    for c, raw in zip(kv_gather_bounded(cache, layer, block_table, cap, live,
                                        q.dtype), (k_raw, v_raw)):
        c = torch.cat([c, torch.zeros((1, W) + tuple(c.shape[2:]),
                                      dtype=c.dtype, device=c.device)], 1)
        c[:, q_off:q_off + W] = raw.to(c.dtype)
        out.append(c[:, :cap])
    return grouped_attention(q, out[0], out[1], causal=True,
                             sliding_window=sliding_window,
                             alibi_slopes=alibi_slopes, q_offset=q_off)


def quant_matmul_ref(x: torch.Tensor, params: Dict[str, torch.Tensor]
                     ) -> torch.Tensor:
    """W4A16 oracle of the JAX package: dequantize (through g_idx, cast to
    x.dtype), then matmul, then the bias."""
    return _qmm(x, params)


def gptq_matmul_ref(x: torch.Tensor, qweight: torch.Tensor,
                    scales: torch.Tensor, zeros: torch.Tensor) -> torch.Tensor:
    """The kernel's own function in plain torch: contiguous groups,
    dequantized and multiplied in f32, output in x.dtype."""
    K = x.shape[-1]
    gs = K // scales.shape[0]
    codes = unpack_int4(qweight, K).float()
    w = (codes - zeros.repeat_interleave(gs, 0)) \
        * scales.repeat_interleave(gs, 0)
    return (x.float() @ w).to(x.dtype)


def selective_scan_ref(dt: torch.Tensor, u: torch.Tensor, B: torch.Tensor,
                       C: torch.Tensor, A: torch.Tensor, h0: torch.Tensor):
    """The Mamba-1 selective scan, the JAX package's ``_ssm_inner`` step as
    a loop over time in f32: ``h = exp(dt_t A) h + (dt_t u_t) B_t``, ``y_t
    = sum_n h C_t``.  dt, u [Bt, S, din]; B, C [Bt, S, N]; A [din, N]; h0
    [Bt, din, N].  Returns (y [Bt, S, din], h_last [Bt, din, N])."""
    y = torch.empty_like(dt)
    h = h0
    for t in range(dt.shape[1]):
        da = torch.exp(dt[:, t, :, None] * A[None])
        h = da * h + (dt[:, t] * u[:, t])[..., None] * B[:, t, None, :]
        y[:, t] = torch.einsum("bdn,bn->bd", h, C[:, t])
    return y, h


def selective_scan_bwd_ref(dt, u, B, C, A, h0, gy, g_hlast=None):
    """The selective scan's backward in f32, the plain version of the
    ``selective_scan_bwd`` kernel: h recomputed forward from h0, then time
    walked backward with lambda_t = dL/dh_t (lambda_{S-1} = g_hlast + gy_{S-1}
    C_{S-1}, lambda_t = exp(dt_{t+1} A) lambda_{t+1} + gy_t C_t):

        gC_t[n]  = sum_d gy_t[d] h_t[d, n]
        gB_t[n]  = sum_d lambda_t[d, n] dt_t[d] u_t[d]
        gu_t[d]  = dt_t[d] sum_n lambda_t[d, n] B_t[n]
        gdt_t[d] = sum_n lambda_t[d, n] (A e h_{t-1} + u_t[d] B_t[n])[d, n]
        gA       = sum_{b, t} lambda_t dt_t e h_{t-1}
        gh0      = exp(dt_0 A) lambda_0

    with e = exp(dt_t A) and h_{-1} = h0.  Shapes as ``selective_scan_ref``;
    gy [Bt, S, din]; g_hlast [Bt, din, N] or None (zero).  Returns (gdt,
    gu, gB, gC, gA, gh0)."""
    S = dt.shape[1]
    hs = [h0]
    for t in range(S):
        da = torch.exp(dt[:, t, :, None] * A[None])
        hs.append(da * hs[-1] + (dt[:, t] * u[:, t])[..., None]
                  * B[:, t, None, :])
    lam = torch.zeros_like(h0) if g_hlast is None else g_hlast
    gdt, gu = torch.empty_like(dt), torch.empty_like(u)
    gB, gC = torch.empty_like(B), torch.empty_like(C)
    gA = torch.zeros_like(A)
    for t in range(S - 1, -1, -1):
        da = torch.exp(dt[:, t, :, None] * A[None])
        hp = hs[t]
        lam = lam + gy[:, t, :, None] * C[:, t, None, :]
        dtu = dt[:, t] * u[:, t]
        gC[:, t] = torch.einsum("bd,bdn->bn", gy[:, t], hs[t + 1])
        gB[:, t] = torch.einsum("bdn,bd->bn", lam, dtu)
        sb = torch.einsum("bdn,bn->bd", lam, B[:, t])
        gu[:, t] = dt[:, t] * sb
        q = lam * da * hp
        gdt[:, t] = (q * A[None]).sum(-1) + u[:, t] * sb
        gA = gA + (q * dt[:, t, :, None]).sum(0)
        lam = da * lam
    return gdt, gu, gB, gC, gA, lam


def scan_checkpoints(dt, u, B, A, h0, tile: int):
    """The state entering each ``tile``-step tile of the selective scan
    (``selective_scan_ref``'s arithmetic): [Bt, ceil(S / tile), din, N],
    the checkpoints the ``selective_scan_bwd`` kernel recomputes from."""
    out, h = [], h0
    for t in range(dt.shape[1]):
        if t % tile == 0:
            out.append(h)
        da = torch.exp(dt[:, t, :, None] * A[None])
        h = da * h + (dt[:, t] * u[:, t])[..., None] * B[:, t, None, :]
    if not out:
        return h0.new_empty((h0.shape[0], 0) + tuple(h0.shape[1:]))
    return torch.stack(out, 1)


def ssm_scan_prologue(dt_lin, dt_bias, xc, A_log, mask=None):
    """The mixer core's dt and A: softplus(dt_lin + dt_bias) in xc's dtype,
    then the scan's (f32, or f64 for f64 inputs; 0 where ``mask`` [Bt, S]
    is False), and A = -exp(A_log)."""
    w = torch.promote_types(xc.dtype, torch.float32)
    dt = F.softplus(dt_lin + dt_bias.to(xc.dtype)).to(w)        # [B, S, din]
    if mask is not None:
        dt = torch.where(mask[..., None], dt, 0.0)
    return dt, -torch.exp(A_log.to(w))                          # [din, N]


def ssm_scan_ref(dt_lin, dt_bias, xc, B, C, z, A_log, D, h0, mask=None,
                 scan=selective_scan_ref):
    """The Mamba-1 mixer core after its two matmuls, the torch composition
    ``models/ssm.py :: _ssm_inner`` ran around ``selective_scan_ref``:
    softplus(dt_lin + dt_bias) in xc's dtype, then f32 (0 where ``mask``
    [Bt, S] is False), A = -exp(A_log), the scan in f32, then (y + xc D)
    * silu(z) in xc's dtype.  dt_lin, xc, z [Bt, S, din]; B, C [Bt, S, N];
    dt_bias, D [din]; A_log [din, N]; h0 [Bt, din, N].  Returns (y [Bt, S,
    din] in xc's dtype, h_last [Bt, din, N] f32).  ``scan`` computes the
    scan alone.  (f64 inputs stay f64 throughout: float64 autograd of it
    is ``ssm_scan_bwd_ref``'s yardstick.)"""
    w = torch.promote_types(xc.dtype, torch.float32)
    dt, A = ssm_scan_prologue(dt_lin, dt_bias, xc, A_log, mask)
    y, h = scan(dt.contiguous(), xc.to(w).contiguous(), B.to(w).contiguous(),
                C.to(w).contiguous(), A.contiguous(), h0.to(w).contiguous())
    y = y.to(xc.dtype) + xc * D.to(xc.dtype)
    return y * F.silu(z), h


def ssm_scan_bwd_ref(dt_lin, dt_bias, xc, B, C, z, A_log, D, h0, g_out,
                     g_hlast=None):
    """The fused mixer core's backward, the plain version of the fused
    ``selective_scan_bwd`` kernel: ``ssm_scan_ref``'s forward recomputed
    (its dt, A, the pre-gate y, s = T(T(y) + T(xc T(D))) and silu(z) at its
    rounding points in xc's dtype T), then, in f32 (f64 for f64 inputs)
    with no rounding between:

        gy        = g_out silu(z)                (the scan's y gradient)
        (gdt, gu, gB, gC, gA, gh0) = selective_scan_bwd_ref(.., gy, g_hlast)
        gz        = g_out s silu'(z)
        g_xc      = gu + gy T(D),   gD = sum_{b, t} gy xc
        g_dt_lin  = gdt sigmoid(x)  (gdt where x > 20: torch's softplus),
                    x = T(dt_lin + T(dt_bias))
        g_dt_bias = sum_{b, t} g_dt_lin,   g_A_log = gA A

    No mask.  Returns the gradients of (dt_lin, dt_bias, xc, B, C, z,
    A_log, D, h0), each in its input's dtype."""
    T = xc.dtype
    w = torch.promote_types(T, torch.float32)
    dt, A = ssm_scan_prologue(dt_lin, dt_bias, xc, A_log)
    u, Bw, Cw = xc.to(w), B.to(w), C.to(w)
    y, _ = selective_scan_ref(dt, u, Bw, Cw, A, h0.to(w))
    s = (y.to(T) + xc * D.to(T)).to(w)
    zw = z.to(w)
    sig = torch.sigmoid(zw)
    go = g_out.to(w)
    gy = go * F.silu(z).to(w)
    gdt, gu, gB, gC, gA, gh0 = selective_scan_bwd_ref(dt, u, Bw, Cw, A,
                                                      h0.to(w), gy, g_hlast)
    gz = go * s * (sig * (1 + zw * (1 - sig)))
    g_xc = gu + gy * D.to(T).to(w)
    gD = (gy * u).sum((0, 1))
    x = (dt_lin + dt_bias.to(T)).to(w)
    g_lin = torch.where(x > 20, gdt, gdt * torch.sigmoid(x))
    return (g_lin.to(T), g_lin.sum((0, 1)).to(dt_bias.dtype), g_xc.to(T),
            gB.to(T), gC.to(T), gz.to(T), (gA * A).to(A_log.dtype),
            gD.to(D.dtype), gh0.to(h0.dtype))


def linear_scan_ref(a: torch.Tensor, g: torch.Tensor, h0: torch.Tensor):
    """The RG-LRU's recurrence ``h_t = a_t h_{t-1} + g_t`` in f32, one
    ``addcmul`` per time step over time-major rows (row t contiguous),
    stacked after; autograd differentiates it.  a, g [Bt, S, w]; h0 [Bt,
    w].  Returns (hs [Bt, S, w], h_last [Bt, w])."""
    a_t = a.transpose(0, 1).contiguous()                        # [S, B, w]
    g_t = g.transpose(0, 1).contiguous()
    rows = []
    h = h0
    for t in range(a_t.shape[0]):
        h = torch.addcmul(g_t[t], a_t[t], h)
        rows.append(h)
    hs = torch.stack(rows) if rows else torch.empty_like(a_t)
    return hs.transpose(0, 1), h


def linear_scan_bwd_ref(a, hs, h0, ghs, g_hlast=None):
    """The linear scan's backward in f32, the plain version of the
    ``linear_scan_bwd`` kernel: with lambda = dL/dh_t walked from t = S-1
    down to 0 (starting at g_hlast, or zero), ``lambda += ghs_t``, ``gg_t =
    lambda``, ``ga_t = lambda h_{t-1}`` (h_{-1} = h0, h_{t-1} read from the
    forward's ``hs``), ``lambda = a_t lambda``; at the end gh0 = lambda.
    a, hs, ghs [Bt, S, w]; h0, g_hlast [Bt, w].  Returns (ga, gg, gh0)."""
    lam = torch.zeros_like(h0) if g_hlast is None else g_hlast
    ga, gg = torch.empty_like(a), torch.empty_like(a)
    for t in range(a.shape[1] - 1, -1, -1):
        lam = lam + ghs[:, t]
        gg[:, t] = lam
        ga[:, t] = lam * (hs[:, t - 1] if t > 0 else h0)
        lam = a[:, t] * lam
    return ga, gg, lam
