"""Public kernel entry points, dispatched by the device of the tensors.

A tensor on the CPU goes to the plain version in ``ref.py``; a CUDA tensor
launches the hand-written Hopper kernel, whose wrapper raises on anything
it does not take.  There is no fallback from a CUDA tensor to the plain
version and no flag that selects one.

Gradients: on the CPU autograd differentiates the plain versions.  On the
card a call that autograd records goes through an autograd rule: the
static ``flash_attention`` through ``FlashAttentionFn`` (the kernel
forward, the plain version's backward), the time scans through
``SsmScanFn`` (the fused Mamba-1 mixer core), ``SelectiveScanFn`` and
``LinearScanFn`` (the kernel forward, a reverse-time backward kernel:
one launch each way).  The paged,
chunk-prefill and int4 kernels serve only and have no backward, so they
raise when grad is enabled and an input requires grad, instead of
returning an output without a ``grad_fn`` that would drop the gradients
silently.  Under ``no_grad`` every entry launches exactly its serving
kernel.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                 flash_attention_chunk,
                                                 flash_attention_chunk_int8)
from repro_torch.kernels.gptq_matmul import gptq_matmul
from repro_torch.kernels.paged_attention import paged_attention as _paged
from repro_torch.kernels.paged_attention_quant import (
    paged_attention_quant as _paged_quant)
from repro_torch.kernels.time_scan import (LinearScanFn, SelectiveScanFn,
                                           SsmScanFn)
from repro_torch.kernels.time_scan import linear_scan as _linear_scan
from repro_torch.kernels.time_scan import selective_scan as _selective_scan

KERNELS = (_paged, _paged_quant, flash_attention_chunk,
           flash_attention_chunk_int8, _flash, gptq_matmul, _selective_scan,
           _linear_scan, _selective_scan.bwd, _selective_scan.fused_bwd,
           _linear_scan.bwd)


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def _records_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _serving_only(name: str, *tensors) -> None:
    """Raise before a serving-only kernel whose output autograd would
    record: it has no backward, and its output has no ``grad_fn``."""
    if _records_grad(*tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel serves only and has no backward; an "
            "input requires grad with grad enabled, so its gradient would "
            "be dropped (run it under torch.no_grad(); training runs no "
            "paged, chunk-prefill or int4 kernel)")


def paged_attention(q, k_pool, v_pool, block_table, seq_lens,
                    alibi_slopes=None, *, sliding_window=0):
    """Decode attention: q [B, H, D] over one layer's pool [NB, BS, KV, D]."""
    if _on_cuda(q):
        _serving_only("paged_attention", q, k_pool, v_pool, alibi_slopes)
        return _paged(q, k_pool, v_pool, block_table, seq_lens,
                      alibi_slopes, sliding_window=sliding_window)
    return _ref.paged_attention_ref(q, k_pool, v_pool, block_table,
                                    seq_lens, alibi_slopes=alibi_slopes,
                                    sliding_window=sliding_window)


def paged_attention_quant(q, k_values, k_scales, v_values, v_scales,
                          block_table, seq_lens, alibi_slopes=None, *,
                          sliding_window=0):
    """Decode attention over one layer's int8 pool: values [NB, BS, KV,
    D] int8, scales [NB, KV] f32, dequantized in the kernel."""
    if _on_cuda(q):
        _serving_only("paged_attention_quant", q, k_scales, v_scales,
                      alibi_slopes)
        return _paged_quant(q, k_values, k_scales, v_values, v_scales,
                            block_table, seq_lens, alibi_slopes,
                            sliding_window=sliding_window)
    return _ref.paged_attention_quant_ref(
        q, k_values, k_scales, v_values, v_scales, block_table, seq_lens,
        alibi_slopes=alibi_slopes, sliding_window=sliding_window)


def flash_attention(q, k, v, alibi_slopes=None, *, causal=True,
                    sliding_window=0, q_offset: int = 0):
    """Static prefill attention: q [B, Sq, H, D] at positions q_offset + i
    over k/v [B, Sk, KV, D].  On the card, a call that autograd records
    goes through ``FlashAttentionFn`` (the kernel forward, the plain
    version's backward)."""
    if _on_cuda(q):
        if _records_grad(q, k, v):
            return FlashAttentionFn.apply(q, k, v, alibi_slopes, causal,
                                          sliding_window, q_offset)
        return _flash(q, k, v, alibi_slopes, causal=causal,
                      sliding_window=sliding_window, q_offset=q_offset)
    return _ref.flash_attention_ref(q, k, v, causal=causal,
                                    sliding_window=sliding_window,
                                    alibi_slopes=alibi_slopes,
                                    q_offset=q_offset)


def chunk_prefill_attention(q, k_pool, v_pool, k_scales, v_scales, layer,
                            block_table, q_offset, total_len, k_raw, v_raw,
                            alibi_slopes=None, *, sliding_window=0):
    """Serving chunk-prefill attention with a device-side ``q_offset``.

    q [1, W, H, D]; k_pool/v_pool [L, NB, BS, KV, D]; k_scales/v_scales
    [L, NB, KV] f32 for int8 pools, else None; layer: int; block_table
    [1, MB]; q_offset / total_len: 0-d int32 tensors; k_raw/v_raw
    [1, W, KV, D].
    """
    if _on_cuda(q):
        _serving_only("flash_attention_chunk", q, k_pool, v_pool, k_scales,
                      v_scales, k_raw, v_raw, alibi_slopes)
        if k_scales is not None:
            return flash_attention_chunk_int8(
                q, k_pool[layer], v_pool[layer], block_table, q_offset,
                total_len, k_raw, v_raw, alibi_slopes,
                k_scales=k_scales[layer], v_scales=v_scales[layer],
                sliding_window=sliding_window)
        return flash_attention_chunk(
            q, k_pool[layer], v_pool[layer], block_table, q_offset,
            total_len, k_raw, v_raw, alibi_slopes,
            sliding_window=sliding_window)
    return _ref.chunk_prefill_attention_ref(
        q, k_pool, v_pool, k_scales, v_scales, layer, block_table,
        q_offset, total_len, k_raw, v_raw, alibi_slopes=alibi_slopes,
        sliding_window=sliding_window)


def quant_matmul(x: torch.Tensor, params: Dict[str, torch.Tensor]
                 ) -> torch.Tensor:
    """x [..., K] @ packed int4 weight -> [..., N] (+ bias outside the
    kernel)."""
    if not _on_cuda(x):
        return _ref.quant_matmul_ref(x, params)
    _serving_only("gptq_matmul", x, *params.values())
    lead = x.shape[:-1]
    y = gptq_matmul(x.reshape(-1, x.shape[-1]).contiguous(),
                    params["qweight"], params["scales"], params["zeros"],
                    params.get("g_idx"))
    if "bias" in params:
        y = y + params["bias"].to(y.dtype)
    return y.reshape(*lead, -1)


def selective_scan(dt, u, B, C, A, h0):
    """The Mamba-1 selective scan over time: dt, u [Bt, S, din], B, C
    [Bt, S, N], A [din, N], h0 [Bt, din, N], all f32 -> (y [Bt, S, din],
    h_last [Bt, din, N]).  On the card a call that autograd records goes
    through ``SelectiveScanFn``."""
    if _on_cuda(dt):
        if _records_grad(dt, u, B, C, A, h0):
            return SelectiveScanFn.apply(dt, u, B, C, A, h0)
        return _selective_scan(dt, u, B, C, A, h0)
    return _ref.selective_scan_ref(dt, u, B, C, A, h0)


def ssm_scan(dt_lin, dt_bias, xc, B, C, z, A_log, D, h0, mask=None):
    """The Mamba-1 mixer core after its two matmuls (``_ssm_inner``):
    dt = softplus(dt_lin + dt_bias) (0 where ``mask`` [Bt, S] is False), A
    = -exp(A_log), the selective scan of xc [Bt, S, din] over B, C [Bt, S,
    N] from h0 [Bt, din, N] f32, then (y + xc D) * silu(z), at the plain
    version's rounding points in xc's dtype -> (y [Bt, S, din] in xc's
    dtype, h_last [Bt, din, N] f32).  On the card one launch of the
    selective-scan kernel, counted by ``selective_scan``; B, C and z may be
    column views of the projections' outputs.  A call on the card that
    autograd records goes through ``SsmScanFn``: the same launch, storing
    its checkpoints, and one launch of the fused ``selective_scan_bwd``
    for every input's gradient; no training path passes a mask, and one
    raises there."""
    if _on_cuda(xc):
        if _records_grad(dt_lin, dt_bias, xc, B, C, z, A_log, D, h0):
            if mask is not None:
                raise RuntimeError(
                    "ssm_scan: a mask under autograd is not supported on "
                    "the card (the trainer scans whole sequences; masked "
                    "prefill runs under torch.no_grad())")
            return SsmScanFn.apply(dt_lin, dt_bias, xc, B, C, z, A_log, D,
                                   h0)
        return _selective_scan.fused(dt_lin, dt_bias, xc, B, C, z, A_log, D,
                                     h0, mask)
    return _ref.ssm_scan_ref(dt_lin, dt_bias, xc, B, C, z, A_log, D, h0,
                             mask)


def linear_scan(a, g, h0):
    """The RG-LRU recurrence h_t = a_t h_{t-1} + g_t: a, g [Bt, S, w], h0
    [Bt, w], all f32 -> (hs [Bt, S, w], h_last [Bt, w]).  On the card a
    call that autograd records goes through ``LinearScanFn``."""
    if _on_cuda(a):
        if _records_grad(a, g, h0):
            return LinearScanFn.apply(a, g, h0)
        return _linear_scan(a, g, h0)
    return _ref.linear_scan_ref(a, g, h0)
