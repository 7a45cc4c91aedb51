"""GPTQ post-training quantization (the 'GPTQ' in Opt-GPTQ), in torch
float64 on the device of the weight.

Hessian-based OBQ, step for step the JAX package's numpy recipe:
accumulate H = 2/N Σ xᵀx over calibration activations, pin dead inputs,
permute by decreasing curvature (act_order), damp, take the upper
Cholesky factor of H⁻¹, then quantize the rows of ``w [in, out]`` (one
input feature at a time) with error feedback into the rows not yet
quantized, lazily batched in blocks of ``block_size``.  Group scales and
zeros come from the original, un-updated weights in the original order,
so ``g_idx`` stays contiguous (``g = k // group_size``), which the int4
matmul kernel assumes.

On a CUDA weight everything runs on the card; the only value that goes
to the host is the ``[in]`` diagonal, whose ``np.argsort`` gives the
permutation with the reference's order of ties.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import QuantConfig


@dataclass
class QuantizedTensor:
    """Group-wise int4 quantization artifact for one [in, out] weight."""
    q: torch.Tensor          # [in, out] uint8 codes in [0, 2^bits)
    scales: torch.Tensor     # [n_groups, out] float32
    zeros: torch.Tensor      # [n_groups, out] float32 (zero-point in code space)
    g_idx: torch.Tensor      # [in] int32 group id per input feature
    bits: int

    def dequant(self) -> torch.Tensor:
        g = self.g_idx.long()
        return (self.q.float() - self.zeros[g]) * self.scales[g]


class HessianAccumulator:
    """Streaming H = 2/N Σ xᵀx (float64) over calibration batches for one
    layer input, on ``device`` (the card unless the caller asks for the
    CPU)."""

    def __init__(self, in_features: int, device="cuda"):
        self.h = torch.zeros((in_features, in_features), dtype=torch.float64,
                             device=resolve_device(device))
        self.n = 0

    def update(self, x) -> None:
        """x: [..., in_features] activations feeding this weight."""
        x2 = torch.as_tensor(x).to(self.h.device, torch.float64) \
            .reshape(-1, self.h.shape[0])
        # running mean keeps H scale-stable across batch counts
        m = x2.shape[0]
        self.h *= self.n / max(self.n + m, 1)
        self.h += (2.0 / max(self.n + m, 1)) * (x2.T @ x2)
        self.n += m


def _group_params(w_col_block: torch.Tensor, bits: int, sym: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel (scale, zero) of groups of input features.

    w_col_block: [..., g, out] float64. Returns scale, zero each [..., out]
    float32 (computed in float64, rounded once at the end)."""
    maxq = 2 ** bits - 1
    wmax = w_col_block.amax(dim=-2)
    wmin = w_col_block.amin(dim=-2)
    if sym:
        mag = torch.maximum(wmax.abs(), wmin.abs())
        scale = torch.where(mag > 0, 2 * mag / maxq, torch.ones_like(mag))
        zero = torch.full_like(scale, (maxq + 1) / 2)
    else:
        wmax = wmax.clamp(min=0)
        wmin = wmin.clamp(max=0)
        rng = wmax - wmin
        scale = torch.where(rng > 0, rng / maxq, torch.ones_like(rng))
        zero = torch.round(-wmin / scale)
    return scale.float(), zero.float()


def _all_group_params(w: torch.Tensor, gs: int, bits: int, sym: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """_group_params of every contiguous group of ``gs`` rows of w [in,
    out] (the last group may be short): [n_groups, out] each."""
    din, dout = w.shape
    n_full = din // gs
    parts = [_group_params(w[:n_full * gs].reshape(n_full, gs, dout), bits,
                           sym)]
    if din % gs:
        s, z = _group_params(w[n_full * gs:], bits, sym)
        parts.append((s[None], z[None]))
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def _quant_col(col: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
               maxq: int) -> Tuple[torch.Tensor, torch.Tensor]:
    q = torch.clamp(torch.round(col / scale + zero), 0, maxq)
    return q, (q - zero) * scale


def gptq_quantize(w, hessian, cfg: QuantConfig) -> QuantizedTensor:
    """Quantize one weight matrix ``w [in, out]`` given its input Hessian
    ``[in, in]``, on w's device (tensors or numpy arrays; numpy stays on
    the CPU).

    hessian=None is RTN (identity Hessian), the baseline GPTQ improves on:
    chol(inv((1 + λ) I)) is exactly diagonal, so every feedback term the
    reference's loop adds is an exact zero and the codes are
    clip(round(w / scale + zero)) in closed form, with no column loop.
    """
    w = torch.as_tensor(w).to(torch.float64).clone()
    dev = w.device
    din, dout = w.shape
    maxq = 2 ** cfg.bits - 1
    gs = min(cfg.group_size, din)
    g_host = np.arange(din) // gs
    g_idx = torch.from_numpy(g_host.astype(np.int32)).to(dev)

    if hessian is None:
        scales, zeros = _all_group_params(w, gs, cfg.bits, cfg.sym)
        g = g_idx.long()
        q, _ = _quant_col(w, scales.double()[g], zeros.double()[g], maxq)
        return QuantizedTensor(q=q.to(torch.uint8), scales=scales,
                               zeros=zeros, g_idx=g_idx, bits=cfg.bits)

    h = torch.as_tensor(hessian).to(dev, torch.float64).clone()
    # dead inputs: no signal -> pin weight to 0, unit curvature
    diag = torch.diagonal(h)
    dead = diag == 0
    diag.masked_fill_(dead, 1.0)
    w.masked_fill_(dead[:, None], 0.0)
    d_host = diag.cpu().numpy()          # the one copy to the host: [in]

    perm = np.argsort(-d_host) if cfg.act_order else np.arange(din)
    inv_perm = np.argsort(perm)
    # group params on the *original* row order so g_idx stays contiguous
    scales, zeros = _all_group_params(w, gs, cfg.bits, cfg.sym)
    p = torch.from_numpy(perm).to(dev)
    w = w[p]
    h = h[p][:, p]

    damp = cfg.damp_frac * np.mean(d_host[perm])
    torch.diagonal(h).add_(float(damp))
    # Upper Cholesky of H^-1 — the GPTQ trick: error propagation only
    # needs rows of chol(H^-1, upper).
    hinv = torch.linalg.inv(h)
    hinv = torch.linalg.cholesky((hinv + hinv.T) / 2).T

    s64, z64 = scales.double(), zeros.double()
    q_perm = torch.empty((din, dout), dtype=torch.uint8, device=dev)
    bs = cfg.block_size
    for i0 in range(0, din, bs):
        i1 = min(i0 + bs, din)
        wb = w[i0:i1].clone()
        eb = torch.zeros_like(wb)
        hb = hinv[i0:i1, i0:i1]
        for j in range(i1 - i0):
            col = wb[j]
            g = g_host[perm[i0 + j]]
            qc, dq = _quant_col(col, s64[g], z64[g], maxq)
            q_perm[i0 + j] = qc
            torch.div(col - dq, hb[j, j], out=eb[j])
            if j + 1 < i1 - i0:                     # in-block error feedback
                wb[j + 1:] -= torch.outer(hb[j, j + 1:], eb[j])
        if i1 < din:                                # lazy batched update
            w[i1:] -= hinv[i0:i1, i1:].T @ eb

    q = q_perm[torch.from_numpy(inv_perm).to(dev)]
    return QuantizedTensor(q=q, scales=scales, zeros=zeros, g_idx=g_idx,
                           bits=cfg.bits)


def rtn_quantize(w, cfg: QuantConfig) -> QuantizedTensor:
    """Round-to-nearest baseline (no Hessian, no error feedback)."""
    return gptq_quantize(w, None, dataclasses.replace(cfg, act_order=False))


def quant_error(w, qt: QuantizedTensor, hessian=None) -> float:
    """Proxy loss: tr((W-Ŵ)ᵀ H (W-Ŵ)) / numel — the objective GPTQ
    minimizes (float64, on the device of ``qt``)."""
    dev = qt.q.device
    d = torch.as_tensor(w).to(dev, torch.float64) - qt.dequant().double()
    if hessian is None:
        return float((d * d).mean())
    h = torch.as_tensor(hessian).to(dev, torch.float64)
    return float((d * (h @ d)).sum() / d.numel())
