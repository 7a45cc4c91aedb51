"""Opt-GQA attention math (paper §II), the plain torch references.

H query heads are partitioned into ``num_kv_heads`` groups of
``G = H // num_kv_heads`` heads sharing one K/V head; Q is viewed as
[B, KV, G, S, D] so each K/V head is contracted against all of its
group's queries at once.  These are the O(S^2) references the CUDA
kernels are held against; everything is computed in f32.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def grouped_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, sliding_window: int = 0,
                      alibi_slopes: Optional[torch.Tensor] = None,
                      q_offset: int = 0) -> torch.Tensor:
    """q [B, Sq, H, D], k/v [B, Sk, KV, D] -> [B, Sq, H, D]."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    assert H % KV == 0, (H, KV)
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, D).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * D ** -0.5
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    dist = q_pos[:, None] - k_pos[None, :]
    if alibi_slopes is not None:
        d = dist.clamp(min=0) if causal else dist.abs()
        bias = -alibi_slopes.float()[:, None, None] * d[None].float()
        scores = scores + bias.reshape(KV, G, Sq, Sk)[None]
    mask = torch.ones_like(dist, dtype=torch.bool)
    if causal:
        mask &= dist >= 0
    if sliding_window > 0:
        mask &= dist < sliding_window
    scores = torch.where(mask[None, None, None], scores,
                         torch.tensor(NEG_INF, device=q.device))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, seq_lens: torch.Tensor, *,
                     alibi_slopes: Optional[torch.Tensor] = None,
                     sliding_window: int = 0) -> torch.Tensor:
    """One new token per sequence against a contiguous cache.

    q [B, H, D]; k_cache/v_cache [B, S_max, KV, D]; seq_lens [B] counts
    the new token.  Returns [B, H, D].
    """
    B, S, KV, D = k_cache.shape
    H = q.shape[1]
    G = H // KV
    qg = q.reshape(B, KV, G, D).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * D ** -0.5
    k_pos = torch.arange(S, device=q.device)
    q_pos = seq_lens.long()[:, None] - 1                         # [B, 1]
    if alibi_slopes is not None:
        dist = (q_pos - k_pos[None, :]).clamp(min=0)             # [B, S]
        bias = -alibi_slopes.float()[None, :, None] * dist[:, None, :]
        scores = scores + bias.reshape(B, KV, G, S)
    mask = k_pos[None, :] < seq_lens.long()[:, None]
    if sliding_window > 0:
        mask &= k_pos[None, :] > (q_pos - sliding_window)
    scores = torch.where(mask[:, None, None, :], scores,
                         torch.tensor(NEG_INF, device=q.device))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w, v_cache.float())
    return out.reshape(B, H, D).to(q.dtype)
