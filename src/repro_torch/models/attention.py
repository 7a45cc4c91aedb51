"""Attention layer of the dense decoders on the Opt-GQA core: the q/k/v
projections, the full-sequence path of the plain forward, the
whole-prompt prefill with its cache write, and the paged decode path over
the block-table pool (bf16 or int8).

This slice ports the full-attention branch; the sliding-window ring cache
and the sharded (shard_map) islands of the JAX package wait for later
slices (ROADMAP A11, A13).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.alibi import alibi_slopes
from repro_torch.core.kv_quant import (KVCache, kv_write_decode,
                                       kv_write_prefill)
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, linear, rope

Params = Dict[str, torch.Tensor]


def attn_init(gen: torch.Generator, cfg: ModelConfig, device="cpu") -> Params:
    d, H, KV, Dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    p = {
        "wq": dense_init(gen, (d, H, Dh), in_axis_size=d, device=device),
        "wk": dense_init(gen, (d, KV, Dh), in_axis_size=d, device=device),
        "wv": dense_init(gen, (d, KV, Dh), in_axis_size=d, device=device),
        "wo": dense_init(gen, (H, Dh, d), in_axis_size=H * Dh, device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, Dh), device=device)
        p["bk"] = torch.zeros((KV, Dh), device=device)
        p["bv"] = torch.zeros((KV, Dh), device=device)
    return p


def _qkv(cfg: ModelConfig, p: Params, x: torch.Tensor, positions):
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = linear(x, p["wq"], out_tail=(H, Dh))
    k = linear(x, p["wk"], out_tail=(KV, Dh))
    v = linear(x, p["wv"], out_tail=(KV, Dh))
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if cfg.pos_emb == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _slopes(cfg: ModelConfig, device):
    return alibi_slopes(cfg.num_heads, device) if cfg.pos_emb == "alibi" \
        else None


def attn_apply(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
               kind: str = "full", pos_offset=0) -> torch.Tensor:
    """Full-sequence path (the plain forward and GPTQ's calibration
    replay). x: [B, S, d] at positions pos_offset .. pos_offset + S - 1
    -> [B, S, d]; no cache."""
    S = x.shape[1]
    q, k, v = _qkv(cfg, p, x, pos_offset + torch.arange(S, device=x.device))
    win = cfg.sliding_window if kind == "sliding" else 0
    o = ops.flash_attention(q, k, v, _slopes(cfg, x.device),
                            causal=not cfg.is_encoder, sliding_window=win)
    return linear(o.reshape(*o.shape[:2], -1), p["wo"])


def attn_prefill(cfg: ModelConfig, p: Params, x: torch.Tensor, *, kind: str,
                 cache: KVCache, layer: int, block_table: torch.Tensor,
                 ctx_lens: torch.Tensor):
    """Whole-prompt prefill: causal attention over the prompt, then its
    K/V written into the paged pool (quantize-on-write for an int8
    cache).  x [B, S, d] right-padded, positions 0 .. S - 1; only
    positions < ctx_lens are written.  Returns (y [B, S, d], cache)."""
    _require_full(kind)
    S = x.shape[1]
    q, k, v = _qkv(cfg, p, x, torch.arange(S, device=x.device))
    o = ops.flash_attention(q, k, v, _slopes(cfg, x.device), causal=True)
    cache = kv_write_prefill(cache, layer, k, v, block_table, ctx_lens)
    y = linear(o.reshape(*o.shape[:2], -1), p["wo"])
    return y, cache


def _require_full(kind: str) -> None:
    if kind != "full":
        raise NotImplementedError(
            f"{kind!r} attention layers are not ported yet (ROADMAP A11: "
            "the sliding-window ring cache)")


def attn_decode(cfg: ModelConfig, p: Params, x: torch.Tensor, *, kind: str,
                cache: KVCache, layer: int, block_table: torch.Tensor,
                seq_lens: torch.Tensor):
    """One-token decode. x: [B, d]; pools [L, NB, BS, KV, D], written in
    place.  Returns (y [B, d], cache)."""
    _require_full(kind)
    positions = (seq_lens.long() - 1)[:, None]             # [B, 1]
    q, k, v = _qkv(cfg, p, x[:, None, :], positions)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]                    # [B, H/KV, D]
    o, cache = _decode_cache_attend(cfg, q, k, v, cache, block_table,
                                    seq_lens, layer)
    y = linear(o.reshape(o.shape[0], -1), p["wo"])
    return y, cache


def _decode_cache_attend(cfg, q, k, v, cache: KVCache, block_table,
                         seq_lens, layer):
    """Cache write + paged attention (full-attention branch); an int8
    cache is read by the kernel that dequantizes in registers."""
    cache = kv_write_decode(cache, layer, k, v, block_table, seq_lens - 1)
    slopes = _slopes(cfg, q.device)
    if cache.quantized:
        o = ops.paged_attention_quant(q, cache.k[layer], cache.k_scale[layer],
                                      cache.v[layer], cache.v_scale[layer],
                                      block_table, seq_lens, slopes)
    else:
        o = ops.paged_attention(q, cache.k[layer], cache.v[layer],
                                block_table, seq_lens, slopes)
    return o, cache
