"""Attention layer of the decoders on the Opt-GQA core: the q/k/v
projections, the full-sequence path of the plain forward, the
whole-prompt prefill with its cache write, and the decode path: paged
attention over the block-table pool (bf16 or int8) for full-attention
layers, a ring cache for sliding-window layers.

The sharded (shard_map) islands of the JAX package wait for a later
slice (ROADMAP A13).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.alibi import alibi_slopes
from repro_torch.core.kv_quant import (KVCache, kv_write_decode,
                                       kv_write_prefill)
from repro_torch.core.paged_cache import gather_kv, write_decode_kv
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


# ALiBi slopes per (heads, device), made at a step's first (eager) run
_SLOPES: Dict[Tuple[int, torch.device], torch.Tensor] = {}


def _slopes(cfg: ModelConfig, device):
    """The ALiBi slopes [H] on ``device`` (None without ALiBi), built once
    per (heads, device): building them is a copy from pageable host
    memory, which a step being captured as a CUDA graph may not make."""
    if cfg.pos_emb != "alibi":
        return None
    key = (cfg.num_heads, torch.device(device))
    if key not in _SLOPES:
        _SLOPES[key] = alibi_slopes(cfg.num_heads, device)
    return _SLOPES[key]


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
    positions < ctx_lens are written.  A sliding layer attends inside its
    window here; ``transformer.prefill`` sends sliding stacks to
    ``attn_prefill_ring``, which writes the ring instead.  Returns
    (y [B, S, d], cache)."""
    S = x.shape[1]
    q, k, v = _qkv(cfg, p, x, torch.arange(S, device=x.device))
    win = cfg.sliding_window if kind == "sliding" else 0
    o = ops.flash_attention(q, k, v, _slopes(cfg, x.device), causal=True,
                            sliding_window=win)
    cache = kv_write_prefill(cache, layer, k, v, block_table, ctx_lens)
    y = linear(o.reshape(*o.shape[:2], -1), p["wo"])
    return y, cache


def attn_decode(cfg: ModelConfig, p: Params, x: torch.Tensor, *, kind: str,
                cache: KVCache, layer: int, block_table: torch.Tensor,
                seq_lens: torch.Tensor):
    """One-token decode. x: [B, d]; pools [L, NB, BS, KV, D] (a ring for
    sliding layers), written in place.  Returns (y [B, d], cache)."""
    positions = (seq_lens.long() - 1)[:, None]             # [B, 1]
    q, k, v = _qkv(cfg, p, x[:, None, :], positions)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]                    # [B, H/KV, D]
    win = cfg.sliding_window if kind == "sliding" else 0
    o, cache = _decode_cache_attend(cfg, q, k, v, cache, block_table,
                                    seq_lens, layer, win)
    y = linear(o.reshape(o.shape[0], -1), p["wo"])
    return y, cache


def _decode_cache_attend(cfg, q, k, v, cache: KVCache, block_table,
                         seq_lens, layer, win: int):
    """Cache write + attention.  Full attention: paged attention over the
    pool (an int8 cache is read by the kernel that dequantizes in
    registers).  Sliding window (``win > 0``): the ring cache."""
    if win > 0:
        return _ring_cache_attend(q, k, v, cache, block_table, seq_lens,
                                  layer, win)
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


def _ring_cache_attend(q, k, v, cache: KVCache, block_table, seq_lens,
                       layer, win: int):
    """Sliding-window decode over the ring cache: the sequence's row of the
    block table is a ring of ``cache_len = MB * BS`` slots and position p
    lives in slot p % cache_len, so the slots hold the most recent
    cache_len tokens.  The new token is written at its slot (inactive
    slots, seq_len 0, get position -1 and their write is dropped); then
    the whole ring is gathered and each slot's absolute position recovered
    from the ring position, which masks slots never written and slots
    outside the window.  bf16 (or f32) pools only: ``make_decode_state``
    refuses int8 for sliding layers, as the reference does."""
    k_pool, v_pool = cache.k, cache.v
    cache_len = block_table.shape[1] * k_pool.shape[2]
    last = seq_lens.long() - 1                                 # [B]
    ring_pos = torch.where(last >= 0, last % cache_len,
                           torch.full_like(last, -1))
    write_decode_kv(k_pool, layer, k, block_table, ring_pos)
    write_decode_kv(v_pool, layer, v, block_table, ring_pos)
    kc = gather_kv(k_pool, layer, block_table, cache_len)
    vc = gather_kv(v_pool, layer, block_table, cache_len)
    # absolute position of ring slot s for a sequence of length t:
    # pos(s) = t - 1 - ((ring_pos - s) mod cache_len)
    s_idx = torch.arange(cache_len, device=q.device)[None, :]
    kpos = last[:, None] - torch.remainder(ring_pos[:, None] - s_idx,
                                           cache_len)
    valid = (kpos >= 0) & (kpos > last[:, None] - win)
    return _ring_attention(q, kc, vc, valid), cache


def _ring_attention(q, kc, vc, valid):
    """Dense decode attention over a gathered ring cache with a slot mask:
    q [B, H, D], kc / vc [B, cache_len, KV, D], valid [B, cache_len];
    scores, softmax and output in f32, cast back to q's dtype.  Plain XLA
    in the reference, plain torch here (the ring is not in position order,
    so the paged decode kernel does not apply)."""
    B, H, D = q.shape
    KV = kc.shape[2]
    G = H // KV
    scale = D ** -0.5
    qg = q.reshape(B, KV, G, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, kc.float()) * scale
    s = torch.where(valid[:, None, None, :], s,
                    -0.7 * torch.finfo(torch.float32).max)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", w, vc.float())
    return o.reshape(B, H, D).to(q.dtype)
