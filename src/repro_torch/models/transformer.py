"""Decoder assembly (dense and MoE): init / the plain full-sequence forward /
decode state / whole-prompt prefill / decode step / megastep / prefill
chunk / unified step, and its variant chained on the device for the async
engine.

The JAX package scans over layer-stacked params with ``lax.scan``; here a
Python loop walks the layers.  ``params["layers"]`` keeps the JAX layout
(every leaf stacked on a leading L axis) at the public functions; the
serving runner may pre-split it into a list of per-layer dicts once
(``split_layers``), which every function here accepts too.  The paged
pools are updated in place.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.kv_quant import (cache_from_state, cache_to_state,
                                       kv_write_prefill, make_kv_pool_quant,
                                       normalize_kv_cache_dtype)
from repro_torch.core.paged_cache import make_kv_pool
from repro_torch.core.sampling import sample_from_logits
from repro_torch.kernels import ops
from repro_torch.models.attention import (_qkv, _slopes, attn_apply,
                                         attn_decode, attn_init, attn_prefill)
from repro_torch.models.layers import (apply_norm, embed_init, linear,
                                       mlp_apply, mlp_init, norm_init,
                                       unembed)
from repro_torch.models.moe import moe_apply, moe_init

Params = Dict[str, Any]


def act_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def supports_chunked_prefill(cfg: ModelConfig) -> bool:
    """Homogeneous full-attention stacks keep all their serving state in
    the paged pool — the only kind the port serves so far."""
    kinds = {cfg.layer_kind(i) for i in range(cfg.num_layers)}
    return kinds == {"full"} and not cfg.is_encoder


# the families the port serves, and whether each has routed experts
PORTED_FAMILIES = {"dense": False, "moe": True}


def _require_ported(cfg: ModelConfig) -> None:
    if PORTED_FAMILIES.get(cfg.family) != bool(cfg.num_experts) \
            or not supports_chunked_prefill(cfg):
        raise NotImplementedError(
            f"{cfg.name}: only dense and MoE full-attention decoders are "
            "ported to repro_torch so far (ROADMAP A11: other model "
            "families)")


# --------------------------------------------------------------------------
# Params
# --------------------------------------------------------------------------

def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_layer(gen: Optional[torch.Generator], cfg: ModelConfig, device
               ) -> Params:
    p: Params = {"attn_norm": norm_init(cfg.d_model, cfg.norm, device),
                 "mlp_norm": norm_init(cfg.d_model, cfg.norm, device),
                 "attn": attn_init(gen, cfg, device)}
    if cfg.num_experts:
        p["moe"] = moe_init(gen, cfg, device)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, device)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                dtype: Optional[torch.dtype] = None) -> Params:
    """Random params from ``seed`` in the JAX package's layout (the
    numbers differ from ``jax.random``'s; tests bridge JAX params
    instead): f32, or with ``dtype`` every weight but the norms cast to
    it as it is drawn.  Each layer is drawn, cast and copied into
    preallocated layer stacks before the next, so a load peaks near the
    stored size plus one f32 layer (qwen2-moe in bf16: 28.6 GB, not the
    57 GB of an all-f32 tree).  ``device="meta"`` gives the shapes
    only."""
    _require_ported(cfg)
    dev = resolve_device(device)
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    params: Params = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model,
                                          dev),
                      "final_norm": norm_init(cfg.d_model, cfg.norm, dev)}
    if not cfg.tie_embeddings:
        params["head"] = torch.randn((cfg.d_model, cfg.vocab_size),
                                     generator=gen, device=dev) \
            * cfg.d_model ** -0.5
    if dtype is not None:
        params = cast_params(params, dtype)
    stacks = None
    for i in range(cfg.num_layers):
        layer = init_layer(gen, cfg, dev)
        if dtype is not None:
            layer = cast_params(layer, dtype)
        if stacks is None:
            stacks = _map(lambda t: torch.empty(
                (cfg.num_layers, *t.shape), dtype=t.dtype, device=dev),
                layer)
        _map(lambda dst, src: dst[i].copy_(src), stacks, layer)
    params["layers"] = stacks
    return params


def _map(fn, tree, *rest):
    """fn over the leaves of ``tree`` (and the same leaves of ``rest``)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def split_layers(params: Params) -> Params:
    """The same params with ``layers`` as a list of per-layer dicts of
    views — built once, so a step does not re-slice the stacks."""
    layers = params["layers"]
    if isinstance(layers, list):
        return params
    n = _leaves(layers)[0].shape[0]
    out = dict(params)
    out["layers"] = [_index(layers, i) for i in range(n)]
    return out


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _layer(params: Params, i: int) -> Params:
    layers = params["layers"]
    return layers[i] if isinstance(layers, list) else _index(layers, i)


def keeps_dtype(path: str) -> bool:
    """``cast_params``'s rule for the leaf at a dotted ``path`` (or under a
    key): norm weights stay f32, since the norms read them in f32."""
    return any(k.endswith("norm") for k in path.split("."))


def cast_params(params: Params, dtype: torch.dtype) -> Params:
    """Cast every weight that the model only ever uses cast to the
    activation dtype (dense matrices, embeddings, biases) once, up front.
    Bit-identical to casting at each product; norm weights stay f32 (the
    norms read them in f32) and int4 dicts stay as they are."""
    def walk(tree, key=""):
        if keeps_dtype(key):
            return tree
        if isinstance(tree, dict):
            if "qweight" in tree:
                return tree
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return tree.to(dtype) if tree.is_floating_point() else tree

    return walk(params)


# --------------------------------------------------------------------------
# Layer application (plain forward)
# --------------------------------------------------------------------------

def apply_layer(cfg: ModelConfig, lp: Params, x: torch.Tensor, kind: str,
                tap: Optional[Callable[[str, torch.Tensor], None]] = None
                ) -> torch.Tensor:
    """One pre-norm layer.  ``tap``, if given, sees the input of each
    block's linears: ``tap("attn", h)`` and ``tap("mlp", h)``."""
    h = apply_norm(lp["attn_norm"], x, cfg.norm, cfg.norm_eps)
    if tap is not None:
        tap("attn", h)
    x = x + attn_apply(cfg, lp["attn"], h, kind=kind)
    h = apply_norm(lp["mlp_norm"], x, cfg.norm, cfg.norm_eps)
    if tap is not None:
        tap("mlp", h)
    return x + ffn(cfg, lp, h)


def ffn(cfg: ModelConfig, lp: Params, h: torch.Tensor) -> torch.Tensor:
    """The layer's FFN on h [B, S, d]: the routed and shared experts of
    an MoE layer, else the SwiGLU MLP."""
    if "moe" in lp:
        return moe_apply(cfg, lp["moe"], h)
    return mlp_apply(lp["mlp"], h, cfg.act)


def _embed_inputs(cfg: ModelConfig, params: Params, batch: Dict[str, Any]
                  ) -> torch.Tensor:
    """Token frontend (the audio and vision frontends wait for A11);
    tokens may be a tensor or a numpy array."""
    if cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.frontend!r} frontends are not "
                                  "ported yet (ROADMAP A11)")
    emb = params["embed"]
    tokens = torch.as_tensor(batch["tokens"]).to(emb.device).long()
    return emb[tokens].to(act_dtype(cfg))


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, Any]
            ) -> torch.Tensor:
    """Full causal forward -> logits [B, S, V] in the activation dtype, a
    Python loop over the layers (no remat: no training yet, A12)."""
    _require_ported(cfg)
    x = _embed_inputs(cfg, params, batch)
    for i in range(cfg.num_layers):
        x = apply_layer(cfg, _layer(params, i), x, cfg.layer_kind(i))
    x = apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    return unembed(x, params["embed"], params.get("head"))


# --------------------------------------------------------------------------
# Serving: decode state + decode_step + megastep + prefill chunk
# --------------------------------------------------------------------------

def make_decode_state(cfg: ModelConfig, max_seqs: int, num_blocks: int,
                      max_blocks_per_seq: int, dtype=None,
                      kv_cache_dtype: Optional[str] = None,
                      device="cuda") -> Dict[str, torch.Tensor]:
    """seq_lens [B] i32, block_table [B, MB] i32 and the (k, v) pools
    [L, NB, BS, KV, D]: of ``dtype`` (the activation dtype by default),
    or with ``kv_cache_dtype="int8"`` int8 values plus the (k, v) scale
    pools [L, NB, KV] f32."""
    _require_ported(cfg)
    kv_mode = normalize_kv_cache_dtype(kv_cache_dtype)
    dev = resolve_device(device)
    dims = (cfg.num_layers, num_blocks, cfg.paging.block_size,
            cfg.num_kv_heads, cfg.resolved_head_dim)
    st = {"seq_lens": torch.zeros(max_seqs, dtype=torch.int32, device=dev),
          "block_table": torch.zeros((max_seqs, max_blocks_per_seq),
                                     dtype=torch.int32, device=dev)}
    if kv_mode == "int8":
        kp, vp, ks, vs = make_kv_pool_quant(*dims, device=dev)
        st.update(k_scales=ks, v_scales=vs)
    else:
        kp, vp = make_kv_pool(*dims, dtype if dtype is not None
                              else act_dtype(cfg), dev)
    st.update(k_pool=kp, v_pool=vp)
    return st


def _final_logits(cfg, params, x):
    x = apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    return unembed(x, params["embed"], params.get("head")).float()


def prefill(cfg: ModelConfig, params: Params, state: Dict[str, torch.Tensor],
            batch: Dict[str, torch.Tensor], rt: Optional[dict] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Whole-prompt prefill of a wave: fills the pools, returns last-token
    logits [B, V] f32.

    batch: tokens [B, S] (right-padded), ctx_lens [B];
    state["block_table"] holds the wave's rows and state["seq_lens"] is
    set to ctx_lens.  Homogeneous full-attention stacks only; the
    ``rt["prefill_chunk"]`` variant (chunks read back from the pool) is
    not ported (ROADMAP A3)."""
    _require_ported(cfg)
    if (rt or {}).get("prefill_chunk"):
        raise NotImplementedError(
            "rt['prefill_chunk'] (chunked whole-prompt prefill) is not "
            "ported to repro_torch yet (ROADMAP A3)")
    tokens, ctx_lens = batch["tokens"], batch["ctx_lens"]
    x = params["embed"][tokens.long()].to(act_dtype(cfg))        # [B, S, d]
    state = dict(state)
    state["seq_lens"] = ctx_lens
    cache = cache_from_state(state)
    for li in range(cfg.num_layers):
        lp = _layer(params, li)
        hn = apply_norm(lp["attn_norm"], x, cfg.norm, cfg.norm_eps)
        mix, cache = attn_prefill(cfg, lp["attn"], hn,
                                  kind=cfg.layer_kind(li), cache=cache,
                                  layer=li, block_table=state["block_table"],
                                  ctx_lens=ctx_lens)
        x = x + mix
        hn = apply_norm(lp["mlp_norm"], x, cfg.norm, cfg.norm_eps)
        x = x + ffn(cfg, lp, hn)
    state.update(cache_to_state(cache))
    idx = (ctx_lens.long() - 1)[:, None, None].expand(-1, 1, x.shape[-1])
    return _final_logits(cfg, params, x.gather(1, idx)[:, 0]), state


def decode_step(cfg: ModelConfig, params: Params,
                state: Dict[str, torch.Tensor], tokens: torch.Tensor,
                rt: Optional[dict] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step for every slot.  tokens [B]: the last token per
    slot; state["seq_lens"] already counts it (0 = inactive slot, its KV
    write is dropped).  Returns (logits [B, V] f32, state)."""
    x = params["embed"][tokens.long()].to(act_dtype(cfg))          # [B, d]
    seq_lens = state["seq_lens"]
    cache = cache_from_state(state)
    for li in range(cfg.num_layers):
        lp = _layer(params, li)
        hn = apply_norm(lp["attn_norm"], x, cfg.norm, cfg.norm_eps)
        mix, cache = attn_decode(cfg, lp["attn"], hn,
                                 kind=cfg.layer_kind(li), cache=cache,
                                 layer=li, block_table=state["block_table"],
                                 seq_lens=seq_lens)
        x = x + mix
        hn = apply_norm(lp["mlp_norm"], x, cfg.norm, cfg.norm_eps)
        x = x + ffn(cfg, lp, hn[:, None])[:, 0]        # the [B, 1, d] route
    state = dict(state)
    state.update(cache_to_state(cache))
    return _final_logits(cfg, params, x), state


def _sample(logits, sampling: Dict[str, Any], counts, guard):
    return sample_from_logits(logits, sampling["keys"], counts,
                              sampling["temps"], sampling["top_ks"],
                              sampling["top_ps"],
                              poison=sampling.get("poison"), guard=guard,
                              plan=sampling.get("plan"))


def decode_megastep(cfg: ModelConfig, params: Params,
                    state: Dict[str, torch.Tensor], tokens: torch.Tensor,
                    sampling: Dict[str, Any], active: torch.Tensor,
                    n_steps: int, *, max_horizon: int,
                    rt: Optional[dict] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Up to ``max_horizon`` decode + sample steps with tokens fed on the
    device; the host reads the [max_horizon, B] buffer back once.

    ``n_steps`` is host-known (the scheduler's steps-until-boundary), so
    the loop runs exactly that many steps.  sampling: the per-slot rows
    (keys, counts, temps, top_ks, top_ps[, poison]) as host numpy arrays
    or device tensors, with an optional host ``"plan"``
    (``sampling.sampling_plan``); step t samples at stream position
    counts + t, a device add.  active [B] bool on the device: inactive
    slots keep their token and seq_len.  Rows >= n_steps of the returned
    buffer are zero.
    """
    guard = bool((rt or {}).get("sampling_guard"))
    out = torch.zeros((max_horizon, tokens.shape[0]), dtype=torch.int32,
                      device=tokens.device)
    active_i = active.to(torch.int32)
    toks = tokens
    counts = torch.as_tensor(sampling["counts"]).to(tokens.device)
    for t in range(int(n_steps)):
        logits, state = decode_step(cfg, params, state, toks, rt)
        nxt = _sample(logits, sampling, counts + t, guard)
        nxt = torch.where(active, nxt, toks)
        state["seq_lens"] = state["seq_lens"] + active_i
        out[t] = torch.where(active, nxt, torch.zeros_like(nxt))
        # a guarded -1 must not feed the next step's embedding lookup
        toks = nxt.clamp(min=0) if guard else nxt
    return out, state


def _scalar_i32(v, device) -> torch.Tensor:
    if torch.is_tensor(v):
        return v.reshape(()).to(device=device, dtype=torch.int32)
    return torch.tensor(int(v), dtype=torch.int32, device=device)


def prefill_chunk(cfg: ModelConfig, params: Params, cache, tokens:
                  torch.Tensor, block_table: torch.Tensor, pos_offset,
                  total_len, rt: Optional[dict] = None):
    """One fixed-width prefill chunk of ONE sequence.

    tokens [1, W] right-padded (positions pos_offset + i); block_table
    [1, MB] (the chunk's blocks already allocated); pos_offset /
    total_len: 0-d int32 device tensors (or ints), total_len =
    pos_offset + live chunk length.  Each layer writes the chunk's K/V
    into the pool at its absolute positions, then attends over the
    pool's live prefix plus its own raw K/V.  Returns (logits [1, V] of
    the last live token, cache).
    """
    _require_ported(cfg)
    dev = tokens.device
    W = tokens.shape[1]
    pos_offset = _scalar_i32(pos_offset, dev)
    total_len = _scalar_i32(total_len, dev)
    x = params["embed"][tokens.long()].to(act_dtype(cfg))        # [1, W, d]
    positions = pos_offset.long() + torch.arange(W, device=dev)
    ctx_lens = total_len.reshape(1)
    slopes = _slopes(cfg, dev)
    for li in range(cfg.num_layers):
        lp = _layer(params, li)
        hn = apply_norm(lp["attn_norm"], x, cfg.norm, cfg.norm_eps)
        q, k, v = _qkv(cfg, lp["attn"], hn, positions)
        cache = kv_write_prefill(cache, li, k, v, block_table, ctx_lens,
                                 pos_offset=pos_offset)
        # the chunk attends its OWN tokens raw, never pool-roundtripped
        o = ops.chunk_prefill_attention(
            q, cache.k, cache.v, cache.k_scale, cache.v_scale, li,
            block_table, pos_offset, total_len, k, v, slopes)
        x = x + linear(o.reshape(*o.shape[:2], -1), lp["attn"]["wo"])
        hn = apply_norm(lp["mlp_norm"], x, cfg.norm, cfg.norm_eps)
        x = x + ffn(cfg, lp, hn)
    last_i = (total_len.long() - pos_offset.long() - 1).clamp(0, W - 1)
    last = x.index_select(1, last_i.reshape(1))[:, 0]               # [1, d]
    return _final_logits(cfg, params, last), cache


def unified_step(cfg: ModelConfig, params: Params,
                 state: Dict[str, torch.Tensor], tokens: torch.Tensor,
                 sampling: Dict[str, Any], active: torch.Tensor,
                 chunk_tokens: torch.Tensor, chunk_block_table: torch.Tensor,
                 pos_offset, total_len, rt: Optional[dict] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One serving iteration: a decode step for every active slot, then
    ``seq_lens += active``, then one prefill chunk, then per-row sampling
    over B + 1 rows (row B is the chunk's last live token — meaningful
    only on a prompt's final chunk).  Returns (next_tokens [B + 1] i32,
    state)."""
    logits_dec, state = decode_step(cfg, params, state, tokens, rt)
    state["seq_lens"] = state["seq_lens"] + active.to(torch.int32)
    cache = cache_from_state(state)
    logits_chunk, cache = prefill_chunk(cfg, params, cache, chunk_tokens,
                                        chunk_block_table, pos_offset,
                                        total_len, rt)
    state.update(cache_to_state(cache))
    logits = torch.cat([logits_dec, logits_chunk], 0)
    nxt = _sample(logits, sampling, sampling["counts"],
                  bool((rt or {}).get("sampling_guard")))
    return nxt, state


def unified_step_chained(cfg: ModelConfig, params: Params,
                         state: Dict[str, torch.Tensor],
                         prev_tokens: torch.Tensor, chain_idx: torch.Tensor,
                         use_prev: torch.Tensor, tokens: torch.Tensor,
                         sampling: Dict[str, Any], active: torch.Tensor,
                         chunk_tokens: torch.Tensor,
                         chunk_block_table: torch.Tensor, pos_offset,
                         total_len, rt: Optional[dict] = None
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``unified_step`` with the decode feed tokens chained on the device,
    the async pipelined engine's step: row ``r`` is fed
    ``prev_tokens[chain_idx[r]]`` — the previous dispatch's ``[B + 1]``
    output buffer, still being produced when this one is enqueued (row B
    is the chunk sample) — where ``use_prev[r]``, else the host-known
    ``tokens[r]``.  The gathered token is clamped at 0: a row the guard
    sampled as -1 must not index the embedding (its successor is garbage
    the engine discards at reconcile)."""
    fed = torch.where(use_prev,
                      prev_tokens.index_select(0, chain_idx.long())
                      .clamp(min=0), tokens)
    return unified_step(cfg, params, state, fed, sampling, active,
                        chunk_tokens, chunk_block_table, pos_offset,
                        total_len, rt)
