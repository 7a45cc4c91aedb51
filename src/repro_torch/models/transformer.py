"""Model assembly (dense and MoE decoders, full-attention or
sliding-window, the hybrid of RG-LRU and sliding-window layers, the
attention-free Mamba-1 stack, the decoder behind a vision prefix and the
audio encoder, which has no decode): init / the plain full-sequence
forward (each layer rematerialised when autograd records it) and the
training loss / decode state /
whole-prompt prefill (into the paged pool, or the ring cache of a
sliding layer, and the per-sequence recurrent state of an RG-LRU or
Mamba layer) / decode step / megastep / prefill chunk / unified step,
and its variant chained on the device for the async engine.

The JAX package scans over layer-stacked params with ``lax.scan``; here a
Python loop walks the layers.  The params keep the JAX layout at the
public functions: ``params["layers"]`` (every leaf stacked on a leading L
axis) for a homogeneous stack, per-kind stacks ``rec_layers`` and
``attn_layers`` for the hybrid (``layer_plan`` maps layer i to its stack
and index).  The serving runner may pre-split the stacks into lists of
per-layer dicts once (``split_layers``), which every function here
accepts too; the trainer holds them as lists of independent per-layer
leaves (``unstack_layers``).  The paged pools are updated in place; the recurrent state
(``lru_h``, ``rec_conv``; a Mamba stack's ``ssm_h``, ``ssm_conv``) comes
back from each step as new tensors.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.kv_quant import (cache_from_state, cache_to_state,
                                       kv_write_prefill, make_kv_pool_quant,
                                       normalize_kv_cache_dtype)
from repro_torch.core.paged_cache import _scatter_rows, make_kv_pool
from repro_torch.core.sampling import sample_from_logits
from repro_torch.kernels import ops
from repro_torch.models.attention import (_qkv, _slopes, attn_apply,
                                         attn_decode, attn_init, attn_prefill)
from repro_torch.models.layers import (apply_norm, embed_init, linear,
                                       mlp_apply, mlp_init, norm_init,
                                       unembed)
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.models.ssm import (rglru_apply, rglru_decode, rglru_init,
                                    rglru_prefill, ssm_apply, ssm_decode,
                                    ssm_init, ssm_prefill)

Params = Dict[str, Any]


def act_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _layer_kinds(cfg: ModelConfig) -> frozenset:
    return frozenset(k for k, _, _ in layer_plan(cfg))


def supports_chunked_prefill(cfg: ModelConfig) -> bool:
    """Chunked serving prefill needs every layer's state in the paged pool:
    homogeneous full-attention stacks.  A sliding-window stack keeps a
    ring per sequence, and a recurrent or Mamba layer a state per
    sequence, which a chunk cannot re-enter mid-prompt, so they are
    served through whole-prompt waves, as in the reference."""
    return _layer_kinds(cfg) == {"full"} and not cfg.is_encoder


# the families the port serves: whether each has routed experts, the
# layer-kind sets it takes, and whether it is an encoder
PORTED_FAMILIES = {"dense": (False, ({"full"}, {"sliding"}), False),
                   "moe": (True, ({"full"}, {"sliding"}), False),
                   "hybrid": (False, ({"recurrent", "sliding"},
                                      {"recurrent"}), False),
                   "ssm": (False, ({"ssm"},), False),
                   "vlm": (False, ({"full"},), False),
                   "audio": (False, ({"full"},), True)}


def _require_ported(cfg: ModelConfig) -> None:
    """Dense and MoE decoders whose layers are all full attention or all
    sliding-window attention, the hybrid of RG-LRU and sliding-window
    layers, the Mamba-1 stack, the full-attention decoder behind a vision
    prefix and the full-attention audio encoder are ported; other
    families raise."""
    experts, kinds, encoder = PORTED_FAMILIES.get(cfg.family,
                                                  (None, (), None))
    if experts != bool(cfg.num_experts) or _layer_kinds(cfg) not in kinds \
            or cfg.is_encoder != encoder:
        raise NotImplementedError(
            f"{cfg.name}: only dense and MoE decoders of full-attention or "
            "sliding-window layers, the RG-LRU hybrid, the Mamba-1 stack, "
            "the vision-prefixed decoder and the audio encoder are ported "
            "to repro_torch so far (ROADMAP A11: other model families)")


def require_trainable(cfg: ModelConfig) -> None:
    """The trainer takes every ported family: the dense decoders (full
    attention or a sliding window), the MoE decoder (its routed experts'
    ``torch._grouped_mm`` products with their autograd, the dispatch and
    combine gathered through permutations), the RG-LRU hybrid and the
    Mamba-1 stack (the time-scan kernels' autograd rules, each with a
    reverse-time backward kernel), the decoder behind a vision prefix and
    the audio encoder.  Other families raise as ``_require_ported``
    does."""
    _require_ported(cfg)


def require_decoder(cfg: ModelConfig) -> None:
    """The serving entry points take a ported decoder; an encoder has no
    decode in the reference either (its serving-consistency test skips
    encoders, and its chunked prefill excludes them), so it is refused by
    name where a batch or a state enters: ``make_decode_state``,
    ``prefill`` and ``LLM.load``.  The decode step and the prefill chunk
    run only on a state that ``make_decode_state`` made."""
    _require_ported(cfg)
    if cfg.is_encoder:
        raise NotImplementedError(
            f"{cfg.name} is an encoder: it has no decode state, prefill or "
            "decode step (as in the reference); run transformer.forward on "
            "its frames")


@functools.lru_cache(maxsize=64)
def layer_plan(cfg: ModelConfig) -> Tuple[Tuple[str, str, int], ...]:
    """(kind, stack, index) of each layer.  A homogeneous stack's layer i
    is ``params["layers"]`` row i and pool (or ``ssm_h``) layer i.  A
    hybrid's layers are split by kind into ``rec_layers`` and
    ``attn_layers`` (as the reference's ``init_params``), and the index
    counts within the kind: an attention layer's row of the paged pool,
    a recurrent layer's row of ``lru_h`` / ``rec_conv``."""
    kinds = [cfg.layer_kind(i) for i in range(cfg.num_layers)]
    if len(set(kinds)) == 1:
        return tuple((k, "layers", i) for i, k in enumerate(kinds))
    seen = {"rec_layers": 0, "attn_layers": 0}
    plan = []
    for k in kinds:
        stack = "rec_layers" if k == "recurrent" else "attn_layers"
        plan.append((k, stack, seen[stack]))
        seen[stack] += 1
    return tuple(plan)


def attn_layer_count(cfg: ModelConfig) -> Tuple[int, int]:
    """(#attention layers, #recurrent (RG-LRU or Mamba) layers)."""
    na = sum(k in ("full", "sliding") for k, _, _ in layer_plan(cfg))
    return na, cfg.num_layers - na


def _require_chunkable(cfg: ModelConfig) -> None:
    if not supports_chunked_prefill(cfg):
        raise NotImplementedError(
            f"{cfg.name}: chunked prefill needs a full-attention stack; "
            "sliding-window, recurrent and Mamba stacks prefill whole "
            "prompts, as in the reference")


# --------------------------------------------------------------------------
# Params
# --------------------------------------------------------------------------

def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_layer(gen: Optional[torch.Generator], cfg: ModelConfig, device,
               kind: str = "full") -> Params:
    if kind == "ssm":                    # the mixer alone: no MLP
        return {"attn_norm": norm_init(cfg.d_model, cfg.norm, device),
                "ssm": ssm_init(gen, cfg, device)}
    p: Params = {"attn_norm": norm_init(cfg.d_model, cfg.norm, device),
                 "mlp_norm": norm_init(cfg.d_model, cfg.norm, device)}
    if kind == "recurrent":
        p["rec"] = rglru_init(gen, cfg, device)
    else:
        p["attn"] = attn_init(gen, cfg, device)
    if cfg.num_experts:
        p["moe"] = moe_init(gen, cfg, device)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, device)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                dtype: Optional[torch.dtype] = None,
                layer_fn: Optional[Callable[[Params], Params]] = None
                ) -> Params:
    """Random params from ``seed`` in the JAX package's layout (the
    numbers differ from ``jax.random``'s; tests bridge JAX params
    instead): f32, or with ``dtype`` every weight but the norms cast to
    it as it is drawn.  Each layer is drawn, cast and copied into
    preallocated layer stacks before the next, so a load peaks near the
    stored size plus one f32 layer (qwen2-moe in bf16: 28.6 GB, not the
    57 GB of an all-f32 tree).  ``layer_fn``, if given, transforms each
    drawn f32 layer before the cast and before it is stored, as
    ``LLM.load`` quantizes each layer to int4 as it is drawn: the codes
    come from the f32 weights, and ``cast_params`` passes int4 dicts
    through, so what is cast is what the runner would cast later
    (command-r-plus-104b then keeps its tied embedding in bf16 from the
    start, 6.29 GB, not 12.58 in f32).  ``device="meta"`` gives the shapes
    only.  A hybrid draws its layers in model order from the one seeded
    generator into the per-kind stacks (the reference folds
    ``hash(stack name)`` into each stack's key, which Python salts per
    process, ROADMAP C12; nothing here depends on a hash)."""
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
    if cfg.frontend == "audio_frames":
        params["frontend_proj"] = torch.randn(
            (cfg.d_model, cfg.d_model), generator=gen, device=dev) \
            * cfg.d_model ** -0.5
    if dtype is not None:
        params = cast_params(params, dtype)
    plan = layer_plan(cfg)
    sizes = {}
    for _, stack, _ in plan:
        sizes[stack] = sizes.get(stack, 0) + 1
    for kind, stack, j in plan:
        layer = init_layer(gen, cfg, dev, kind)
        if layer_fn is not None:
            layer = layer_fn(layer)
        if dtype is not None:
            layer = cast_params(layer, dtype)
        if stack not in params:
            params[stack] = _map(lambda t: torch.empty(
                (sizes[stack], *t.shape), dtype=t.dtype, device=dev),
                layer)
        _map(lambda dst, src: dst[j].copy_(src), params[stack], layer)
    return params


def _map(fn, tree, *rest):
    """fn over the leaves of ``tree`` (and the same leaves of ``rest``)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


STACKS = ("layers", "rec_layers", "attn_layers")


def split_layers(params: Params) -> Params:
    """The same params with each layer stack as a list of per-layer dicts
    of views — built once, so a step does not re-slice the stacks."""
    out = dict(params)
    for name in STACKS:
        layers = params.get(name)
        if layers is None or isinstance(layers, list):
            continue
        n = _leaves(layers)[0].shape[0]
        out[name] = [_index(layers, i) for i in range(n)]
    return out


def unstack_layers(tree: Params) -> Params:
    """The same tree (params, or AdamW moments shaped like them) with each
    layer stack as a list of per-layer dicts of new, independent tensors:
    the trainer's layout.  A gradient of a row of a stacked leaf would be
    a zero tensor of the whole stack's size per layer; a per-layer leaf
    has its own.  The caller's stacks stay alive until it drops them."""
    out = dict(tree)
    for name in STACKS:
        layers = out.get(name)
        if layers is None or isinstance(layers, list):
            continue
        n = _leaves(layers)[0].shape[0]
        out[name] = [_map(lambda t, i=i: t[i].clone(), layers)
                     for i in range(n)]
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


def _layer(params: Params, i: int, cfg: Optional[ModelConfig] = None
           ) -> Params:
    """Layer i's params: row i of ``layers``, or with ``cfg`` the row
    ``layer_plan`` names (a hybrid's per-kind stacks)."""
    stack, j = ("layers", i) if cfg is None else layer_plan(cfg)[i][1:]
    layers = params[stack]
    return layers[j] if isinstance(layers, list) else _index(layers, j)


# leaves the model reads in f32 whatever the activation dtype: the RG-LRU's
# decay parameter always, its and Mamba's conv taps in decode (cast only in
# prefill), and Mamba's A_log (A = -exp(A_log) in f32), conv bias (added
# in f32 in decode), dt_bias and D (cast at each use, as the reference
# does: kept f32, they give its numbers in every dtype); the audio
# frontend's projection, cast to the frames' dtype at the product (f32
# frames meet an f32 weight and the product is cast after, as in the
# reference)
_F32_LEAVES = ("a_param", "conv_w", "A_log", "conv_b", "dt_bias", "D",
               "frontend_proj")


def keeps_dtype(path: str) -> bool:
    """``cast_params``'s rule for the leaf at a dotted ``path`` (or under a
    key): norm weights stay f32, since the norms read them in f32, and so
    do the leaves of ``_F32_LEAVES``."""
    keys = path.split(".")
    return any(k.endswith("norm") for k in keys) or keys[-1] in _F32_LEAVES


def cast_params(params: Params, dtype: torch.dtype) -> Params:
    """Cast every weight that the model only ever uses cast to the
    activation dtype (dense matrices, embeddings, biases) once, up front.
    Bit-identical to casting at each product; the leaves ``keeps_dtype``
    names stay f32 and int4 dicts stay as they are."""
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
    """One pre-norm layer: attention or the RG-LRU, then the FFN.
    ``tap``, if given, sees the input of each block's linears:
    ``tap("attn", h)`` and ``tap("mlp", h)``."""
    h = apply_norm(lp["attn_norm"], x, cfg.norm, cfg.norm_eps)
    if tap is not None:
        tap("attn", h)
    if kind == "ssm":                    # the mixer alone: no MLP
        return x + ssm_apply(cfg, lp["ssm"], h)
    if kind == "recurrent":
        x = x + rglru_apply(cfg, lp["rec"], h)
    else:
        x = x + attn_apply(cfg, lp["attn"], h, kind=kind)
    h = apply_norm(lp["mlp_norm"], x, cfg.norm, cfg.norm_eps)
    if tap is not None:
        tap("mlp", h)
    return x + ffn(cfg, lp, h)


def ffn(cfg: ModelConfig, lp: Params, h: torch.Tensor) -> torch.Tensor:
    """The layer's FFN on h [B, S, d]: the routed and shared experts of
    an MoE layer, else the dense MLP (SwiGLU, or the non-gated GELU
    MLP)."""
    if "moe" in lp:
        return moe_apply(cfg, lp["moe"], h)
    return mlp_apply(lp["mlp"], h, cfg.act)


def _embed_inputs(cfg: ModelConfig, params: Params, batch: Dict[str, Any]
                  ) -> torch.Tensor:
    """The model's input rows [B, S, d] in the activation dtype, as the
    reference's: the audio frontend projects ``batch["frames"]`` [B, S,
    d] through ``frontend_proj`` (in the frames' dtype, cast after);
    otherwise the tokens' embeddings, with the vision frontend's
    ``batch["vision_embeds"]`` [B, P, d] (cast to the embedding's dtype)
    put before them when the batch has them.  Tokens, frames and vision
    embeddings may be tensors or numpy arrays."""
    emb = params["embed"]
    if cfg.frontend == "audio_frames":
        x = linear(torch.as_tensor(batch["frames"]).to(emb.device),
                   params["frontend_proj"])
    else:
        tokens = torch.as_tensor(batch["tokens"]).to(emb.device).long()
        x = emb[tokens]
        if cfg.frontend == "vision_patches" and "vision_embeds" in batch:
            ve = torch.as_tensor(batch["vision_embeds"]).to(emb.device)
            x = torch.cat([ve.to(x.dtype), x], 1)
    return x.to(act_dtype(cfg))


def _needs_grad(x: torch.Tensor, lp: Params) -> bool:
    return torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in _leaves(lp)))


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, Any]
            ) -> torch.Tensor:
    """Full forward -> logits [B, S, V] in the activation dtype: causal
    for a decoder (S counts a vision prefix), bidirectional for an
    encoder; a Python loop over the layers.  When autograd records the
    layer (grad enabled and a param or the input requires grad), the
    layer runs under ``torch.utils.checkpoint`` and is recomputed in the
    backward, as the reference's trainer runs each layer under
    ``jax.checkpoint`` with ``nothing_saveable``: only each layer's input
    is kept.  Under ``no_grad`` / ``inference_mode`` the path is the plain
    loop."""
    _require_ported(cfg)
    x = _embed_inputs(cfg, params, batch)
    for i, (kind, _, _) in enumerate(layer_plan(cfg)):
        lp = _layer(params, i, cfg)
        if _needs_grad(x, lp):
            # no random draw in a layer: no RNG state to stash
            x = checkpoint(functools.partial(apply_layer, cfg), lp, x, kind,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = apply_layer(cfg, lp, x, kind)
    x = apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    return unembed(x, params["embed"], params.get("head"))


def loss_fn(cfg: ModelConfig, params: Params, batch: Dict[str, Any]
            ) -> torch.Tensor:
    """Next-token (or, for an encoder, frame-label) cross entropy, the mean
    over valid tokens, as the reference's ``loss_fn``: a decoder reads
    ``tokens[:, :-1]`` and is scored on ``tokens[:, 1:]`` (a vision prefix
    sliced off the logits); an encoder reads ``frames`` and is scored on
    ``labels``; logits in f32, ``logsumexp - gold``, weighted by
    ``loss_mask`` when the batch has one.  Returns a 0-d f32 tensor."""
    if cfg.is_encoder:
        logits = forward(cfg, params, batch)
        labels = batch["labels"]
    else:
        tokens = batch["tokens"]
        logits = forward(cfg, params, {**batch, "tokens": tokens[:, :-1]})
        labels = tokens[:, 1:]
        if cfg.frontend == "vision_patches" and "vision_embeds" in batch:
            logits = logits[:, batch["vision_embeds"].shape[1]:]
    logits = logits.float()
    labels = torch.as_tensor(labels).to(logits.device).long()
    lse = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, labels[..., None])[..., 0]
    nll = lse - gold
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = torch.as_tensor(mask).to(nll.device, nll.dtype)
        return (nll * mask).sum() / mask.sum().clamp(min=1.0)
    return nll.mean()


# --------------------------------------------------------------------------
# Serving: decode state + decode_step + megastep + prefill chunk
# --------------------------------------------------------------------------

def make_decode_state(cfg: ModelConfig, max_seqs: int, num_blocks: int,
                      max_blocks_per_seq: int, dtype=None,
                      kv_cache_dtype: Optional[str] = None,
                      device="cuda") -> Dict[str, torch.Tensor]:
    """seq_lens [B] i32 and, when the model has L > 0 attention layers,
    block_table [B, MB] i32 and the (k, v) pools [L, NB, BS, KV, D]: of
    ``dtype`` (the activation dtype by default), or with
    ``kv_cache_dtype="int8"`` int8 values plus the (k, v) scale pools [L,
    NB, KV] f32 (full-attention layers only, as in the reference).  A
    hybrid adds each recurrent layer's per-slot state: ``lru_h`` [nr, B,
    w] f32 and ``rec_conv`` [nr, B, w, 3] of ``dtype``.  A Mamba stack
    has no pool and no table, only its per-slot state: ``ssm_h`` [L, B,
    din, N] f32 and ``ssm_conv`` [L, B, din, W-1] of ``dtype``.  An encoder has none: refused by name."""
    require_decoder(cfg)
    kv_mode = normalize_kv_cache_dtype(kv_cache_dtype)
    na, nr = attn_layer_count(cfg)
    if kv_mode == "int8" and not na:
        raise ValueError(
            f"kv_cache_dtype='int8' requested but {cfg.name} has no "
            "attention KV cache to quantize (attention-free family "
            f"{cfg.family!r}); drop the flag — SSM/recurrent state pools "
            "are not paged KV")
    if kv_mode == "int8" and "sliding" in _layer_kinds(cfg):
        raise ValueError(
            "kv_cache_dtype='int8' does not support sliding-window "
            f"(ring-cache) attention layers ({cfg.name}); the ring "
            "overwrite pattern defeats per-block scale tracking")
    dev = resolve_device(device)
    dtype = dtype if dtype is not None else act_dtype(cfg)
    st = {"seq_lens": torch.zeros(max_seqs, dtype=torch.int32, device=dev)}
    if na:
        dims = (na, num_blocks, cfg.paging.block_size,
                cfg.num_kv_heads, cfg.resolved_head_dim)
        st["block_table"] = torch.zeros((max_seqs, max_blocks_per_seq),
                                        dtype=torch.int32, device=dev)
        if kv_mode == "int8":
            kp, vp, ks, vs = make_kv_pool_quant(*dims, device=dev)
            st.update(k_scales=ks, v_scales=vs)
        else:
            kp, vp = make_kv_pool(*dims, dtype, dev)
        st.update(k_pool=kp, v_pool=vp)
    if cfg.family == "ssm":
        din = cfg.ssm_expand * cfg.d_model
        st["ssm_h"] = torch.zeros((cfg.num_layers, max_seqs, din,
                                   cfg.ssm_state), dtype=torch.float32,
                                  device=dev)
        st["ssm_conv"] = torch.zeros((cfg.num_layers, max_seqs, din,
                                      cfg.ssm_conv - 1), dtype=dtype,
                                     device=dev)
    elif nr:
        w = cfg.lru_width or cfg.d_model
        st["lru_h"] = torch.zeros((nr, max_seqs, w), dtype=torch.float32,
                                  device=dev)
        st["rec_conv"] = torch.zeros((nr, max_seqs, w, 3), dtype=dtype,
                                     device=dev)
    return st


def _final_logits(cfg, params, x):
    x = apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    return unembed(x, params["embed"], params.get("head")).float()


def prefill(cfg: ModelConfig, params: Params, state: Dict[str, torch.Tensor],
            batch: Dict[str, torch.Tensor], rt: Optional[dict] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Whole-prompt prefill of a wave: fills the pools, returns last-token
    logits [B, V] f32.

    batch: tokens [B, S] (right-padded), ctx_lens [B], and for the vision
    frontend optionally vision_embeds [B, P, d], which go before the
    tokens and count as context: positions run over prefix and text, and
    state["seq_lens"] is set to P + ctx_lens (ctx_lens alone without a
    prefix); state["block_table"] holds the wave's rows.  Full-attention layers write the paged pool,
    sliding-window layers their ring (``attn_prefill_ring``), RG-LRU
    layers return the wave's rows of ``lru_h`` / ``rec_conv`` (the state
    at each row's ctx_len) as new tensors [nr, B, ...], Mamba layers
    those of ``ssm_h`` / ``ssm_conv`` [L, B, ...] (a Mamba stack has no
    pool and no ``block_table``).  The
    ``rt["prefill_chunk"]`` variant (chunks read back from the pool) is
    not ported (ROADMAP A3)."""
    require_decoder(cfg)
    if (rt or {}).get("prefill_chunk"):
        raise NotImplementedError(
            "rt['prefill_chunk'] (chunked whole-prompt prefill) is not "
            "ported to repro_torch yet (ROADMAP A3)")
    tokens, ctx_lens = batch["tokens"], batch["ctx_lens"]
    x = _embed_inputs(cfg, params, batch)                       # [B, S, d]
    if x.shape[1] != tokens.shape[1]:     # a vision prefix counts as context
        ctx_lens = ctx_lens + (x.shape[1] - tokens.shape[1])
    state = dict(state)
    state["seq_lens"] = ctx_lens
    cache = cache_from_state(state) if "k_pool" in state else None
    mask = torch.arange(x.shape[1], device=x.device)[None, :] \
        < ctx_lens.long()[:, None]
    lru_h, rec_conv, ssm_h, ssm_conv = [], [], [], []
    for li, (kind, _, j) in enumerate(layer_plan(cfg)):
        lp = _layer(params, li, cfg)
        hn = apply_norm(lp["attn_norm"], x, cfg.norm, cfg.norm_eps)
        if kind == "ssm":
            mix, h, conv = ssm_prefill(cfg, lp["ssm"], hn, mask, ctx_lens)
            ssm_h.append(h)
            ssm_conv.append(conv.to(state["ssm_conv"].dtype))
            x = x + mix
            continue
        if kind == "recurrent":
            mix, h, conv = rglru_prefill(cfg, lp["rec"], hn, mask, ctx_lens)
            lru_h.append(h)
            rec_conv.append(conv.to(state["rec_conv"].dtype))
        else:
            pf = attn_prefill_ring if kind == "sliding" else attn_prefill
            mix, cache = pf(cfg, lp["attn"], hn, kind=kind, cache=cache,
                            layer=j, block_table=state["block_table"],
                            ctx_lens=ctx_lens)
        x = x + mix
        hn = apply_norm(lp["mlp_norm"], x, cfg.norm, cfg.norm_eps)
        x = x + ffn(cfg, lp, hn)
    if cache is not None:
        state.update(cache_to_state(cache))
    _stack_states(state, lru_h=lru_h, rec_conv=rec_conv, ssm_h=ssm_h,
                  ssm_conv=ssm_conv)
    idx = (ctx_lens.long() - 1)[:, None, None].expand(-1, 1, x.shape[-1])
    return _final_logits(cfg, params, x.gather(1, idx)[:, 0]), state


def attn_prefill_ring(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                      kind: str, cache, layer: int,
                      block_table: torch.Tensor, ctx_lens: torch.Tensor):
    """Sliding-window prefill: the static flash kernel inside the window,
    then each token's K/V written at ring slot pos % cache_len (cache_len
    = MB * BS, the block table's width).  Only the last cache_len
    positions of each sequence are written, so a prompt longer than the
    ring keeps its most recent tokens and no two kept tokens share a slot.
    bf16 (or f32) pools only: int8 is refused at ``make_decode_state``.
    Returns (y [B, S, d], cache)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    q, k, v = _qkv(cfg, p, x, positions)
    o = ops.flash_attention(q, k, v, _slopes(cfg, x.device), causal=True,
                            sliding_window=cfg.sliding_window)
    cache_len = block_table.shape[1] * cache.k.shape[2]
    lens = ctx_lens.long()[:, None]
    keep = (positions[None] >= lens - cache_len) & (positions[None] < lens)
    _write_ring(cache.k, layer, k, block_table, positions, keep, cache_len)
    _write_ring(cache.v, layer, v, block_table, positions, keep, cache_len)
    y = linear(o.reshape(B, S, -1), p["wo"])
    return y, cache


def _write_ring(pool: torch.Tensor, layer: int, k: torch.Tensor,
                block_table: torch.Tensor, positions: torch.Tensor,
                keep: torch.Tensor, cache_len: int) -> torch.Tensor:
    """Scatter k [B, S, KV, D] (k[:, i] at positions[i]) into ring slots
    positions % cache_len of each row's blocks, in place; rows where
    ``keep`` [B, S] is False are dropped (redirected, never indexed out of
    range: ``paged_cache._scatter_rows``)."""
    B, S = k.shape[:2]
    NB, bs = pool.shape[1], pool.shape[2]
    slot = positions.long() % cache_len                           # [S]
    blk = block_table[:, slot // bs].long()                       # [B, S]
    flat = blk * bs + (slot % bs)[None, :]
    lp = pool[layer].view(NB * bs, *pool.shape[3:])
    _scatter_rows(lp, flat.reshape(-1),
                  k.reshape(B * S, *k.shape[2:]).to(pool.dtype),
                  keep.reshape(-1))
    return pool


def decode_step(cfg: ModelConfig, params: Params,
                state: Dict[str, torch.Tensor], tokens: torch.Tensor,
                rt: Optional[dict] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step for every slot.  tokens [B]: the last token per
    slot; state["seq_lens"] already counts it (0 = inactive slot, its KV
    write is dropped).  RG-LRU and Mamba layers step every slot's state
    row (``lru_h`` / ``rec_conv``, ``ssm_h`` / ``ssm_conv``), as the
    reference does, and return them as new tensors.  Returns (logits [B,
    V] f32, state)."""
    x = params["embed"][tokens.long()].to(act_dtype(cfg))          # [B, d]
    seq_lens = state["seq_lens"]
    cache = cache_from_state(state) if "k_pool" in state else None
    lru_h, rec_conv, ssm_h, ssm_conv = [], [], [], []
    for li, (kind, _, j) in enumerate(layer_plan(cfg)):
        lp = _layer(params, li, cfg)
        hn = apply_norm(lp["attn_norm"], x, cfg.norm, cfg.norm_eps)
        if kind == "ssm":
            mix, h, conv = ssm_decode(cfg, lp["ssm"], hn, state["ssm_h"][j],
                                      state["ssm_conv"][j])
            ssm_h.append(h)
            ssm_conv.append(conv)
            x = x + mix
            continue
        if kind == "recurrent":
            mix, h, conv = rglru_decode(cfg, lp["rec"], hn,
                                        state["lru_h"][j],
                                        state["rec_conv"][j])
            lru_h.append(h)
            rec_conv.append(conv)
        else:
            mix, cache = attn_decode(cfg, lp["attn"], hn, kind=kind,
                                     cache=cache, layer=j,
                                     block_table=state["block_table"],
                                     seq_lens=seq_lens)
        x = x + mix
        hn = apply_norm(lp["mlp_norm"], x, cfg.norm, cfg.norm_eps)
        x = x + ffn(cfg, lp, hn[:, None])[:, 0]        # the [B, 1, d] route
    state = dict(state)
    if cache is not None:
        state.update(cache_to_state(cache))
    _stack_states(state, lru_h=lru_h, rec_conv=rec_conv, ssm_h=ssm_h,
                  ssm_conv=ssm_conv)
    return _final_logits(cfg, params, x), state


def _stack_states(state: Dict[str, torch.Tensor], **rows) -> None:
    """Each per-layer list of recurrent state rows that a step filled,
    stacked into ``state`` as a new tensor [layers, B, ...]."""
    for name, per_layer in rows.items():
        if per_layer:
            state[name] = torch.stack(per_layer)


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
    toks = tokens
    counts = torch.as_tensor(sampling["counts"]).to(tokens.device)
    for t in range(int(n_steps)):
        row, toks, state = decode_sample_step(cfg, params, state, toks,
                                              sampling, active, counts + t,
                                              guard, rt)
        out[t] = row
    return out, state


def decode_sample_step(cfg: ModelConfig, params: Params,
                       state: Dict[str, torch.Tensor], tokens: torch.Tensor,
                       sampling: Dict[str, Any], active: torch.Tensor,
                       counts: torch.Tensor, guard: bool,
                       rt: Optional[dict] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor,
                                  Dict[str, torch.Tensor]]:
    """One step of the megastep: decode every slot, sample at stream
    positions ``counts``, then ``seq_lens += active``; inactive slots keep
    their token.  Returns (the step's row of the token buffer: sampled
    tokens of active slots, 0 elsewhere; the next step's feed tokens;
    state).  The runner's captured megastep replays exactly this."""
    logits, state = decode_step(cfg, params, state, tokens, rt)
    nxt = _sample(logits, sampling, counts, guard)
    nxt = torch.where(active, nxt, tokens)
    state["seq_lens"] = state["seq_lens"] + active.to(torch.int32)
    row = torch.where(active, nxt, torch.zeros_like(nxt))
    # a guarded -1 must not feed the next step's embedding lookup
    return row, (nxt.clamp(min=0) if guard else nxt), state


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
    _require_chunkable(cfg)
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
