"""Model / quantization / parallelism configuration dataclasses (a copy of
the JAX package's ``configs/base.py``: pure dataclasses, no framework).

Every assigned architecture is expressed as a ``ModelConfig``; the shape
sets (train_4k / prefill_32k / decode_32k / long_500k) are ``ShapeConfig``
instances attached per-arch in the registry.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class QuantConfig:
    """GPTQ weight-quantization settings (paper §III, the 'GPTQ' in Opt-GPTQ)."""
    bits: int = 4
    group_size: int = 128          # one (scale, zero) per group of in-features
    sym: bool = False              # asymmetric by default (zero-points kept)
    damp_frac: float = 0.01        # Hessian dampening lambda = damp_frac * mean(diag H)
    act_order: bool = True         # quantize columns in decreasing-Hessian order
    block_size: int = 128          # OBQ lazy-update block width


@dataclass(frozen=True)
class PagingConfig:
    """Paged KV-cache settings (paper §III.A 'paging memory management')."""
    block_size: int = 16           # tokens per KV block
    num_blocks: int = 0            # 0 => derived from max_seqs * max_seq_len
    enable_prefix_reuse: bool = True
    watermark_frac: float = 0.01   # free-block watermark before admission
    cache_dtype: str = "bfloat16"  # "float8_e4m3fn" halves pool bytes/traffic


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


# The four assigned LM shape cells.
TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 => d_model // num_heads
    qkv_bias: bool = False
    # --- attention layout ---
    attn_pattern: Tuple[str, ...] = ("full",)   # cycled over layers: full|sliding|recurrent
    sliding_window: int = 0
    pos_emb: str = "rope"          # rope | alibi | none
    rope_theta: float = 10000.0
    is_encoder: bool = False       # bidirectional attention, no KV cache / decode
    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0              # per-expert hidden; dense layers use d_ff
    # --- SSM (mamba-1) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    # --- hybrid (RG-LRU) ---
    lru_width: int = 0
    # --- misc ---
    act: str = "silu"
    norm: str = "rmsnorm"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # --- modality frontend stubs ---
    frontend: str = "none"         # none | audio_frames | vision_patches
    num_prefix_embeds: int = 0     # vlm: patch embeds prepended to the text seq
    # --- paper technique knobs ---
    quant: Optional[QuantConfig] = None
    paging: PagingConfig = field(default_factory=PagingConfig)
    use_alibi_serving: bool = False  # serve-time ALiBi bias (paper default on)

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_subquadratic(self) -> bool:
        """Whether long_500k decode is admissible (no full-attention layer)."""
        if self.family == "ssm":
            return True
        pats = set(self.attn_pattern)
        return "full" not in pats

    def layer_kind(self, i: int) -> str:
        """Kind of mixer at layer ``i`` (cycles attn_pattern)."""
        if self.family == "ssm":
            return "ssm"
        return self.attn_pattern[i % len(self.attn_pattern)]

    def num_params(self) -> int:
        """Analytic parameter count (embeddings included once)."""
        d, h = self.d_model, self.resolved_head_dim
        n = self.vocab_size * d                       # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d                  # lm head
        for i in range(self.num_layers):
            kind = self.layer_kind(i)
            if kind == "ssm":
                d_in = self.ssm_expand * d
                dt_rank = (d + self.ssm_state - 1) // self.ssm_state
                n += d * 2 * d_in                      # in_proj
                n += d_in * self.ssm_conv              # conv
                n += d_in * (dt_rank + 2 * self.ssm_state)  # x_proj
                n += dt_rank * d_in + d_in             # dt_proj
                n += d_in * self.ssm_state + 2 * d_in  # A_log, D, etc
                n += d_in * d                          # out_proj
            elif kind == "recurrent":
                w = self.lru_width or d
                n += d * w * 2 + w * d                 # linear in (x2) + out
                n += 3 * w                             # RG-LRU params (a, gates simplified)
                n += 2 * w * 4                         # conv1d-ish temporal mix
            else:  # attention
                n += d * self.num_heads * h            # Wq
                n += 2 * d * self.num_kv_heads * h     # Wk, Wv
                n += self.num_heads * h * d            # Wo
                if self.qkv_bias:
                    n += (self.num_heads + 2 * self.num_kv_heads) * h
            # MLP / MoE
            if kind != "ssm":
                if self.num_experts:
                    n += self.num_experts * 3 * d * self.moe_d_ff
                    n += self.num_shared_experts * 3 * d * self.moe_d_ff
                    n += d * self.num_experts          # router
                else:
                    mult = 3 if self.act in ("silu", "swiglu") else 2
                    n += mult * d * self.d_ff
            n += 2 * d                                 # norms
        return n

    def num_active_params(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if not self.num_experts:
            return self.num_params()
        full = self.num_params()
        routed_all = self.num_layers * self.num_experts * 3 * self.d_model * self.moe_d_ff
        routed_active = self.num_layers * self.moe_top_k * 3 * self.d_model * self.moe_d_ff
        return full - routed_all + routed_active

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    kw = dict(
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 4) or 1,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
    )
    if cfg.num_experts:
        kw.update(num_experts=4, num_shared_experts=min(cfg.num_shared_experts, 1),
                  moe_top_k=2, moe_d_ff=32)
    if cfg.family == "ssm":
        kw.update(num_heads=1, num_kv_heads=1, ssm_state=4, d_ff=0)
    if cfg.family == "hybrid":
        kw.update(lru_width=64, num_kv_heads=1)
    if cfg.sliding_window:
        kw.update(sliding_window=32)
    if cfg.num_prefix_embeds:
        kw.update(num_prefix_embeds=8)
    kw.update(overrides)
    return cfg.replace(**kw)
