"""LLaVA-NeXT (mistral-7b backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf] — VLM, GQA kv=8.

Backbone only; anyres vision tiling is a STUB — the caller passes
precomputed patch embeddings (batch, num_patches, d_model), which are
prepended to the text.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=32000,
    pos_emb="rope", act="silu", frontend="vision_patches",
    num_prefix_embeds=2880,  # anyres 4+1 tiles x 576 patches
)
