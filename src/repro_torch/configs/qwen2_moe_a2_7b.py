"""Qwen1.5/2-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B] — MoE 60 routed top-4 + 4 shared, MHA kv=16."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
    head_dim=128, d_ff=1408, vocab_size=151936,
    qkv_bias=True, pos_emb="rope", act="silu",
    num_experts=60, num_shared_experts=4, moe_top_k=4, moe_d_ff=1408,
)
