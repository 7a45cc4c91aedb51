"""Falcon-Mamba-7B [arXiv:2410.05355] — attention-free Mamba-1.

64 layers, each an RMSNorm then the Mamba-1 mixer (no MLP): in_proj
d 4096 -> 2 x din 8192, a causal depthwise conv of width 4, the selective
scan over a state of 16 per channel, out_proj din -> d.  Each sequence
keeps a fixed state per layer (``ssm_h`` [din, 16] f32 and ``ssm_conv``
[din, 3]) whatever its length: no KV cache, no paged pool.  Opt-GQA does
not apply (no attention); the int4 weights cover in_proj and out_proj.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    num_layers=64, d_model=4096, num_heads=1, num_kv_heads=1,
    d_ff=0, vocab_size=65024, head_dim=64,
    pos_emb="none", ssm_state=16, ssm_conv=4, ssm_expand=2,
    tie_embeddings=True,
)
