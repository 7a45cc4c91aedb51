"""H2O-Danube-3-4B [arXiv:2401.16818] — dense llama+mistral mix, GQA kv=8, SWA.

All layers use a sliding window (mistral style): each serving sequence
keeps its K/V in a private ring of ``max_blocks_per_seq`` blocks.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    num_layers=24, d_model=3840, num_heads=32, num_kv_heads=8,
    head_dim=120, d_ff=10240, vocab_size=32000,
    attn_pattern=("sliding",), sliding_window=8192,
    pos_emb="rope", act="silu",
)
