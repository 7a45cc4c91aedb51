"""RecurrentGemma-2B [arXiv:2402.19427; hf] — RG-LRU + local attention, 1:2 pattern, MQA kv=1.

Layers cycle (recurrent, recurrent, sliding): 18 RG-LRU layers, each
keeping a per-sequence recurrent state (``lru_h``) and conv state
(``rec_conv``), and 8 sliding-window attention layers, each keeping a
private ring of ``max_blocks_per_seq`` blocks per sequence.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
    head_dim=256, d_ff=7680, vocab_size=256000,
    attn_pattern=("recurrent", "recurrent", "sliding"), sliding_window=2048,
    pos_emb="rope", act="gelu", lru_width=2560, tie_embeddings=True,
)
