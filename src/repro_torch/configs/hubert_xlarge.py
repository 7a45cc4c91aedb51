"""HuBERT-XLarge [arXiv:2106.07447] — encoder-only audio backbone (w2v2 arch), MHA kv=16.

Modality frontend is a STUB: the caller passes precomputed frame
embeddings (batch, seq, d_model). Encoder-only -> no decode shapes.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
    head_dim=80, d_ff=5120, vocab_size=504,
    is_encoder=True, pos_emb="alibi", act="gelu", norm="layernorm",
    frontend="audio_frames",
)
