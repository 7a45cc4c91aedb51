"""Architecture registry of the port: the configs it serves today (the
dense full-attention decoders, command-r-plus-104b among them (layernorm,
a tied 256,000-token embedding), the sliding-window decoder
h2o-danube-3-4b,
the MoE decoder, the hybrid RG-LRU / sliding-window decoder
recurrentgemma-2b, the attention-free Mamba-1 stack falcon-mamba-7b, the
vision-prefixed decoder llava-next-mistral-7b and the audio encoder
hubert-xlarge, which runs ``transformer.forward`` only: an encoder has no
decode).

The JAX package registers ten families; the port adds each one with the
slice that ports its model code (ROADMAP A11).  Asking for a family that
is not ported yet raises ``NotImplementedError`` instead of a lookup error.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (command_r_plus_104b, falcon_mamba_7b,
                                 h2o_danube_3_4b, hubert_xlarge,
                                 llava_next_mistral_7b, qwen1_5_0_5b,
                                 qwen2_1_5b, qwen2_moe_a2_7b,
                                 recurrentgemma_2b)
from repro_torch.configs.base import ModelConfig, reduced

ARCHS: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG for m in (qwen2_1_5b, qwen1_5_0_5b,
                                       qwen2_moe_a2_7b, h2o_danube_3_4b,
                                       recurrentgemma_2b, falcon_mamba_7b,
                                       llava_next_mistral_7b, hubert_xlarge,
                                       command_r_plus_104b)}

# families of the JAX package that the port has not reached yet (kimi-k2
# needs expert parallelism across cards, ROADMAP A13)
NOT_PORTED = ("kimi-k2-1t-a32b",)


def get_config(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"{name!r} is not ported to repro_torch yet (ROADMAP A11: other "
            "model families)")
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")


def get_reduced(name: str, **overrides) -> ModelConfig:
    return reduced(get_config(name), **overrides)


__all__ = ["ARCHS", "get_config", "get_reduced", "reduced"]
