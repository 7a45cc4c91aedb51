"""Architecture registry of the port: the configs it serves today (the
dense decoders and the MoE decoder).

The JAX package registers ten families; the port adds each one with the
slice that ports its model code (ROADMAP A11).  Asking for a family that
is not ported yet raises ``NotImplementedError`` instead of a lookup error.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import qwen1_5_0_5b, qwen2_1_5b, qwen2_moe_a2_7b
from repro_torch.configs.base import ModelConfig, reduced

ARCHS: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG for m in (qwen2_1_5b, qwen1_5_0_5b,
                                       qwen2_moe_a2_7b)}

# families of the JAX package that the port has not reached yet
NOT_PORTED = ("h2o-danube-3-4b", "command-r-plus-104b", "kimi-k2-1t-a32b",
              "falcon-mamba-7b", "recurrentgemma-2b", "hubert-xlarge",
              "llava-next-mistral-7b")


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
