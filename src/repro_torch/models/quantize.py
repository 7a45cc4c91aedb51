"""Model-level int4 quantization: round-to-nearest (RTN) of every matmul
weight, in torch on the params' device, bit-exact with the JAX package's
``quantize_params_rtn``.

``gptq-int4`` (Hessian OBQ over calibration activations, ``core/gptq.py``)
is not ported yet (ROADMAP A7).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quant import PACK

# the dense decoders' linears; the other families' targets come with them
QUANT_TARGETS = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"}


def _rtn_pack(w2: torch.Tensor, group_size: int) -> Dict[str, torch.Tensor]:
    """RTN int4 pack of [..., K, N] weights (leading dims are layer
    stacks); every leaf of the result keeps the leading dims."""
    *lead, K, N = w2.shape
    gs = group_size if (K % group_size == 0 and K >= group_size) else K
    G = K // gs
    wg = w2.reshape(*lead, G, gs, N).float()
    wmax = wg.amax(dim=-2).clamp(min=0)
    wmin = wg.amin(dim=-2).clamp(max=0)
    rng = wmax - wmin
    scale = torch.where(rng > 0, rng / 15.0, torch.ones_like(rng))
    zero = torch.round(-wmin / scale)
    q = torch.clamp(torch.round(wg / scale.unsqueeze(-2)
                                + zero.unsqueeze(-2)), 0, 15)
    q = q.reshape(*lead, K // PACK, PACK, N).to(torch.int64)
    shifts = 4 * torch.arange(PACK, dtype=torch.int64, device=w2.device)
    words = (q << shifts[:, None]).sum(dim=-2)             # [..., K/8, N]
    packed = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    g_idx = (torch.arange(K, dtype=torch.int32, device=w2.device) // gs)
    return {"qweight": packed.to(torch.int32), "scales": scale,
            "zeros": zero, "g_idx": g_idx.expand(*lead, K).contiguous()}


def _din_for(name: str, w: torch.Tensor, cfg: ModelConfig) -> int:
    if name == "w_down":
        return w.shape[-2]
    if name == "wo":
        return cfg.num_heads * cfg.resolved_head_dim
    return cfg.d_model


def _quantize_leaf(w: torch.Tensor, din: int, group_size: int,
                   n_lead: int = 0) -> Dict[str, torch.Tensor]:
    lead = tuple(w.shape[:n_lead])
    n = 1
    for s in w.shape[n_lead:]:
        n *= s
        if n == din:
            return _rtn_pack(w.reshape(*lead, din, -1), group_size)
        if n > din:
            break
    raise ValueError(f"cannot split {tuple(w.shape)} (lead={n_lead}) at "
                     f"din={din}")


def quantize_params_rtn(params: Dict[str, Any], cfg: ModelConfig,
                        group_size: int = 128) -> Dict[str, Any]:
    """Replace every QUANT_TARGETS leaf with its int4 dict
    {qweight [.., K/8, N] i32, scales/zeros [.., K/gs, N] f32,
    g_idx [.., K] i32}."""

    def walk(tree, stacked):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, stacked or k.endswith("layers"))
            elif k in QUANT_TARGETS:
                out[k] = _quantize_leaf(v, _din_for(k, v, cfg), group_size,
                                        n_lead=1 if stacked else 0)
            else:
                out[k] = v
        return out

    return walk(params, False)

