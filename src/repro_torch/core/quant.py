"""Packed-int4 weights and the quantized linear's plain version.

Codes are packed 8 per int32 along the *in* dimension, little nibble
first — the layout of the JAX package, which the Hopper kernel unpacks
with unsigned shifts in registers.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

PACK = 8  # int4 codes per int32 word


def pack_int4(q: np.ndarray) -> np.ndarray:
    """[in, out] uint8 codes (<16) -> [in//8, out] int32 (little-nibble-first)."""
    din, dout = q.shape
    pad = (-din) % PACK
    if pad:
        q = np.concatenate([q, np.zeros((pad, dout), q.dtype)], axis=0)
    q = q.reshape(-1, PACK, dout).astype(np.uint32)
    shifts = (4 * np.arange(PACK, dtype=np.uint32))[None, :, None]
    return (q << shifts).sum(axis=1).astype(np.uint32).view(np.int32)


def pack_codes(q: torch.Tensor) -> torch.Tensor:
    """[..., K, N] integer codes (< 16, K a multiple of 8) -> [..., K/8,
    N] int32 on q's device, the layout of ``pack_int4``."""
    *lead, K, N = q.shape
    if K % PACK:
        raise ValueError(f"in features {K} not a multiple of {PACK}")
    q = q.reshape(*lead, K // PACK, PACK, N).to(torch.int64)
    shifts = 4 * torch.arange(PACK, dtype=torch.int64, device=q.device)
    words = (q << shifts[:, None]).sum(dim=-2)
    return torch.where(words >= 2 ** 31, words - 2 ** 32,
                       words).to(torch.int32)


def make_quant_params(qt) -> Dict[str, torch.Tensor]:
    """The int4 dict of one quantized linear, from a
    ``core.gptq.QuantizedTensor``: {qweight [K/8, N] i32, scales / zeros
    [K/gs, N] f32, g_idx [K] i32}.  The groups must be contiguous and
    whole (g_idx == arange(K) // gs), as the int4 matmul kernel reads
    them."""
    K = qt.q.shape[0]
    gs = K // qt.scales.shape[0]
    want = torch.arange(K, device=qt.g_idx.device) // gs
    if K % qt.scales.shape[0] or not torch.equal(qt.g_idx.long(), want):
        raise ValueError("int4 weights need contiguous whole groups "
                         "(g_idx == arange(K) // group_size)")
    return {"qweight": pack_codes(qt.q), "scales": qt.scales.float(),
            "zeros": qt.zeros.float(), "g_idx": qt.g_idx.to(torch.int32)}


def unpack_int4(packed: torch.Tensor, din: int) -> torch.Tensor:
    """[in//8, out] int32 -> [in, out] int32 codes in [0, 16).

    The word is widened to int64 and masked to its 32 low bits first, so
    a code >= 8 in the top nibble (a negative int32) unpacks as the
    unsigned nibble, exactly like the JAX package's uint32 shift."""
    u = packed.to(torch.int64) & 0xFFFFFFFF
    shifts = 4 * torch.arange(PACK, dtype=torch.int64, device=packed.device)
    codes = (u[:, None, :] >> shifts[None, :, None]) & 0xF
    return codes.reshape(-1, packed.shape[-1])[:din].to(torch.int32)


def dequantize(params: Dict[str, torch.Tensor], din: int,
               dtype=torch.bfloat16) -> torch.Tensor:
    """Full dequant -> [in, out], groups looked up through ``g_idx``."""
    codes = unpack_int4(params["qweight"], din).float()
    g = params["g_idx"].long()
    s = params["scales"][g]
    z = params["zeros"][g]
    return ((codes - z) * s).to(dtype)


def quant_matmul_ref(x: torch.Tensor, params: Dict[str, torch.Tensor]
                     ) -> torch.Tensor:
    """y = x @ dequant(W) (+ bias). x: [..., in].  The dequantized weight
    is cast to x.dtype before the product, as the JAX reference does."""
    w = dequantize(params, x.shape[-1], x.dtype)
    y = x @ w
    if "bias" in params:
        y = y + params["bias"].to(y.dtype)
    return y
