"""Building blocks of the decoders (plain functions, dict params).

Params are f32 as in the JAX package; each product casts its weight to
the activation dtype; norms and RoPE angles are computed in f32.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------- init utils
def dense_init(gen: torch.Generator, shape, in_axis_size: Optional[int] = None,
               device="cpu") -> torch.Tensor:
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    # scaled in place: the same numbers without a second full-size buffer
    return torch.randn(shape, generator=gen, device=device).mul_(
        fan_in ** -0.5)


# ---------------------------------------------------------------- norms
def norm_init(d: int, kind: str, device="cpu") -> Params:
    """RMSNorm's weight ``w``; layernorm adds a zero bias ``b``."""
    p = {"w": torch.ones(d, device=device)}
    if kind == "layernorm":
        p["b"] = torch.zeros(d, device=device)
    return p


def apply_norm(p: Params, x: torch.Tensor, kind: str, eps: float
               ) -> torch.Tensor:
    """RMSNorm, or layernorm (mean and biased variance), in f32; the
    weight and layernorm's bias are applied to the f32 normalised value
    before the cast back to x's dtype, as in the reference."""
    xf = x.float()
    if kind == "rmsnorm":
        xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        return (xf * p["w"].float()).to(x.dtype)
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return (xf * p["w"].float() + p["b"].float()).to(x.dtype)


# ---------------------------------------------------------------- RoPE
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """NeoX half-split RoPE. x: [B, S, H, D]; positions: [S] or [B, S]."""
    d2 = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, d2, dtype=torch.float32,
                                    device=x.device) / d2)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs                  # [B,S,D/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     -1).to(x.dtype)


# ---------------------------------------------------------------- activations
def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (torch's default
    is the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu, "relu": F.relu}[name]


# ---------------------------------------------------------------- dense MLP
def mlp_init(gen: torch.Generator, d: int, f: int, act: str,
             device="cpu") -> Params:
    """SwiGLU (``w_gate``, ``w_up``, ``w_down``) for silu, else the
    non-gated MLP (``w_up``, ``w_down``)."""
    p = {}
    if act in ("silu", "swiglu"):
        p["w_gate"] = dense_init(gen, (d, f), device=device)
    p["w_up"] = dense_init(gen, (d, f), device=device)
    p["w_down"] = dense_init(gen, (f, d), in_axis_size=f, device=device)
    return p


def mlp_apply(p: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    if "w_gate" in p:
        g = linear(x, p["w_gate"])
        u = linear(x, p["w_up"])
        return linear(act_fn(act)(g) * u, p["w_down"])
    return linear(act_fn(act)(linear(x, p["w_up"])), p["w_down"])


# ---------------------------------------------------------------- linear
def linear(x: torch.Tensor, w, out_tail: Optional[tuple] = None
           ) -> torch.Tensor:
    """x: [..., din] @ w.

    ``w`` is a dense tensor whose leading dims multiply to din (wq
    [d, H, Dh], wo [H, Dh, d]) or an int4 dict {qweight, scales, zeros,
    g_idx} that goes through ``ops.quant_matmul`` — then ``out_tail``
    gives the logical output shape tail.
    """
    din = x.shape[-1]
    if isinstance(w, dict):
        from repro_torch.kernels.ops import quant_matmul
        y = quant_matmul(x, w)
    else:
        n, i = 1, 0
        while n < din and i < w.dim():
            n *= w.shape[i]
            i += 1
        if n != din:
            raise ValueError(f"cannot split {tuple(w.shape)} at din={din}")
        out_tail = out_tail or tuple(w.shape[i:])
        y = x @ w.reshape(din, -1).to(x.dtype)
    if out_tail is not None and len(out_tail) > 1:
        y = y.reshape(*y.shape[:-1], *out_tail)
    return y


# ---------------------------------------------------------------- embedding
def embed_init(gen: torch.Generator, vocab: int, d: int,
               device="cpu") -> torch.Tensor:
    return torch.randn((vocab, d), generator=gen, device=device).mul_(0.02)


def unembed(x: torch.Tensor, embed: torch.Tensor,
            head: Optional[torch.Tensor]) -> torch.Tensor:
    """Logits; the large vocab product stays a plain matmul."""
    if head is not None:
        return x @ head.to(x.dtype)
    return x @ embed.t().to(x.dtype)
