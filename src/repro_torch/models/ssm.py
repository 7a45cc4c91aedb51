"""Attention-free mixers.  The RG-LRU of the hybrid family
(recurrentgemma): init, the plain full-sequence path, the whole-prompt
prefill that returns each sequence's final state, and the one-token
decode over that state.

The JAX package scans time in remat'd chunks so that training can
recompute them; the forward is a plain sequential scan in f32, ``h_t =
a_t * h_{t-1} + g_t``, which is what runs here: the gates of every step
are computed at once, then each time step is one ``addcmul`` into a
preallocated time-major buffer (row t contiguous), so a wave of S tokens
costs S launches per layer and no more.

The Mamba-1 selective scan (falcon-mamba-7b) is the next slice's
(ROADMAP A11); its functions raise here.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import act_fn, dense_init, linear

Params = Dict[str, torch.Tensor]

C_RGLRU = 8.0
CONV = 4             # the RG-LRU's causal depthwise conv width


# ---------------------------------------------------------------- Mamba-1
def _mamba_not_ported(*_args, **_kwargs):
    raise NotImplementedError(
        "the Mamba-1 selective scan (falcon-mamba-7b) is not ported to "
        "repro_torch yet (ROADMAP A11: other model families)")


ssm_init = ssm_apply = ssm_prefill = ssm_decode = _ssm_inner = \
    _mamba_not_ported


# ---------------------------------------------------------------- RG-LRU
def rglru_init(gen: Optional[torch.Generator], cfg: ModelConfig,
               device="cpu") -> Params:
    """The reference's leaves and fan-ins (f32): w_in / w_gate_rec [d, w],
    conv_w [w, 4], the gates' wr / wi [w, w], a_param [w], w_out_rec
    [w, d]."""
    d = cfg.d_model
    w = cfg.lru_width or d
    a = torch.linspace(0.9, 0.999, w, device=device)
    return {
        "w_in": dense_init(gen, (d, w), device=device),
        "w_gate_rec": dense_init(gen, (d, w), device=device),
        "conv_w": dense_init(gen, (w, CONV), device=device) * 0.5,
        "wr": dense_init(gen, (w, w), device=device),
        "wi": dense_init(gen, (w, w), device=device),
        "a_param": torch.log(torch.exp(a * 8.0) - 1.0) / 8.0,
        "w_out_rec": dense_init(gen, (w, d), device=device),
    }


def _conv(u: torch.Tensor, conv_w: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over time of u [B, S, w] (zeros before the
    first token), taps summed in the reference's order in u's dtype."""
    S = u.shape[1]
    up = F.pad(u, (0, 0, CONV - 1, 0))
    cw = conv_w.to(u.dtype)
    uc = up[:, 0:S] * cw[:, 0]
    for i in range(1, CONV):
        uc = uc + up[:, i:i + S] * cw[:, i]
    return uc


def _rglru_scan(p: Params, u: torch.Tensor, h0: torch.Tensor,
                mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u [B, S, w] post-conv input, h0 [B, w] f32.  Returns (h_seq [B, S,
    w] in u's dtype, h_last [B, w] f32).  Where ``mask`` [B, S] is False
    the state passes through unchanged (a = 1, input 0)."""
    r = torch.sigmoid(u @ p["wr"].to(u.dtype)).float()
    i = torch.sigmoid(u @ p["wi"].to(u.dtype)).float()
    log_a = -C_RGLRU * F.softplus(p["a_param"].float())
    a = torch.exp(log_a * r)                                    # [B, S, w]
    gated = (i * u.float()) * torch.sqrt(torch.clamp(1.0 - a * a,
                                                     min=1e-8))
    if mask is not None:
        m = mask[..., None]
        a = torch.where(m, a, 1.0)
        gated = torch.where(m, gated, 0.0)
    a_t = a.transpose(0, 1).contiguous()                        # [S, B, w]
    g_t = gated.transpose(0, 1).contiguous()
    hs = torch.empty_like(a_t)
    h = h0
    for t in range(a_t.shape[0]):
        torch.addcmul(g_t[t], a_t[t], h, out=hs[t])
        h = hs[t]
    return hs.transpose(0, 1).to(u.dtype), h


def rglru_apply(cfg: ModelConfig, p: Params, x: torch.Tensor
                ) -> torch.Tensor:
    """Recurrent block over a whole sequence from a zero state: conv ->
    RG-LRU -> gate -> out.  x [B, S, d] -> [B, S, d]."""
    u = linear(x, p["w_in"])                                    # [B, S, w]
    gate = act_fn("gelu")(linear(x, p["w_gate_rec"]))
    h0 = torch.zeros((x.shape[0], u.shape[-1]), dtype=torch.float32,
                     device=x.device)
    hs, _ = _rglru_scan(p, _conv(u, p["conv_w"]), h0)
    return linear(hs * gate, p["w_out_rec"])


def rglru_prefill(cfg: ModelConfig, p: Params, x: torch.Tensor,
                  mask: torch.Tensor, ctx_lens: torch.Tensor):
    """Whole-prompt prefill of right-padded rows x [B, S, d] (``mask``
    [B, S]: position < ctx_len).  Returns (y [B, S, d], h_final [B, w]
    f32: the state at ctx_len, conv_state [B, w, 3]: the last 3 valid
    inputs, zeros before the first token)."""
    u = linear(x, p["w_in"])
    u = torch.where(mask[..., None], u, torch.zeros_like(u))
    gate = act_fn("gelu")(linear(x, p["w_gate_rec"]))
    h0 = torch.zeros((x.shape[0], u.shape[-1]), dtype=torch.float32,
                     device=x.device)
    hs, h = _rglru_scan(p, _conv(u, p["conv_w"]), h0, mask=mask)
    idx = ctx_lens.long()[:, None] - (CONV - 1) \
        + torch.arange(CONV - 1, device=x.device)[None, :]      # [B, 3]
    gathered = u.gather(1, idx.clamp(min=0)[..., None].expand(
        -1, -1, u.shape[-1]))
    conv_state = torch.where((idx >= 0)[..., None], gathered,
                             torch.zeros_like(gathered)).transpose(1, 2)
    return linear(hs * gate, p["w_out_rec"]), h, conv_state


def rglru_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 h: torch.Tensor, conv_state: torch.Tensor):
    """One step.  x [B, d]; h [B, w] f32; conv_state [B, w, 3].  The conv
    runs in f32 over the state and the new input.  Returns (y [B, d],
    h_new [B, w] f32, the new conv state in conv_state's dtype)."""
    u = linear(x, p["w_in"])                                    # [B, w]
    gate = act_fn("gelu")(linear(x, p["w_gate_rec"]))
    window = torch.cat([conv_state.float(), u.float()[..., None]], -1)
    uc = (window * p["conv_w"].float()).sum(-1).to(x.dtype)
    hs, h_new = _rglru_scan(p, uc[:, None, :], h.float())
    y = linear(hs[:, 0] * gate, p["w_out_rec"])
    return y, h_new, window[..., 1:].to(conv_state.dtype)
