"""Attention-free mixers: the Mamba-1 selective SSM (falcon-mamba-7b)
and the RG-LRU of the hybrid family (recurrentgemma).  For each: init,
the plain full-sequence path, the whole-prompt prefill that returns each
sequence's final state, and the one-token decode over that state.

The JAX package scans time with ``lax.scan`` in remat'd chunks so that
training can recompute them; the forward is a plain sequential scan in
f32, which is what runs here.  The projections and the causal conv (and
the RG-LRU's gates) are computed for the whole wave at once in torch; the
recurrence over time is one call per layer of ``ops.ssm_scan`` (Mamba-1:
softplus, ``h = exp(dt A) h + (dt u) B``, ``y = sum_n h C``, the D skip
and the SiLU gate) or ``ops.linear_scan`` (RG-LRU: ``h = a h + g``): on
the card one launch of the time-scan kernel
(``kernels/csrc/time_scan.cu``), on the CPU the plain versions of
``kernels/ref.py``.  The roofline dry run's ``skip_mixer_core`` branch of
the reference is not ported (ROADMAP A13).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import act_fn, dense_init, linear

Params = Dict[str, torch.Tensor]

C_RGLRU = 8.0
CONV = 4             # the RG-LRU's causal depthwise conv width


def _conv(u: torch.Tensor, conv_w: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over time of u [B, S, w] with taps conv_w [w,
    W] (zeros before the first token), taps summed in the reference's
    order in u's dtype."""
    S, W = u.shape[1], conv_w.shape[-1]
    up = F.pad(u, (0, 0, W - 1, 0))
    cw = conv_w.to(u.dtype)
    uc = up[:, 0:S] * cw[:, 0]
    for i in range(1, W):
        uc = uc + up[:, i:i + S] * cw[:, i]
    return uc


def _conv_state(u: torch.Tensor, ctx_lens: torch.Tensor, k: int
                ) -> torch.Tensor:
    """The conv state after a right-padded prompt: each row's last ``k``
    valid inputs of u [B, S, w] (zeros before the first token), as [B, w,
    k]."""
    idx = ctx_lens.long()[:, None] - k \
        + torch.arange(k, device=u.device)[None, :]              # [B, k]
    gathered = u.gather(1, idx.clamp(min=0)[..., None].expand(
        -1, -1, u.shape[-1]))
    return torch.where((idx >= 0)[..., None], gathered,
                       torch.zeros_like(gathered)).transpose(1, 2)


# ---------------------------------------------------------------- Mamba-1
def dt_rank(cfg: ModelConfig) -> int:
    return (cfg.d_model + cfg.ssm_state - 1) // cfg.ssm_state


def ssm_init(gen: Optional[torch.Generator], cfg: ModelConfig,
             device="cpu") -> Params:
    """The reference's leaves and fan-ins (f32): in_proj [d, 2 din],
    conv_w [din, W], conv_b [din], x_proj [din, R + 2N], dt_proj [R, din],
    dt_bias [din] (softplus^-1 of a dt drawn log-uniform in [0.001, 0.1]),
    A_log [din, N] (log 1..N), D [din], out_proj [din, d]."""
    d = cfg.d_model
    din = cfg.ssm_expand * d
    N = cfg.ssm_state
    R = dt_rank(cfg)
    p = {"in_proj": dense_init(gen, (d, 2 * din), device=device),
         "conv_w": dense_init(gen, (din, cfg.ssm_conv), device=device) * 0.5,
         "conv_b": torch.zeros(din, device=device),
         "x_proj": dense_init(gen, (din, R + 2 * N), device=device),
         "dt_proj": dense_init(gen, (R, din), device=device)}
    r = torch.rand(din, generator=gen, device=device)
    lo, hi = math.log(0.001), math.log(0.1)
    p["dt_bias"] = torch.log(torch.expm1(torch.exp(r * (hi - lo) + lo)))
    p["A_log"] = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                        device=device)).repeat(din, 1)
    p["D"] = torch.ones(din, device=device)
    p["out_proj"] = dense_init(gen, (din, d), in_axis_size=din,
                               device=device)
    return p


def _ssm_inner(cfg: ModelConfig, p: Params, xc: torch.Tensor,
               z: torch.Tensor, h0: torch.Tensor,
               mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective scan of xc [B, S, din] (post-conv) from h0 [B, din, N]
    f32, gated by z.  Returns (y [B, S, din] in xc's dtype, h_last).
    Where ``mask`` [B, S] is False, dt = 0: the state passes through.
    After the two projections everything is one ``ops.ssm_scan`` (on the
    card one kernel launch: softplus, the scan, the D skip and the gate;
    B, C and z read in place)."""
    R, N = dt_rank(cfg), cfg.ssm_state
    dbc = xc @ p["x_proj"].to(xc.dtype)
    dt_r, b_ssm, c_ssm = dbc.split([R, N, N], dim=-1)
    dt_lin = dt_r @ p["dt_proj"].to(xc.dtype)                   # [B, S, din]
    return ops.ssm_scan(dt_lin, p["dt_bias"], xc, b_ssm, c_ssm, z,
                        p["A_log"], p["D"], h0, mask)


def _in_proj(cfg: ModelConfig, p: Params, x: torch.Tensor):
    xz = linear(x, p["in_proj"])
    din = cfg.ssm_expand * cfg.d_model
    return xz[..., :din], xz[..., din:]


def ssm_apply(cfg: ModelConfig, p: Params, x: torch.Tensor
              ) -> torch.Tensor:
    """The mixer over a whole sequence from a zero state: in_proj ->
    causal conv -> SiLU -> selective scan -> gate -> out_proj.  x [B, S,
    d] -> [B, S, d]."""
    xi, z = _in_proj(cfg, p, x)
    xc = act_fn("silu")(_conv(xi, p["conv_w"]) + p["conv_b"].to(x.dtype))
    h0 = torch.zeros((x.shape[0], xi.shape[-1], cfg.ssm_state),
                     dtype=torch.float32, device=x.device)
    y, _ = _ssm_inner(cfg, p, xc, z, h0)
    return linear(y, p["out_proj"])


def ssm_prefill(cfg: ModelConfig, p: Params, x: torch.Tensor,
                mask: torch.Tensor, ctx_lens: torch.Tensor):
    """Whole-prompt prefill of right-padded rows x [B, S, d] (``mask``
    [B, S]: position < ctx_len).  Padded positions are state-transparent
    (zero input, dt = 0).  Returns (y [B, S, d], h_final [B, din, N] f32:
    the state at ctx_len, conv_state [B, din, W-1]: the last W-1 valid
    inputs, zeros before the first token)."""
    xi, z = _in_proj(cfg, p, x)
    m = mask[..., None]
    xi = torch.where(m, xi, torch.zeros_like(xi))
    xc = act_fn("silu")(_conv(xi, p["conv_w"]) + p["conv_b"].to(x.dtype))
    xc = torch.where(m, xc, torch.zeros_like(xc))
    h0 = torch.zeros((x.shape[0], xi.shape[-1], cfg.ssm_state),
                     dtype=torch.float32, device=x.device)
    y, h = _ssm_inner(cfg, p, xc, z, h0, mask=mask)
    conv_state = _conv_state(xi, ctx_lens, cfg.ssm_conv - 1)
    return linear(y, p["out_proj"]), h, conv_state


def ssm_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
               h: torch.Tensor, conv_state: torch.Tensor):
    """One step.  x [B, d]; h [B, din, N] f32; conv_state [B, din, W-1].
    The conv runs in f32 over the state and the new input.  Returns (y
    [B, d], h_new [B, din, N] f32, the new conv state in conv_state's
    dtype)."""
    xi, z = _in_proj(cfg, p, x)                                 # [B, din]
    window = torch.cat([conv_state.float(), xi.float()[..., None]], -1)
    xc = (window * p["conv_w"].float()).sum(-1)
    xc = act_fn("silu")(xc + p["conv_b"].float()).to(x.dtype)
    y3, h_new = _ssm_inner(cfg, p, xc[:, None], z[:, None], h)
    y = linear(y3[:, 0], p["out_proj"])
    return y, h_new, window[..., 1:].to(conv_state.dtype)


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
    hs, h = ops.linear_scan(a.contiguous(), gated.contiguous(),
                            h0.contiguous())
    return hs.to(u.dtype), h


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
    conv_state = _conv_state(u, ctx_lens, CONV - 1)
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
