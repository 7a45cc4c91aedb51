"""Model-level int4 quantization transforms, in torch on the params'
device.

``quantize_params_rtn`` — round-to-nearest int4 of every matmul weight,
bit-exact with the JAX package's (the RTN baseline).

``gptq_quantize_model`` — the real thing: replays the dense model layer
by layer on calibration tokens, accumulates the Hessians at the inputs of
``wq`` and ``w_gate``, and runs the OBQ loop of ``core/gptq.py``.  The
artifact format is RTN's.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig, QuantConfig
from repro_torch.core.gptq import (HessianAccumulator, QuantizedTensor,
                                   gptq_quantize)
from repro_torch.core.quant import make_quant_params, pack_codes
from repro_torch.models import transformer as T

# the dense decoders' linears; the other families' targets come with them
QUANT_TARGETS = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"}


def require_rtn_family(cfg: ModelConfig) -> None:
    """The reference's RTN int4 of an MoE model loads but cannot serve:
    it packs the shared experts' ws_* into int4 dicts, which its MoE FFN
    then multiplies as dense arrays (ROADMAP C8).  The port serves MoE
    with bf16 weights only, as the reference can."""
    if cfg.num_experts:
        raise ValueError(
            f"rtn-int4 is not served for MoE models ({cfg.name}): the "
            "reference packs the shared experts' ws_gate / ws_up / ws_down "
            "to int4 and its MoE FFN cannot apply them (ROADMAP C8); use "
            "quant=None")


def require_gptq_family(cfg: ModelConfig) -> None:
    """GPTQ takes the dense family only (the reference also takes its vlm
    and audio families, which the port does not serve yet), with the
    reference's message."""
    if cfg.family != "dense":
        raise ValueError(
            f"gptq-int4 supports dense-family models, not "
            f"{cfg.family!r} ({cfg.name}); use quant='rtn-int4'")


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
    g_idx = (torch.arange(K, dtype=torch.int32, device=w2.device) // gs)
    return {"qweight": pack_codes(q.reshape(*lead, K, N)), "scales": scale,
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
    g_idx [.., K] i32}.  Refuses MoE models (ROADMAP C8)."""
    require_rtn_family(cfg)

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


# --------------------------------------------------------------------------
# True GPTQ over calibration data (dense models).
# --------------------------------------------------------------------------

def calibration_hessians(cfg: ModelConfig, params: Dict[str, Any],
                         calib_batches: Sequence[Dict[str, Any]]
                         ) -> List[Tuple[HessianAccumulator,
                                         HessianAccumulator]]:
    """Replay the unquantized layers on ``calib_batches`` (each
    {"tokens": [B, S]}, tensors or numpy arrays) through ``T.apply_layer``,
    the layer body ``T.forward`` runs, and accumulate per layer the Hessians of the attention input
    (``wq``'s) and the MLP input (``w_gate``'s), on the params' device.
    Each layer feeds the next its unquantized output, as in the JAX
    package."""
    T._require_ported(cfg)
    require_gptq_family(cfg)
    dev = params["embed"].device
    hess = [(HessianAccumulator(cfg.d_model, dev),
             HessianAccumulator(cfg.d_model, dev))
            for _ in range(cfg.num_layers)]
    with torch.no_grad():
        for batch in calib_batches:
            x = T._embed_inputs(cfg, params, batch)
            for i, (h_attn, h_mlp) in enumerate(hess):
                acc = {"attn": h_attn, "mlp": h_mlp}
                x = T.apply_layer(cfg, T._layer(params, i), x,
                                  cfg.layer_kind(i),
                                  tap=lambda name, h: acc[name].update(
                                      h.float()))
    return hess


def _gptq_shared(ws: Dict[str, torch.Tensor], hessian: Optional[torch.Tensor],
                 din: int, qcfg: QuantConfig) -> Dict[str, QuantizedTensor]:
    """OBQ of weights that share one input (and so one Hessian) in a
    single loop: concatenated along the output axis, since each output
    column's path depends only on H, the permutation and that column."""
    w2 = {k: w.reshape(din, -1) for k, w in ws.items()}
    qt = gptq_quantize(torch.cat(list(w2.values()), 1), hessian, qcfg)
    out, c0 = {}, 0
    for k, w in w2.items():
        c1 = c0 + w.shape[1]
        out[k] = QuantizedTensor(q=qt.q[:, c0:c1], scales=qt.scales[:, c0:c1],
                                 zeros=qt.zeros[:, c0:c1], g_idx=qt.g_idx,
                                 bits=qt.bits)
        c0 = c1
    return out


def _clock(dev) -> float:
    """Host seconds once the device's queue has drained."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def gptq_quantize_model(cfg: ModelConfig, params: Dict[str, Any],
                        calib_batches: Sequence[Dict[str, Any]],
                        qcfg: Optional[QuantConfig] = None, *,
                        timings: Optional[dict] = None) -> Dict[str, Any]:
    """Hessian-weighted GPTQ of a dense model's linears, on the params'
    device.  ``wq/wk/wv`` share the attention-input Hessian and
    ``w_gate/w_up`` the MLP-input one; ``wo`` and ``w_down`` take the
    identity Hessian (RTN), as in the JAX package.  ``timings``, if
    given, receives the seconds of "calibration" (forward + Hessians),
    "obq" and "pack"."""
    qcfg = qcfg or cfg.quant or QuantConfig()
    dev = params["embed"].device
    t0 = _clock(dev)
    hess = calibration_hessians(cfg, params, calib_batches)
    t1 = _clock(dev)

    d, hd = cfg.d_model, cfg.num_heads * cfg.resolved_head_dim
    qts = []
    for i, (h_attn, h_mlp) in enumerate(hess):
        lp = T._layer(params, i)
        a, m = lp["attn"], lp["mlp"]
        qts.append({
            **_gptq_shared({k: a[k] for k in ("wq", "wk", "wv")}, h_attn.h,
                           d, qcfg),
            **_gptq_shared({"wo": a["wo"]}, None, hd, qcfg),
            **_gptq_shared({k: m[k] for k in ("w_gate", "w_up")}, h_mlp.h,
                           d, qcfg),
            **_gptq_shared({"w_down": m["w_down"]}, None,
                           m["w_down"].shape[0], qcfg)})
    del hess
    t2 = _clock(dev)

    new_layers = []
    for i, q in enumerate(qts):
        lp = T._layer(params, i)
        attn = dict(lp["attn"])
        mlp = dict(lp["mlp"])
        for k, qt in q.items():
            (attn if k in attn else mlp)[k] = make_quant_params(qt)
        new_layers.append({**lp, "attn": attn, "mlp": mlp})
    out = dict(params)
    out["layers"] = T._stack(new_layers)
    if timings is not None:
        timings.update(calibration=t1 - t0, obq=t2 - t1,
                       pack=_clock(dev) - t2)
    return out
