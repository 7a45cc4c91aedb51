"""Mixture-of-Experts FFN (the counterpart of the JAX package's
``models/moe.py``), single device.

Routing as in the reference: the router product in the activation dtype,
an f32 softmax and top-k with the weights renormalized, a stable sort of
the ``T·k`` (token, expert) assignments by expert, capacity ``T·k``
(nothing dropped), and the three routed products as grouped matmuls over
the sorted rows (``torch._grouped_mm``; the reference's
``jax.lax.ragged_dot`` is XLA, not a Pallas kernel).  Shared experts are
one wide SwiGLU MLP.  Experts are padded to a multiple of the EP axis;
the router only ever produces logits for real experts.

Two things differ from the reference by design, neither in the result:

- Nothing on the path reads a device value back to the host (the async
  engine must make no pageable copy): group sizes are counted into a
  fixed ``[E_pad]`` buffer on the device and handed to the grouped matmul
  as device offsets.
- The combine is a gather through the inverse permutation into
  ``[T, k, d]`` and a sum over ``k`` in a fixed order, not a scatter-add
  (``index_add_`` on the card adds with atomics, in an order that changes
  from run to run), so a run repeats bit for bit.

The reference's expert-parallel branch (``ctx`` / ``shard_map``, a psum
over the model axis) waits for the port's parallelism (ROADMAP A13).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import act_fn, dense_init

Params = Dict[str, torch.Tensor]


def padded_experts(cfg: ModelConfig, ep: int = 1) -> int:
    e = cfg.num_experts
    return ((e + ep - 1) // ep) * ep


def moe_init(gen: torch.Generator, cfg: ModelConfig, device="cpu",
             ep: int = 1) -> Params:
    """router [d, E], we_gate / we_up [E_pad, d, f], we_down [E_pad, f, d]
    and, with shared experts, ws_gate / ws_up [d, S·f], ws_down [S·f, d]
    (f32, the reference's shapes and fan-ins)."""
    d, f = cfg.d_model, cfg.moe_d_ff
    e_pad = padded_experts(cfg, ep)
    fs = cfg.num_shared_experts * cfg.moe_d_ff
    p = {"router": dense_init(gen, (d, cfg.num_experts), device=device),
         "we_gate": dense_init(gen, (e_pad, d, f), d, device),
         "we_up": dense_init(gen, (e_pad, d, f), d, device),
         "we_down": dense_init(gen, (e_pad, f, d), f, device)}
    if fs:
        p.update(ws_gate=dense_init(gen, (d, fs), device=device),
                 ws_up=dense_init(gen, (d, fs), device=device),
                 ws_down=dense_init(gen, (fs, d), fs, device))
    return p


def _route(cfg: ModelConfig, p: Params, x2: torch.Tensor):
    """Top-k expert ids [T, k] and renormalized f32 weights [T, k]."""
    logits = (x2 @ p["router"].to(x2.dtype)).float()              # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_ids = torch.topk(probs, cfg.moe_top_k, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)
    return top_ids, top_w


def grouped_mm(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor
               ) -> torch.Tensor:
    """Rows ``offs[e-1]:offs[e]`` of x [M, K] times w[e] [K, N]; offs [E]
    int32 cumulative group ends, on the device."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        raise RuntimeError(f"torch {torch.__version__} has no _grouped_mm: "
                           "the routed experts need it")
    return fn(x, w, offs=offs)


def _routed_local(cfg: ModelConfig, p: Params, x2: torch.Tensor
                  ) -> torch.Tensor:
    """The routed experts' contribution for tokens x2 [T, d] -> [T, d]."""
    T, d = x2.shape
    k = cfg.moe_top_k
    e_pad = p["we_gate"].shape[0]
    top_ids, top_w = _route(cfg, p, x2)
    ids = top_ids.reshape(-1)                                      # [T*k]
    w = top_w.reshape(-1).to(x2.dtype)
    order = torch.argsort(ids, stable=True)         # jnp.argsort is stable
    sizes = torch.zeros(e_pad, dtype=torch.int32, device=x2.device) \
        .scatter_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    xs = x2.index_select(0, order // k)                            # [T*k, d]
    g = grouped_mm(xs, p["we_gate"].to(x2.dtype), offs)
    u = grouped_mm(xs, p["we_up"].to(x2.dtype), offs)
    rows = grouped_mm(act_fn(cfg.act)(g) * u, p["we_down"].to(x2.dtype), offs)
    rows = rows * w.index_select(0, order)[:, None]
    # undo the sort: sorted row j holds assignment order[j]
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=order.device))
    yk = rows.index_select(0, inv).reshape(T, k, d)
    y = yk[:, 0]
    for j in range(1, k):
        y = y + yk[:, j]
    return y


def _shared_local(cfg: ModelConfig, p: Params, x2: torch.Tensor
                  ) -> torch.Tensor:
    g = x2 @ p["ws_gate"].to(x2.dtype)
    u = x2 @ p["ws_up"].to(x2.dtype)
    return (act_fn(cfg.act)(g) * u) @ p["ws_down"].to(x2.dtype)


def moe_apply(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """x: [B, S, d] -> [B, S, d]."""
    B, S, d = x.shape
    x2 = x.reshape(-1, d)
    y = _routed_local(cfg, p, x2)
    if "ws_gate" in p:
        y = y + _shared_local(cfg, p, x2)
    return y.reshape(B, S, d)


def moe_apply_dense_ref(cfg: ModelConfig, p: Params, x: torch.Tensor
                        ) -> torch.Tensor:
    """The plain version: every expert on every token, O(E) products,
    weighted by the routing (for tests and the card check only)."""
    B, S, d = x.shape
    x2 = x.reshape(-1, d)
    top_ids, top_w = _route(cfg, p, x2)
    y = torch.zeros_like(x2)
    for e in range(cfg.num_experts):
        g = x2 @ p["we_gate"][e].to(x2.dtype)
        u = x2 @ p["we_up"][e].to(x2.dtype)
        o = (act_fn(cfg.act)(g) * u) @ p["we_down"][e].to(x2.dtype)
        w_e = torch.where(top_ids == e, top_w, 0.0).sum(-1).to(x2.dtype)
        y = y + o * w_e[:, None]
    if "ws_gate" in p:
        y = y + _shared_local(cfg, p, x2)
    return y.reshape(B, S, d)
