"""The train step: the JAX package's ``runtime/train_loop.py`` on one
device.  ``make_train_step`` differentiates ``transformer.loss_fn`` (each
layer rematerialised: ``transformer.forward``), sums the f32 gradients of
its microbatches in order and divides them, as the reference's scan does,
and applies AdamW in place.  It runs eagerly: torch has no ``jit``.  It
trains every ported family: the dense, sliding-window, vision-prefixed and
audio models, the MoE decoder (qwen2-moe), the RG-LRU hybrid
(recurrentgemma) and the Mamba-1 stack (falcon-mamba); on the card the
time scans' backward runs their reverse-time kernels.

Sharded steps (``ctx``, the shardings of ``jit_train_step``) and the int8
error-feedback gradient compression (``make_compressed_grad_fn``,
``init_error_buffer``) need a data-parallel mesh: refused by name until
the port's parallelism (ROADMAP A13).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import (AdamWConfig, OptState, apply_updates,
                                     tree_leaves, tree_map)


def _refuse_mesh(what: str) -> None:
    raise NotImplementedError(
        f"{what} needs a device mesh, which the port does not have yet "
        "(ROADMAP A13: parallelism); the port trains on one device")


def _split(batch: Dict[str, Any], n: int, device) -> list:
    """The batch's tensors on ``device``, cut into ``n`` microbatches along
    the batch axis (rows i * B / n .. (i + 1) * B / n, the reference's
    reshape)."""
    out = [dict() for _ in range(n)]
    for k, v in batch.items():
        v = torch.as_tensor(v).to(device)
        if v.shape[0] % n:
            raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows, not a "
                             f"multiple of {n} microbatches")
        for i, part in enumerate(v.reshape(n, v.shape[0] // n,
                                           *v.shape[1:])):
            out[i][k] = part
    return out


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, ctx=None,
                    num_microbatches: int = 1) -> Callable:
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; metrics are 0-d device tensors ``loss``, ``grad_norm`` and
    ``lr``.  ``params`` (f32 master weights) and the moments are in the
    trainer's layout, each layer stack a list of independent per-layer
    leaves (``T.unstack_layers``), and are updated in place.  Every
    ported family is trained (``T.require_trainable``)."""
    if ctx is not None:
        _refuse_mesh("make_train_step(ctx=...)")
    T.require_trainable(cfg)
    n = int(num_microbatches)

    def step(params, opt_state: OptState, batch):
        for name in T.STACKS:
            if name in params and not isinstance(params[name], list):
                raise ValueError(
                    f"params[{name!r}] is a stacked tensor tree: the "
                    "trainer takes T.unstack_layers(params), one leaf per "
                    "layer (a row of a stacked leaf would get a gradient "
                    "of the whole stack's size)")
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, grads = None, None
        for mb in _split(batch, n, leaves[0].device):
            with torch.enable_grad():
                l = T.loss_fn(cfg, params, mb)
                g = torch.autograd.grad(l, leaves, allow_unused=True)
            # a leaf the loss never reads (an encoder's untied embedding)
            # gets zeros, as jax.grad gives
            g = [torch.zeros_like(p) if d is None else d
                 for p, d in zip(leaves, g)]
            if grads is None:        # 0 + g, the reference's first add
                loss, grads = l.detach(), list(g)
            else:
                loss = loss + l.detach()
                for a, b in zip(grads, g):
                    a.add_(b)
            del l, g
        if n > 1:
            loss = loss / n
            for a in grads:
                a.div_(n)
        it = iter(grads)                 # in tree_leaves order
        params, opt_state, m = apply_updates(
            params, tree_map(lambda _: next(it), params), opt_state, opt_cfg)
        return params, opt_state, {"loss": loss, **m}

    return step


def jit_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, ctx,
                   params_tmpl: Any = None, num_microbatches: int = 1):
    """Without a mesh (``ctx=None``) the eager ``make_train_step``; sharded
    steps are refused (A13)."""
    if ctx is not None:
        _refuse_mesh("jit_train_step's shardings")
    return make_train_step(cfg, opt_cfg, None, num_microbatches)


def make_compressed_grad_fn(cfg: ModelConfig, ctx, rt: Optional[dict] = None):
    """The int8 error-feedback compressed gradient reduction exchanges
    int8 chunks across the data-parallel axis: refused (A13)."""
    _refuse_mesh("the int8 error-feedback gradient compression")


def init_error_buffer(ctx, params) -> torch.Tensor:
    _refuse_mesh("the int8 error-feedback buffer")
