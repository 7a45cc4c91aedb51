"""AdamW and its learning-rate schedule, the JAX package's
``optim/adamw.py`` in torch: the same config, state and arithmetic in
f32 (global-norm clipping, bias correction ``1 - b ** step`` in f32,
``u = mh / (sqrt(vh) + eps) + wd * p``), with moments of
``moment_dtype``.

Where the reference returns new trees, ``apply_updates`` writes the new
params and moments into the tensors it is given (under ``no_grad``), so a
step of a 1.5 B-parameter model does not hold two copies of them; the
temporaries are one leaf's.  Not ``torch.optim.AdamW``: it decays the
weights before the moment update and adds ``eps`` elsewhere.

Trees are nested dicts and lists of tensors (the trainer's layer stacks
are lists of per-layer dicts: ``transformer.unstack_layers``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    moment_dtype: str = "float32"      # "bfloat16" halves the moments


class OptState(NamedTuple):
    """Field names as the reference's, so checkpoint files are named
    alike (``opt.step``, ``opt.mu.<path>``, ``opt.nu.<path>``)."""
    step: torch.Tensor                 # 0-d int32: updates taken so far
    mu: Any
    nu: Any


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of nested dicts and lists, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the same leaves of ``rest``,
    keeping dicts, lists and NamedTuples (``OptState``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def init_opt_state(params: Any, cfg: AdamWConfig) -> OptState:
    dt = getattr(torch, cfg.moment_dtype)
    leaves = tree_leaves(params)
    z = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return OptState(step=torch.zeros((), dtype=torch.int32,
                                     device=leaves[0].device),
                    mu=tree_map(z, params), nu=tree_map(z, params))


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr`` over ``warmup_steps``, then cosine down to
    ``min_lr_frac * lr`` at ``total_steps``; f32, on ``step``'s device."""
    warm = cfg.lr * torch.clamp((step + 1) / cfg.warmup_steps, max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 \
        * (1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32 (0-d)."""
    norms = [torch.linalg.vector_norm(x, dtype=torch.float32)
             for x in tree_leaves(tree)]
    return torch.stack(norms).square().sum().sqrt()


@torch.no_grad()
def apply_updates(params: Any, grads: Any, st: OptState, cfg: AdamWConfig
                  ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place: each leaf of ``params`` and of the
    moments ``st.mu`` / ``st.nu`` is overwritten.  Returns (params, the
    state with ``step + 1``, {"grad_norm", "lr"} as 0-d device tensors):
    nothing is read back to the host."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    step = st.step + 1
    lr = lr_at(cfg, st.step)
    bc1 = 1 - cfg.b1 ** step.float()
    bc2 = 1 - cfg.b2 ** step.float()
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(st.mu), tree_leaves(st.nu)):
        g32 = g.float() * scale
        # .float() of an f32 moment is the moment itself: updated in place
        m32 = m.float().mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
        v32 = v.float().mul_(cfg.b2).add_((g32 * (1 - cfg.b2)).mul_(g32))
        for dst, src in ((m, m32), (v, v32)):
            if dst is not src:
                dst.copy_(src)
        u = (m32 / bc1).div_((v32 / bc2).sqrt_().add_(cfg.eps))
        u.add_(p.float() * cfg.weight_decay).mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(u)
        else:
            p.copy_(p.float() - u)
    return params, OptState(step, st.mu, st.nu), {"grad_norm": gnorm,
                                                  "lr": lr}
