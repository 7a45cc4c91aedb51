"""Device-side token sampling: greedy / temperature / top-k / top-p.

Every slot carries its own (temperature, top_k, top_p) and its own random
stream, indexed by the number of tokens it has generated so far — the
stream is a property of the request, not of the engine step or the batch.

The sampling parameters arrive as the host's numpy arrays: the branches
that the JAX package takes with ``lax.cond`` on device (any slot sampling
at all; any slot filtering) are decided here on the host before anything
is uploaded, so a step never branches on a CUDA tensor.

JAX's threefry bits cannot be reproduced, so the port draws its Gumbel
noise from a counter-based integer hash of (slot key, count, vocab
index).  Greedy decoding is the parity contract with the JAX package;
seeded sampling is deterministic within the port (ROADMAP A9).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_GOLDEN = 0x9E3779B97F4A7C15
_C1 = 0xBF58476D1CE4E5B9
_C2 = 0x94D049BB133111EB


def _s64(c: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _srl(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def _mix(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer on int64 tensors (wrapping arithmetic)."""
    x = x ^ _srl(x, 30)
    x = x * _s64(_C1)
    x = x ^ _srl(x, 27)
    x = x * _s64(_C2)
    return x ^ _srl(x, 31)


def _uniform(keys: np.ndarray, counts: np.ndarray, V: int,
             device) -> torch.Tensor:
    """[B, V] uniforms in (0, 1), a pure function of each row's
    (key, count) and the vocab index."""
    k = np.asarray(keys, np.uint32).astype(np.uint64)
    row = (k[:, 0] << np.uint64(32)) | k[:, 1]
    seed = torch.from_numpy(row.view(np.int64).copy()).to(device)
    cnt = torch.from_numpy(np.asarray(counts, np.int64).copy()).to(device)
    seed = _mix(seed ^ _mix(cnt + _s64(_GOLDEN)))
    idx = torch.arange(1, V + 1, dtype=torch.int64, device=device)
    h = _mix(seed[:, None] + idx[None, :] * _s64(_GOLDEN))
    return (_srl(h, 40).float() + 0.5) * (1.0 / (1 << 24))


def _filter_top_k_top_p(scaled: torch.Tensor, top_ks: torch.Tensor,
                        top_ps: torch.Tensor) -> torch.Tensor:
    """Mask logits outside each row's top-k / nucleus set to -inf, with
    one descending sort reduced to a per-row value threshold (ties with
    the threshold are all kept) — the JAX package's single-sort filter."""
    V = scaled.shape[-1]
    svals = torch.sort(scaled, dim=-1, descending=True).values
    rank = torch.arange(V, device=scaled.device)[None, :]
    k_eff = torch.where(top_ks <= 0, torch.full_like(top_ks, V),
                        top_ks.clamp(1, V))[:, None]
    in_k = rank < k_eff
    neg = torch.tensor(float("-inf"), device=scaled.device)
    probs = torch.softmax(torch.where(in_k, svals, neg), dim=-1)
    prior_mass = torch.cumsum(probs, dim=-1) - probs
    keep_sorted = in_k & ((prior_mass < top_ps[:, None])
                          | (top_ps[:, None] >= 1.0))
    thr = torch.where(keep_sorted, svals,
                      torch.tensor(float("inf"), device=scaled.device)
                      ).min(dim=-1, keepdim=True).values
    return torch.where(scaled >= thr, scaled, neg)


def sample_from_logits(logits: torch.Tensor, base_keys: np.ndarray,
                       counts: np.ndarray, temps: np.ndarray,
                       top_ks: np.ndarray, top_ps: np.ndarray,
                       poison: Optional[np.ndarray] = None,
                       guard: bool = False) -> torch.Tensor:
    """Per-slot sampling. Returns [B] int32 token ids on logits.device.

    logits [B, V] on the device; base_keys [B, 2] uint32, counts [B],
    temps [B] (<= 0 greedy), top_ks [B] (<= 0 off), top_ps [B] (>= 1 off)
    and the optional fault-injection row bias ``poison`` [B] are host
    numpy arrays.  ``guard``: a row whose logits hold a non-finite value
    samples -1 instead of garbage.
    """
    dev = logits.device
    if poison is not None:
        logits = logits + torch.from_numpy(
            np.asarray(poison, np.float32)).to(dev)[:, None]
    tok = logits.argmax(dim=-1)
    temps = np.asarray(temps, np.float32)
    if (temps > 0).any():
        t = torch.from_numpy(temps).to(dev)
        scaled = logits / t.clamp(min=1e-6)[:, None]
        top_ks = np.asarray(top_ks, np.int64)
        top_ps = np.asarray(top_ps, np.float32)
        if ((temps > 0) & ((top_ks > 0) | (top_ps < 1.0))).any():
            scaled = _filter_top_k_top_p(
                scaled, torch.from_numpy(top_ks).to(dev),
                torch.from_numpy(top_ps).to(dev))
        u = _uniform(base_keys, counts, logits.shape[-1], dev)
        sampled = (scaled - torch.log(-torch.log(u))).argmax(dim=-1)
        tok = torch.where(t <= 0, tok, sampled)
    tok = tok.to(torch.int32)
    if guard:
        ok = torch.isfinite(logits.max(dim=-1).values)
        tok = torch.where(ok, tok, torch.full_like(tok, -1))
    return tok
