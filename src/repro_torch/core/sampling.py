"""Device-side token sampling: greedy / temperature / top-k / top-p.

Every slot carries its own (temperature, top_k, top_p) and its own random
stream, indexed by the number of tokens it has generated so far — the
stream is a property of the request, not of the engine step or the batch.
A slot's step key is ``fold_in(base_key, count)``, and its Gumbel noise is
``jax.random.categorical``'s, bit for bit: threefry-2x32 is integer
arithmetic, done here in int64 tensors masked to 32 bits on the logits'
device, with JAX's partitionable random-bits layout (the default since
jax 0.5).  Seeded requests therefore give the JAX package's tokens.

The branches that the JAX package takes with ``lax.cond`` on device (any
slot sampling at all; any slot filtering) are decided on the host from
the host's copy of the sampling rows (``sampling_plan``), so a step never
branches on a CUDA tensor.  An all-greedy step skips the noise entirely;
a sampled step costs about a hundred elementwise launches for it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry-2x32 hash (20 rounds) of the count pairs (x1, x2)
    under the key (k1, k2): int64 tensors holding uint32 values, which
    broadcast against each other.  Returns the two uint32 output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = x1 ^ (((x2 << r) & _M32) | (x2 >> (32 - r)))
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def threefry_seed(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` of a Python int, as uint32 [2]: JAX
    (without x64) takes the seed as an int32, so the key is (0, the seed's
    low 32 bits)."""
    if not -2 ** 63 <= int(seed) < 2 ** 63:
        raise OverflowError(f"seed {seed} does not fit in 64 bits")
    return np.array([0, int(seed) & _M32], np.uint32)


def _u32(x, device) -> torch.Tensor:
    """uint32 values (numpy, or a tensor holding the bits in any integer
    dtype) as int64 on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64) & _M32
    return torch.from_numpy(np.asarray(x).astype(np.int64) & _M32).to(device)


def fold_in(keys, data, device="cpu") -> torch.Tensor:
    """``jax.random.fold_in`` row by row: keys [B, 2] uint32, data [B]
    integers -> [B, 2] int64 keys (uint32 values) on ``device``: the hash
    of the count pair (0, data) under each key."""
    keys, data = _u32(keys, device), _u32(data, device)
    return torch.stack(threefry2x32(keys[:, 0], keys[:, 1],
                                    torch.zeros_like(data), data), -1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits per (row, index): [B, n] int64, each row the
    partitionable ``jax.random.bits(key, (n,))`` of its key [B, 2]: count
    pairs (index >> 32, index & 0xFFFFFFFF), the two words xored."""
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    b1, b2 = threefry2x32(keys[:, :1], keys[:, 1:], idx >> 32, idx & _M32)
    return b1 ^ b2


def _unit(bits: torch.Tensor) -> torch.Tensor:
    """f32 uniforms in [tiny, 1) from 32 random bits (int64 holding
    uint32 values): 23 mantissa bits under exponent 0, minus 1, scaled
    and clamped to at least the smallest normal f32."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return (f * (1.0 - _TINY) + _TINY).clamp_min(_TINY)


def uniform(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), minval=tiny, maxval=1.)`` per row,
    f32 [B, n]."""
    return _unit(random_bits(keys, n))


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """JAX's ``"low"``-mode Gumbel noise, ``-log(-log(u))``, f32 [B, n]."""
    return -torch.log(-torch.log(uniform(keys, n)))


def sampling_plan(temps, top_ks, top_ps) -> Tuple[bool, bool]:
    """(any row samples, any sampling row filters), from the host's
    numpy rows: the two branches the JAX package takes on device."""
    temps = np.asarray(temps, np.float32)
    samples = temps > 0
    filters = samples & ((np.asarray(top_ks) > 0)
                         | (np.asarray(top_ps, np.float32) < 1.0))
    return bool(samples.any()), bool(filters.any())


def _filter_top_k_top_p(scaled: torch.Tensor, top_ks: torch.Tensor,
                        top_ps: torch.Tensor) -> torch.Tensor:
    """Mask logits outside each row's top-k / nucleus set to -inf, with
    one descending sort reduced to a per-row value threshold (ties with
    the threshold are all kept) — the JAX package's single-sort filter."""
    V = scaled.shape[-1]
    svals = torch.sort(scaled, dim=-1, descending=True).values
    rank = torch.arange(V, device=scaled.device)[None, :]
    k_eff = torch.where(top_ks <= 0, V, top_ks.clamp(1, V))[:, None]
    in_k = rank < k_eff
    probs = torch.softmax(torch.where(in_k, svals, float("-inf")), dim=-1)
    prior_mass = torch.cumsum(probs, dim=-1) - probs
    keep_sorted = in_k & ((prior_mass < top_ps[:, None])
                          | (top_ps[:, None] >= 1.0))
    thr = svals.masked_fill(~keep_sorted, float("inf")).min(
        dim=-1, keepdim=True).values
    return torch.where(scaled >= thr, scaled, float("-inf"))


def _on(x, device, dtype) -> torch.Tensor:
    """A sampling row on ``device``: staged device tensors pass through;
    numpy rows (tests, one-off callers) are uploaded here."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.from_numpy(np.asarray(x)).to(device=device, dtype=dtype)


def sample_from_logits(logits: torch.Tensor, base_keys, counts, temps,
                       top_ks, top_ps, poison=None, guard: bool = False,
                       plan: Optional[Tuple[bool, bool]] = None
                       ) -> torch.Tensor:
    """Per-slot sampling. Returns [B] int32 token ids on logits.device.

    logits [B, V] on the device; base_keys [B, 2] (uint32 values), counts
    [B], temps [B] (<= 0 greedy), top_ks [B] (<= 0 off), top_ps [B] (>= 1
    off) and the optional fault-injection row bias ``poison`` [B]: tensors
    on the logits' device, or host numpy arrays.  ``plan``: the host's
    ``sampling_plan`` of these rows; computed here when None, which needs
    host rows.  ``guard``: a row whose logits hold a non-finite value
    samples -1 instead of garbage.
    """
    dev = logits.device
    if plan is None:
        plan = sampling_plan(temps, top_ks, top_ps)
    samples, filters = plan
    if poison is not None:
        logits = logits + _on(poison, dev, torch.float32)[:, None]
    tok = logits.argmax(dim=-1)
    if samples:
        t = _on(temps, dev, torch.float32)
        scaled = logits / t.clamp(min=1e-6)[:, None]
        if filters:
            scaled = _filter_top_k_top_p(scaled, _on(top_ks, dev, torch.int64),
                                         _on(top_ps, dev, torch.float32))
        keys = fold_in(base_keys, counts, dev)
        sampled = (gumbel(keys, logits.shape[-1]) + scaled).argmax(dim=-1)
        tok = torch.where(t <= 0, tok, sampled)
    tok = tok.to(torch.int32)
    if guard:
        ok = torch.isfinite(logits.max(dim=-1).values)
        tok = torch.where(ok, tok, -1)
    return tok


def sample_device(logits: torch.Tensor, key, temperatures,
                  top_k: int = 0) -> torch.Tensor:
    """Legacy single-key batch sampler (one shared key, uniform
    ``top_k``), the JAX package's ``sample_device``: [B] int32 token ids
    on the logits' device.

    logits [B, V]; key: one threefry key, uint32 [2] (numpy, or a tensor
    holding the bits); temperatures [B] (<= 0 greedy), a tensor or numpy.
    Its noise is ``jax.random.categorical(key, scaled, axis=-1)``'s: one
    key's partitionable bits over the B x V positions flattened row by
    row (not a key per row, as ``sample_from_logits``), in f32, which
    the scaled logits promote to.  ``top_k`` > 0 masks every scaled logit
    below the row's k-th largest to -inf (ties with it kept).  Kept for
    callers that predate per-slot ``SamplingParams``; new code should
    use ``sample_from_logits``.
    """
    dev = logits.device
    t = _on(temperatures, dev, torch.float32)[:, None]
    greedy = logits.argmax(dim=-1)
    scaled = logits / t.clamp(min=1e-6)
    B, V = scaled.shape
    if top_k > 0:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    k = _u32(key, dev).reshape(1, 2)
    noise = -torch.log(-torch.log(_unit(random_bits(k, B * V))))
    sampled = (noise.reshape(B, V) + scaled).argmax(dim=-1)
    return torch.where(t[:, 0] <= 0.0, greedy, sampled).to(torch.int32)
