"""Dynamic grouping (paper §II.B 'Dynamic Grouping Optimization'), the
port's copy of the JAX package's ``core/grouping.py``.

Assigns query heads to KV groups by *activation similarity*: cosine
similarity between per-head activation statistics, maximizing intra-group
similarity / minimizing inter-group similarity. Converts one MHA layer
(kv == H, e.g. qwen1.5-0.5b) into an Opt-GQA layer:

  1. collect per-head key activations over calibration tokens,
  2. cluster heads into ``num_groups`` by cosine similarity (greedy
     agglomerative — deterministic, dependency-free),
  3. permute Q heads so each group is contiguous (groups must be contiguous
     for the kernels' reshape-based sharing),
  4. merge each group's K/V projections (mean, optionally weighted by head
     norm — the 'weighted GQA' variant the paper cites).

The per-head statistics and the merge run in torch on the activations' and
weights' device; the [H, H] similarity and the clustering are host numpy
(H is at most a few dozen).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch


def head_similarity(acts: torch.Tensor) -> np.ndarray:
    """Cosine-similarity matrix between heads.

    acts: [H, N, D] per-head activations over N calibration tokens.
    Uses the mean activation direction per head (paper: cosine similarity of
    query heads / norm similarity of output activations).
    """
    m = acts.mean(dim=1).cpu().numpy().astype(np.float64)          # [H, D]
    n = np.linalg.norm(m, axis=1, keepdims=True)
    m = m / np.maximum(n, 1e-12)
    return m @ m.T


def cluster_heads(sim: np.ndarray, num_groups: int,
                  group_size: Optional[int] = None) -> List[List[int]]:
    """Greedy agglomerative clustering into equal-size groups.

    Equal group size is required so that the grouped reshape
    [H] -> [KV, q_per_kv] stays rectangular (kernel constraint).
    """
    H = sim.shape[0]
    gs = group_size or H // num_groups
    if num_groups * gs != H:
        raise ValueError(f"{H} heads do not split into {num_groups} groups "
                         f"of {gs}")
    unassigned = set(range(H))
    groups: List[List[int]] = []
    for _ in range(num_groups):
        # seed: the unassigned head least similar to already-grouped heads
        # (spreads groups apart -> minimizes inter-group similarity).
        if groups:
            placed = [h for g in groups for h in g]
            seed = min(unassigned, key=lambda h: sim[h, placed].max())
        else:
            seed = min(unassigned)
        g = [seed]
        unassigned.discard(seed)
        while len(g) < gs:
            # grow by max average similarity to the group (intra-group max).
            nxt = max(unassigned, key=lambda h: sim[h, g].mean())
            g.append(nxt)
            unassigned.discard(nxt)
        groups.append(sorted(g))
    return groups


def grouping_quality(sim: np.ndarray, groups: List[List[int]]
                     ) -> Tuple[float, float]:
    """(intra-group mean similarity, inter-group mean similarity)."""
    H = sim.shape[0]
    intra, inter, ni, no = 0.0, 0.0, 0, 0
    gid = np.empty(H, dtype=int)
    for i, g in enumerate(groups):
        for h in g:
            gid[h] = i
    for a in range(H):
        for b in range(a + 1, H):
            if gid[a] == gid[b]:
                intra += sim[a, b]
                ni += 1
            else:
                inter += sim[a, b]
                no += 1
    return intra / max(ni, 1), inter / max(no, 1)


@dataclass
class GQAConversion:
    """Result of converting MHA weights to Opt-GQA."""
    q_perm: np.ndarray            # [H] permutation applied to query heads
    groups: List[List[int]]       # head ids per group (pre-permutation)
    wk: torch.Tensor              # merged [d_model, KV, D]
    wv: torch.Tensor
    intra_sim: float
    inter_sim: float


def convert_mha_to_gqa(
    wq: torch.Tensor,             # [d_model, H, D]
    wk: torch.Tensor,             # [d_model, H, D]
    wv: torch.Tensor,             # [d_model, H, D]
    key_acts: torch.Tensor,       # [H, N, D] calibration key activations
    num_kv_heads: int,
    weighted: bool = True,
) -> GQAConversion:
    """MHA -> Opt-GQA: cluster by activation similarity, merge K/V per group.

    ``weighted=True`` uses per-head activation norms as merge weights (the
    'weighted GQA' variant [11]); False is plain mean-pooling.
    """
    H = wq.shape[1]
    sim = head_similarity(key_acts)
    groups = cluster_heads(sim, num_kv_heads)
    intra, inter = grouping_quality(sim, groups)

    if weighted:
        w = torch.linalg.vector_norm(key_acts.reshape(H, -1).float(),
                                     dim=1).cpu().numpy()
    else:
        w = np.ones(H)

    merged_k, merged_v, perm = [], [], []
    for g in groups:
        gw = torch.as_tensor(w[g] / w[g].sum(), dtype=wk.dtype,
                             device=wk.device)
        merged_k.append(torch.einsum("h,dhx->dx", gw, wk[:, g]))
        merged_v.append(torch.einsum("h,dhx->dx", gw, wv[:, g]))
        perm.extend(g)
    return GQAConversion(
        q_perm=np.asarray(perm),
        groups=groups,
        wk=torch.stack(merged_k, dim=1),
        wv=torch.stack(merged_v, dim=1),
        intra_sim=float(intra),
        inter_sim=float(inter),
    )
