"""Opt-GQA dynamic grouping demo on the port (paper §II.B), the
counterpart of ``examples/convert_mha_to_gqa.py``: convert an MHA
checkpoint (kv == heads) to grouped-query attention by
activation-similarity clustering, and measure the quality of the
grouping.  Beyond the JAX example, it runs layer 0's attention over the
calibration tokens with the MHA heads and with the merged GQA heads
(causal, the static ``flash_attention``) and prints how far apart they
are.

    PYTHONPATH=src python examples/repro_torch/convert_mha_to_gqa.py        # card
    PYTHONPATH=src python examples/repro_torch/convert_mha_to_gqa.py --device cpu

On the card (``--device cuda``, the default; raises on a host without
one) the checkpoint is qwen2-1.5b at full width cut to 4 layers, its 12
query heads given 12 KV heads and converted to its 2 (head dim 128; the
reduced config's head dim 16 is not one the bf16 tensor-core kernels are
built for).  On the CPU (the plain path) it is the JAX example's own:
reduced qwen1.5-0.5b with 8 heads converted to 4 KV heads, 2 layers.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config, get_reduced
from repro_torch.core.grouping import convert_mha_to_gqa
from repro_torch.kernels import ops
from repro_torch.models import transformer as T


def gqa_config(card: bool):
    """The converted model's config (the MHA one has kv == heads)."""
    return get_config("qwen2-1.5b").replace(num_layers=4) if card \
        else get_reduced("qwen1.5-0.5b", num_layers=2, num_kv_heads=4,
                         num_heads=8)


def run(device="cuda", params=None, tokens=None) -> dict:
    """Convert layer 0 on ``device``.  ``params``: the MHA model's
    (seeded ``T.init_params`` when None); ``tokens``: calibration tokens
    [4, 64] (seeded numpy when None).  Returns the groups, the similarity
    of heads inside and across groups, the merged shapes and the
    attention's relative difference after the merge."""
    dev = resolve_device(device)
    cfg = gqa_config(dev.type == "cuda")
    # an "MHA checkpoint": kv == heads
    mha_cfg = cfg.replace(num_kv_heads=cfg.num_heads)
    if params is None:
        params = T.init_params(mha_cfg, 0, dev)
    if tokens is None:
        tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 64))
    tokens = torch.as_tensor(np.asarray(tokens), device=dev).long()

    # calibration: collect key activations per head from layer 0
    lp = T._layer(params, 0)["attn"]
    x = params["embed"][tokens].float()
    H, Dh = mha_cfg.num_heads, mha_cfg.resolved_head_dim
    k_acts = torch.einsum("bsd,dhk->hbsk", x,
                          lp["wk"].float()).reshape(H, -1, Dh)

    conv = convert_mha_to_gqa(lp["wq"], lp["wk"], lp["wv"], k_acts,
                              num_kv_heads=cfg.num_kv_heads)
    print(f"groups (by activation similarity): {conv.groups}")
    print(f"intra-group sim {conv.intra_sim:.3f} vs inter-group "
          f"{conv.inter_sim:.3f}")
    print(f"merged K/V shapes: {tuple(conv.wk.shape)} {tuple(conv.wv.shape)}"
          f" (was {tuple(lp['wk'].shape)})")
    kv_share = cfg.num_kv_heads / mha_cfg.num_heads
    print(f"KV cache memory after conversion: {kv_share:.0%} of MHA")

    # layer 0's attention (no RoPE, no bias: the projections alone) with
    # the query heads in group order, over all heads and over the merged
    act = T.act_dtype(cfg)
    perm = torch.as_tensor(conv.q_perm, device=dev)
    q = torch.einsum("bsd,dhk->bshk", x, lp["wq"].float()[:, perm])

    def attend(wk, wv):
        k = torch.einsum("bsd,dhk->bshk", x, wk.float())
        v = torch.einsum("bsd,dhk->bshk", x, wv.float())
        with torch.no_grad():
            return ops.flash_attention(q.to(act), k.to(act),
                                       v.to(act)).float()
    mha = attend(lp["wk"][:, perm], lp["wv"][:, perm])
    gqa = attend(conv.wk, conv.wv)
    rel = ((gqa - mha).norm() / mha.norm()).item()
    print(f"layer-0 attention, merged GQA against MHA: relative "
          f"difference {rel:.4f}")
    return {"config": cfg.name, "heads": H, "kv_heads": cfg.num_kv_heads,
            "groups": conv.groups, "intra_sim": conv.intra_sim,
            "inter_sim": conv.inter_sim, "wk": list(conv.wk.shape),
            "wv": list(conv.wv.shape), "kv_share": kv_share,
            "attention_rel_diff": rel}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="the card (default) or 'cpu' for the plain path")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
