"""Offline GPTQ quantization walkthrough on the port (the 'GPTQ' in
Opt-GPTQ), the counterpart of ``examples/quantize_model.py``.

Quantizes one linear layer with the full OBQ loop and compares it with
round-to-nearest under the calibration Hessian, then quantizes a whole
model and reports the logit drift.

    PYTHONPATH=src python examples/repro_torch/quantize_model.py        # card
    PYTHONPATH=src python examples/repro_torch/quantize_model.py --device cpu

Everything runs on ``--device``: the card by default (raises on a host
without one), where the whole model is qwen2-1.5b at full width cut to 4
layers (head dim 128; the reduced config's head dim 16 is not one the
bf16 tensor-core kernels are built for) and its forwards launch
``gptq_matmul`` and the static ``flash_attention``; on the CPU (the
plain path) the JAX example's own config, reduced qwen2-1.5b with 2
layers.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import QuantConfig
from repro_torch.configs.registry import get_config, get_reduced
from repro_torch.core.gptq import gptq_quantize, quant_error, rtn_quantize
from repro_torch.models import transformer as T
from repro_torch.models.quantize import (gptq_quantize_model,
                                         quantize_params_rtn)


def model_config(card: bool):
    """The whole-model part's config: full width, 4 layers on the card;
    the JAX example's reduced 2 layers on the CPU."""
    return get_config("qwen2-1.5b").replace(num_layers=4) if card \
        else get_reduced("qwen2-1.5b", num_layers=2)


def run(device="cuda", params=None, calib: Optional[list] = None) -> dict:
    """Both parts on ``device``.  ``params``: the whole model's dense
    params (seeded ``T.init_params`` when None); ``calib``: 4 batches of
    {"tokens": [2, 32]} (seeded numpy tokens when None).  Returns the
    single layer's proxy losses per bit width and the model's drift."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    print("== single layer: GPTQ vs RTN under the calibration Hessian ==")
    din, dout, n = 256, 128, 4096
    x = rng.normal(size=(n, din)) * (1 + 4 * rng.random(din))
    w = torch.from_numpy(rng.normal(size=(din, dout))).to(dev)
    h = torch.from_numpy(2 * x.T @ x / n).to(dev)
    single = {}
    for bits in (4, 3):
        cfg = QuantConfig(bits=bits, group_size=64)
        eg = quant_error(w, gptq_quantize(w, h, cfg), h)
        er = quant_error(w, rtn_quantize(w, cfg), h)
        single[bits] = {"gptq": eg, "rtn": er}
        print(f"  int{bits}: gptq={eg:.5f}  rtn={er:.5f}  "
              f"(GPTQ {100*(er-eg)/er:.1f}% better)")

    print("\n== whole model: logit drift after int4 quantization ==")
    cfg = model_config(dev.type == "cuda")
    if params is None:
        params = T.init_params(cfg, 0, dev)
    if calib is None:
        calib = [{"tokens": rng.integers(0, cfg.vocab_size, (2, 32))}
                 for _ in range(4)]
    qg = gptq_quantize_model(cfg, params, calib, QuantConfig(group_size=32))
    qr = quantize_params_rtn(params, cfg, group_size=32)
    test = calib[0]
    model = {}
    with torch.no_grad():
        lf = T.forward(cfg, params, test).double()
        for name, q in (("gptq", qg), ("rtn", qr)):
            lq = T.forward(cfg, q, test).double()
            drift = (lq - lf).abs().mean().item()
            agree = (lq.argmax(-1) == lf.argmax(-1)).double().mean().item()
            model[name] = {"mean_abs_drift": drift, "top1_agree": agree}
            print(f"  {name}: mean|Δlogit|={drift:.4f}  "
                  f"top1-agree={agree:.3f}")
    print("\nweight bytes: int4+scales ≈ 0.28x of fp16 "
          "(4.0b codes + per-group scale/zero)")
    return {"config": cfg.name, "layers": cfg.num_layers, "single": single,
            "model": model}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="the card (default) or 'cpu' for the plain path")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
