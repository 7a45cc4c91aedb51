"""Quickstart: the port's Opt-GPTQ stack end to end, the counterpart of
``examples/quickstart.py``.

One line constructs the whole stack — architecture from the registry,
GPTQ int4 weights (Hessian OBQ over seeded synthetic calibration tokens)
and the paged continuous-batching engine::

    llm = LLM.load("qwen2-1.5b", quant="gptq-int4", ...)

then ``generate`` serves a batch with per-request ``SamplingParams`` and
the paper's three metrics are printed.

    PYTHONPATH=src python examples/repro_torch/quickstart.py        # card
    PYTHONPATH=src python examples/repro_torch/quickstart.py --device cpu

On the card (``--device cuda``, the default; raises on a host without
one) it loads qwen2-1.5b at full width cut to 4 layers (head dim 128):
the reduced config's head dim 16 is not one the bf16 tensor-core kernels
are built for.  The serve launches ``gptq_matmul``, ``paged_attention``
and ``flash_attention_chunk``; the calibration replay the static
``flash_attention``.  On the CPU (``--device cpu``, the plain path) it
loads the JAX example's own config: reduced qwen2-1.5b, 4 layers.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from repro_torch import resolve_device
from repro_torch.serving import LLM, SamplingParams


def run(device="cuda", calib_batches: Optional[list] = None) -> dict:
    """Load, serve 8 requests (greedy and sampled mixed, a shared 16-token
    prefix) and print the paper's metrics.  ``calib_batches``: GPTQ's
    calibration tokens (synthetic from the seed when None).  Returns the
    served tokens, their finish reasons and the engine's report."""
    card = resolve_device(device).type == "cuda"
    llm = LLM.load("qwen2-1.5b", quant="gptq-int4", reduced=not card,
                   overrides=dict(num_layers=4), max_slots=4,
                   num_blocks=128, max_blocks_per_seq=8, prefill_bucket=16,
                   calib_batches=calib_batches, device=device)
    cfg = llm.cfg
    print(f"model: {cfg.name} ({'full width' if card else 'reduced'}, "
          f"GPTQ int4, {cfg.num_layers} layers) — {cfg.num_heads} q-heads "
          f"sharing {cfg.num_kv_heads} kv-heads (Opt-GQA group size "
          f"{cfg.q_per_kv})")

    rng = np.random.default_rng(0)
    prefix = list(rng.integers(1, 200, 16))          # shared -> prefix reuse
    prompts = [prefix + list(rng.integers(1, 200, int(rng.integers(3, 12))))
               for _ in range(8)]
    # one batch mixes greedy and sampled requests
    sps = [SamplingParams(max_tokens=8) if i % 2 == 0 else
           SamplingParams(temperature=0.8, top_k=40, top_p=0.95,
                          max_tokens=8)
           for i in range(len(prompts))]
    outs = llm.generate(prompts, sps)
    for out in outs[:3]:
        print(f"  req {out.request_id}: {out.token_ids} "
              f"({out.finish_reason})")

    rep = llm.engine.report()
    print("\npaper metrics (Fig.2 format):")
    print(f"  latency:             {rep['latency_s']:.2f} s "
          f"(ttft {rep['ttft_s']:.2f} s)")
    print(f"  all throughput:      {rep['throughput_req_s']:.2f} req/s, "
          f"{rep['throughput_tok_s']:.1f} tok/s")
    print(f"  generate throughput: {rep['generate_tok_s']:.1f} tok/s")
    print(f"  prefix blocks reused: {rep['blocks_reused']}, "
          f"pool utilization {rep['block_utilization']:.2f}")
    llm.close()
    return {"config": cfg.name, "layers": cfg.num_layers,
            "tokens": [o.token_ids for o in outs],
            "finish_reasons": [o.finish_reason for o in outs],
            "load_s": llm.load_s, "report": rep}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="the card (default) or 'cpu' for the plain path")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
