"""Train a small model on the port with the full training stack (remat,
AdamW, checkpointing, fault supervision), the counterpart of
``examples/train_small.py``:

    PYTHONPATH=src python examples/repro_torch/train_small.py [--steps 300]
    PYTHONPATH=src python examples/repro_torch/train_small.py --device cpu

Equivalent CLI form (also supports --resume and failure injection):
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --layers 6 --steps 300 --batch 8 --seq 128

On the card (``--device cuda``, the default; raises on a host without
one) it trains qwen2-1.5b at full width cut to 6 layers (head dim 128,
~0.5 B parameters; the reduced config's head dim is not one the bf16
tensor-core kernels are built for): each step's forward and its
recompute launch the static ``flash_attention``.  On the CPU (the plain
path) it trains the JAX example's own model: reduced qwen2-1.5b at
d_model 384, 6 layers.  Batches of 8 x 128 tokens either way.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import List, Optional, Sequence

from repro_torch import resolve_device
from repro_torch.launch import train as train_cli


def train_argv(steps: int, device: str, ckpt_dir: str) -> List[str]:
    """The trainer CLI's arguments for this example on ``device``."""
    card = resolve_device(device).type == "cuda"
    model = [] if card else ["--reduced", "--d-model", "384"]
    return ["--arch", "qwen2-1.5b", *model, "--layers", "6",
            "--steps", str(steps), "--batch", "8", "--seq", "128",
            "--device", device, "--ckpt-dir", ckpt_dir]


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    """Returns the loss of every step."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default="cuda",
                    help="the card (default) or 'cpu' for the plain path")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_train_small"))
    args = ap.parse_args(argv)
    losses = train_cli.main(train_argv(args.steps, args.device,
                                       args.ckpt_dir))
    print(f"{len(losses)} steps: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
