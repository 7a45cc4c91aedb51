"""Deterministic synthetic data for the trainer, resumable from its
state: the JAX package's ``data/pipeline.py`` with the same numpy draws,
so the port's batches are bitwise the reference's.

Real deployments swap ``SyntheticLM`` for a tokenized corpus reader; the
interface (``state`` / ``restore`` / ``next_batch``) is what the
checkpoint-restart supervision relies on.  The reference places a batch
on a mesh; here it goes to one device (the card by default).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass
class SyntheticLM:
    """Zipf-ish synthetic LM token stream; step-indexed => resumable."""
    cfg: ModelConfig
    shape: ShapeConfig
    seed: int = 0
    step: int = 0

    def state(self) -> Dict[str, int]:
        return {"step": self.step, "seed": self.seed}

    def restore(self, st: Dict[str, int]) -> None:
        self.step = int(st["step"])
        self.seed = int(st["seed"])

    def _host_batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg, sh = self.cfg, self.shape
        rng = np.random.default_rng((self.seed, step))
        B, S = sh.global_batch, sh.seq_len
        if cfg.is_encoder:
            return {
                "frames": rng.standard_normal((B, S, cfg.d_model),
                                              dtype=np.float32) * 0.1,
                "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            }
        # zipf-like marginal + local repetition (gives a learnable signal)
        ranks = rng.zipf(1.3, size=(B, S + 1))
        toks = np.clip(ranks, 1, cfg.vocab_size - 1).astype(np.int32)
        rep = rng.random((B, S + 1)) < 0.3
        toks[:, 1:] = np.where(rep[:, 1:], toks[:, :-1], toks[:, 1:])
        out = {"tokens": toks}
        if cfg.frontend == "vision_patches":
            out["vision_embeds"] = rng.standard_normal(
                (B, cfg.num_prefix_embeds, cfg.d_model), dtype=np.float32) * 0.1
        return out

    def next_batch(self, device="cuda") -> Dict[str, torch.Tensor]:
        """The batch of the current step as tensors on ``device`` (the card
        unless the caller asks for the CPU), and the step advanced."""
        dev = resolve_device(device)
        host = self._host_batch(self.step)
        self.step += 1
        return {k: torch.from_numpy(v).to(dev) for k, v in host.items()}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        while True:
            yield self.next_batch()
