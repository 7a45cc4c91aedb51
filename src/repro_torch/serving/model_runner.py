"""Device-side half of the serving engine: the decode state and the step
functions.

Owns the paged KV pools (bf16, or int8 with their scales; updated in
place), the unified step, the decode megastep, the standalone prefill
chunk, the whole-prompt prefill wave and sampling, and the copy-on-write
block copies.  It knows nothing about queues or request
lifecycles — the ``Scheduler`` does.  ``dispatches`` counts the device
calls issued (steps and CoW copies), which the engine diffs per step.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence as Seq, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.kv_quant import (cache_from_state, cache_to_state,
                                       normalize_kv_cache_dtype)
from repro_torch.core.paged_cache import copy_blocks
from repro_torch.core.sampling import sample_from_logits
from repro_torch.models import transformer as T

# decode-state entries that are pool-shaped [L, NB, ...]
_POOL_KEYS = ("k_pool", "v_pool", "k_scales", "v_scales")


class ModelRunner:
    def __init__(self, cfg: ModelConfig, params, *, max_slots: int,
                 num_blocks: int, max_blocks_per_seq: int,
                 rt: Optional[dict] = None, max_horizon: int = 8,
                 kv_cache_dtype: str = "bf16",
                 chunk_tokens: Optional[int] = 256):
        self.cfg = cfg
        self.device = params["embed"].device
        # weights used only cast to the activation dtype are cast once;
        # the layer stacks are split into per-layer views once
        self.params = T.split_layers(T.cast_params(params, T.act_dtype(cfg)))
        self.max_slots = max_slots
        self.num_blocks = num_blocks
        self.mb = max_blocks_per_seq
        self.rt = dict(rt or {})
        self.max_horizon = max(1, max_horizon)
        self.kv_cache_dtype = normalize_kv_cache_dtype(kv_cache_dtype)
        self.chunk_tokens = chunk_tokens
        self.dispatches = 0
        # the pool holds exactly what the activations produce: bf16 pools
        # for bf16 activations (the same numbers as the JAX package's f32
        # CPU pools of bf16 values), f32 pools for f32 activations
        self.state = T.make_decode_state(cfg, max_slots, num_blocks, self.mb,
                                         kv_cache_dtype=self.kv_cache_dtype,
                                         device=self.device)

    # ------------------------------------------------------------ uploads
    def _i32(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
            self.device)

    def _chunk_args(self, prompt: Seq[int], block_ids: Seq[int], start: int,
                    length: int):
        W = self.chunk_tokens
        toks = np.zeros((1, W), np.int32)
        toks[0, :length] = prompt[start:start + length]
        bt = np.zeros((1, self.mb), np.int32)
        bt[0, :len(block_ids)] = block_ids
        off = torch.tensor(start, dtype=torch.int32, device=self.device)
        tl = torch.tensor(start + length, dtype=torch.int32,
                          device=self.device)
        return self._i32(toks), self._i32(bt), off, tl

    # ------------------------------------------------------------ tables
    def sync_tables(self, running: Dict[int, "object"]) -> None:
        """Rebuild seq_lens / block_table device rows from host truth."""
        bt = np.zeros((self.max_slots, self.mb), np.int32)
        sl = np.zeros((self.max_slots,), np.int32)
        for slot, s in running.items():
            bt[slot, :len(s.block_ids)] = s.block_ids
            sl[slot] = s.seq_len
        self.state["block_table"] = self._i32(bt)
        self.state["seq_lens"] = self._i32(sl)

    # ------------------------------------------------------------ prefill
    @torch.no_grad()
    def prefill(self, seqs, maxlen: int) -> torch.Tensor:
        """Prefill a wave of admitted sequences (prompts right-padded to
        ``maxlen``) into the pools, in place; returns the last-token
        logits [len(seqs), V] on the device."""
        B = len(seqs)
        toks = np.zeros((B, maxlen), np.int32)
        lens = np.zeros((B,), np.int32)
        bt = np.zeros((B, self.mb), np.int32)
        for i, s in enumerate(seqs):
            toks[i, :s.seq_len] = s.req.prompt
            lens[i] = s.seq_len
            bt[i, :len(s.block_ids)] = s.block_ids
        # the wave's own block table and lengths; the pools are shared
        sub = dict(self.state, block_table=self._i32(bt),
                   seq_lens=self._i32(lens))
        self.dispatches += 1
        logits, sub = T.prefill(self.cfg, self.params, sub,
                                {"tokens": self._i32(toks),
                                 "ctx_lens": self._i32(lens)}, self.rt)
        for k in _POOL_KEYS:
            if k in sub:
                self.state[k] = sub[k]
        return logits

    # ------------------------------------------------------------ steps
    @torch.no_grad()
    def unified_step(self, tokens: np.ndarray,
                     sampling: Dict[str, np.ndarray], active: np.ndarray,
                     chunk_prompt: Seq[int], block_ids: Seq[int],
                     start: int, length: int) -> torch.Tensor:
        """One device dispatch for a mixed iteration: a decode step over
        the active slots, one prefill chunk, and sampling for both.
        Returns the [max_slots + 1] token buffer on the device (row
        max_slots is the chunk's first token, meaningful on final
        chunks)."""
        ct, cbt, off, tl = self._chunk_args(chunk_prompt, block_ids, start,
                                            length)
        self.dispatches += 1
        out, self.state = T.unified_step(
            self.cfg, self.params, self.state, self._i32(tokens), sampling,
            torch.from_numpy(np.asarray(active, bool)).to(self.device),
            ct, cbt, off, tl, self.rt)
        return out

    @torch.no_grad()
    def prefill_chunk(self, seq, start: int, length: int) -> torch.Tensor:
        """One prefill chunk of one sequence on its own; returns the
        last-live-token logits [1, V] on the device."""
        ct, cbt, off, tl = self._chunk_args(seq.req.prompt, seq.block_ids,
                                            start, length)
        self.dispatches += 1
        logits, cache = T.prefill_chunk(self.cfg, self.params,
                                        cache_from_state(self.state), ct,
                                        cbt, off, tl, self.rt)
        self.state.update(cache_to_state(cache))
        return logits

    @torch.no_grad()
    def megastep(self, tokens: np.ndarray, sampling: Dict[str, np.ndarray],
                 active: np.ndarray, n_steps: int) -> np.ndarray:
        """One fused horizon; returns the [n_steps, max_slots] token
        buffer as numpy (the one host sync of the dispatch)."""
        self.dispatches += 1
        out, self.state = T.decode_megastep(
            self.cfg, self.params, self.state, self._i32(tokens), sampling,
            torch.from_numpy(np.asarray(active, bool)).to(self.device),
            n_steps, max_horizon=self.max_horizon, rt=self.rt)
        return out[:n_steps].cpu().numpy()

    @torch.no_grad()
    def sample(self, logits: torch.Tensor,
               sampling: Dict[str, np.ndarray]) -> np.ndarray:
        """Per-row sampling of device logits (first tokens of chunks
        that ran on their own)."""
        self.dispatches += 1
        return sample_from_logits(
            logits, sampling["keys"], sampling["counts"], sampling["temps"],
            sampling["top_ks"], sampling["top_ps"],
            poison=sampling.get("poison"),
            guard=bool(self.rt.get("sampling_guard"))).cpu().numpy()

    # ------------------------------------------------------------ CoW
    @torch.no_grad()
    def copy_cow(self, pairs: Seq[Tuple[int, int]]) -> None:
        """Resolve copy-on-write on the device (block contents never visit
        the host).  pairs: [(src_block, dst_block), ...]."""
        src = self._i32([p[0] for p in pairs])
        dst = self._i32([p[1] for p in pairs])
        self.dispatches += 1
        for k in _POOL_KEYS:
            if k in self.state:
                copy_blocks(self.state[k], src, dst)

    # ------------------------------------------------------------ memory
    def kv_pool_bytes(self) -> int:
        """Device bytes held by the paged KV pools."""
        return sum(self.state[k].numel() * self.state[k].element_size()
                   for k in _POOL_KEYS if k in self.state)
