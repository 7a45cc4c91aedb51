"""Device-side half of the serving engine: the decode state and the step
functions.

Owns the paged KV pools (bf16, or int8 with their scales; updated in
place), the unified step and its chained variant, the decode megastep,
the per-token decode, the standalone prefill chunk, the whole-prompt
prefill wave and sampling, and the copy-on-write block copies.  It knows
nothing about queues or request lifecycles — the ``Scheduler`` does.
``dispatches`` counts the device calls issued (steps, samples and CoW
copies), which the engine diffs per step; ``steps`` counts the decode
steps, prefill chunks and whole-prompt waves the model ran, one attention
call per layer each.

Transfers never block the host behind the device.  A copy from pageable
host memory to the card synchronizes the stream, and a blocking copy back
waits for everything enqueued, the next dispatch included; either would
stop the async engine's dispatch N+1 from running under the host work of
step N.  So every upload of a dispatch (its token, table, chunk and
sampling rows) is packed into one pinned staging buffer and copied with
``non_blocking=True`` (``_Staging``), and every readback is a
non-blocking copy into pinned memory with an event behind it
(``Readback``), which the host waits on only when it needs the
tokens.  All of it runs on the current stream, so launches keep their
order (the decode kernel's arrival counters rely on it).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence as Seq, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.kv_quant import (cache_from_state, cache_to_state,
                                       normalize_kv_cache_dtype)
from repro_torch.core.paged_cache import copy_blocks
from repro_torch.core.sampling import sample_from_logits, sampling_plan
from repro_torch.models import transformer as T
from repro_torch.obs.trace import NULL_TRACER

# decode-state entries that are pool-shaped [L, NB, ...]
_POOL_KEYS = ("k_pool", "v_pool", "k_scales", "v_scales")
_SAMPLING_KEYS = ("keys", "counts", "temps", "top_ks", "top_ps", "poison")


def _words(a: np.ndarray) -> np.ndarray:
    """A host array's values as int32 words (bools as 0 / 1; 32-bit ints
    and floats bit for bit)."""
    if a.dtype == np.bool_:
        return a.astype(np.int32).ravel()
    if a.dtype.itemsize != 4:
        raise TypeError(f"staged arrays hold 32-bit values, not {a.dtype}")
    return np.ascontiguousarray(a).view(np.int32).ravel()


def _unwords(w: torch.Tensor, dtype: np.dtype) -> torch.Tensor:
    if dtype == np.bool_:
        return w != 0
    if dtype == np.float32:
        return w.view(torch.float32)
    return w                      # int32, and uint32 keys as their bits


class _Staging:
    """Pinned host buffers that carry a dispatch's uploads to the device
    in one non-blocking copy.  The buffers alternate (``DEPTH`` of them);
    one is refilled only after the event recorded behind its last copy has
    completed.  In the pipelined engine that copy preceded a dispatch the
    host has already read back, so the wait costs nothing.  On the CPU the
    words go into a fresh tensor."""

    DEPTH = 2

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self._bufs: List[Optional[torch.Tensor]] = [None] * self.DEPTH
        # recorded behind each buffer's last copy, once it has one
        self._events = [torch.cuda.Event() for _ in range(self.DEPTH)] \
            if self.cuda else []
        self._used = [False] * self.DEPTH
        self._next = 0

    def upload(self, arrays: Dict[str, np.ndarray]
               ) -> Dict[str, torch.Tensor]:
        items, words, n = [], [], 0
        for name, a in arrays.items():
            a = np.asarray(a)
            w = _words(a)
            items.append((name, a.shape, a.dtype, n, w.size))
            words.append(w)
            n += w.size
        if self.cuda:
            i = self._next
            self._next = (i + 1) % self.DEPTH
            if self._used[i]:
                self._events[i].synchronize()
            if self._bufs[i] is None or self._bufs[i].numel() < n:
                self._bufs[i] = torch.empty(max(n, 1024), dtype=torch.int32,
                                            pin_memory=True)
            host = self._bufs[i][:n]
            np.concatenate(words, out=host.numpy())
            dev = host.to(self.device, non_blocking=True)
            self._events[i].record()
            self._used[i] = True
        else:
            dev = torch.from_numpy(np.concatenate(words))
        return {name: _unwords(dev[o:o + size], dtype).reshape(shape)
                for name, shape, dtype, o, size in items}


class Readback:
    """A device tensor's non-blocking copy into pinned host memory, with
    the event recorded right behind it; ``wait`` blocks on that event
    only (not on work enqueued later) and returns the numpy array."""

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = t.clone(), None

    def wait(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class ModelRunner:
    def __init__(self, cfg: ModelConfig, params, *, max_slots: int,
                 num_blocks: int, max_blocks_per_seq: int,
                 rt: Optional[dict] = None, max_horizon: int = 8,
                 kv_cache_dtype: str = "bf16",
                 chunk_tokens: Optional[int] = 256, tracer=None,
                 profile_labels: bool = False):
        self.cfg = cfg
        self.device = params["embed"].device
        # weights used only cast to the activation dtype are cast once;
        # the layer stacks are split into per-layer views once
        self.params = T.split_layers(T.cast_params(params, T.act_dtype(cfg)))
        # engine-owned span tracer; NULL_TRACER does no work
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # name each dispatch's region in a torch.profiler capture
        self.profile_labels = bool(profile_labels)
        self.max_slots = max_slots
        self.num_blocks = num_blocks
        self.mb = max_blocks_per_seq
        self.rt = dict(rt or {})
        self.max_horizon = max(1, max_horizon)
        self.kv_cache_dtype = normalize_kv_cache_dtype(kv_cache_dtype)
        self.chunk_tokens = chunk_tokens
        self.dispatches = 0
        self.steps = {"decode": 0, "chunk": 0, "wave": 0}
        self._staging = _Staging(self.device)
        self._tables: Optional[Tuple[np.ndarray, np.ndarray]] = None
        # the pool holds exactly what the activations produce: bf16 pools
        # for bf16 activations (the same numbers as the JAX package's f32
        # CPU pools of bf16 values), f32 pools for f32 activations
        self.state = T.make_decode_state(cfg, max_slots, num_blocks, self.mb,
                                         kv_cache_dtype=self.kv_cache_dtype,
                                         device=self.device)
        # the chained step's feed buffer when nothing is in flight
        self.zero_prev = torch.zeros(max_slots + 1, dtype=torch.int32,
                                     device=self.device)

    # ------------------------------------------------------------ obs
    def _label(self, name: str):
        """A ``torch.profiler.record_function`` region when
        ``profile_labels`` is on, else a free nullcontext."""
        if self.profile_labels:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    # ------------------------------------------------------------ uploads
    def _upload(self, **arrays) -> Dict[str, torch.Tensor]:
        """One staged upload of a dispatch's host arrays; tables set by
        ``sync_tables`` since the last dispatch ride along into state."""
        tables = self._tables
        if tables is not None:
            arrays["_bt"], arrays["_sl"] = tables
            self._tables = None
        dev = self._staging.upload(arrays)
        if tables is not None:
            self.state["block_table"] = dev.pop("_bt")
            self.state["seq_lens"] = dev.pop("_sl")
        return dev

    def _sampling(self, sampling: Dict[str, np.ndarray], dev: dict) -> dict:
        """The staged sampling rows plus the host's branch plan."""
        sp = {k: dev[f"sp_{k}"] for k in _SAMPLING_KEYS if k in sampling}
        sp["plan"] = sampling_plan(sampling["temps"], sampling["top_ks"],
                                   sampling["top_ps"])
        return sp

    @staticmethod
    def _sampling_arrays(sampling: Dict[str, np.ndarray]) -> dict:
        return {f"sp_{k}": np.asarray(sampling[k], np.float32
                                      if k in ("temps", "top_ps", "poison")
                                      else None)
                for k in _SAMPLING_KEYS if k in sampling}

    def _chunk_arrays(self, prompt: Seq[int], block_ids: Seq[int],
                      start: int, length: int) -> dict:
        toks = np.zeros((1, self.chunk_tokens), np.int32)
        toks[0, :length] = prompt[start:start + length]
        bt = np.zeros((1, self.mb), np.int32)
        bt[0, :len(block_ids)] = block_ids
        return {"c_toks": toks, "c_bt": bt,
                "c_off": np.array(start, np.int32),
                "c_tl": np.array(start + length, np.int32)}

    def _readback(self, out: torch.Tensor) -> np.ndarray:
        with self.tracer.span("readback", cat="device"):
            return Readback(out).wait()

    # ------------------------------------------------------------ tables
    def sync_tables(self, running: Dict[int, "object"]) -> None:
        """Set the seq_lens / block_table rows from host truth; they are
        uploaded with the next dispatch."""
        bt = np.zeros((self.max_slots, self.mb), np.int32)
        sl = np.zeros((self.max_slots,), np.int32)
        for slot, s in running.items():
            bt[slot, :len(s.block_ids)] = s.block_ids
            sl[slot] = s.seq_len
        self._tables = (bt, sl)

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
        dev = self._upload(toks=toks, lens=lens, bt=bt)
        # the wave's own block table and lengths; the pools are shared
        sub = dict(self.state, block_table=dev["bt"], seq_lens=dev["lens"])
        self.dispatches += 1
        self.steps["wave"] += 1
        with self.tracer.span("dispatch:prefill", cat="device",
                              args={"batch": B, "maxlen": maxlen}), \
                self._label("prefill"):
            logits, sub = T.prefill(self.cfg, self.params, sub,
                                    {"tokens": dev["toks"],
                                     "ctx_lens": dev["lens"]}, self.rt)
        for k in _POOL_KEYS:
            if k in sub:
                self.state[k] = sub[k]
        return logits

    @torch.no_grad()
    def prefill_chunk(self, seq, start: int, length: int) -> torch.Tensor:
        """One prefill chunk of one sequence on its own; returns the
        last-live-token logits [1, V] on the device."""
        dev = self._upload(**self._chunk_arrays(seq.req.prompt,
                                                seq.block_ids, start, length))
        self.dispatches += 1
        self.steps["chunk"] += 1
        with self.tracer.span("dispatch:chunk", cat="device",
                              args={"start": start, "length": length}), \
                self._label("prefill_chunk"):
            logits, cache = T.prefill_chunk(
                self.cfg, self.params, cache_from_state(self.state),
                dev["c_toks"], dev["c_bt"], dev["c_off"], dev["c_tl"],
                self.rt)
        self.state.update(cache_to_state(cache))
        return logits

    # ------------------------------------------------------------ steps
    def _unified(self, name: str, prev_out: Optional[torch.Tensor],
                 extra: dict, tokens: np.ndarray,
                 sampling: Dict[str, np.ndarray], active: np.ndarray,
                 chunk_prompt: Seq[int], block_ids: Seq[int], start: int,
                 length: int) -> torch.Tensor:
        dev = self._upload(toks=np.asarray(tokens, np.int32),
                           active=np.asarray(active, bool), **extra,
                           **self._sampling_arrays(sampling),
                           **self._chunk_arrays(chunk_prompt, block_ids,
                                                start, length))
        sp = self._sampling(sampling, dev)
        chunk = (dev["c_toks"], dev["c_bt"], dev["c_off"], dev["c_tl"])
        self.dispatches += 1
        self.steps["decode"] += 1
        self.steps["chunk"] += 1
        span = "dispatch:unified_chained" if extra else "dispatch:unified"
        with self.tracer.span(span, cat="device",
                              args={"start": start, "length": length}), \
                self._label(name):
            if prev_out is None and not extra:
                out, self.state = T.unified_step(
                    self.cfg, self.params, self.state, dev["toks"], sp,
                    dev["active"], *chunk, self.rt)
            else:
                out, self.state = T.unified_step_chained(
                    self.cfg, self.params, self.state,
                    self.zero_prev if prev_out is None else prev_out,
                    dev["chain_idx"], dev["use_prev"], dev["toks"], sp,
                    dev["active"], *chunk, self.rt)
        return out

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
        return self._unified("unified_step", None, {}, tokens, sampling,
                             active, chunk_prompt, block_ids, start, length)

    @torch.no_grad()
    def unified_step_chained(self, prev_out: Optional[torch.Tensor],
                             chain_idx: np.ndarray, use_prev: np.ndarray,
                             tokens: np.ndarray,
                             sampling: Dict[str, np.ndarray],
                             active: np.ndarray, chunk_prompt: Seq[int],
                             block_ids: Seq[int], start: int,
                             length: int) -> torch.Tensor:
        """``unified_step`` for the async pipeline: the decode feed tokens
        are gathered on the device from ``prev_out`` — the previous
        dispatch's [max_slots + 1] buffer, possibly still being computed —
        wherever ``use_prev`` is set (``chain_idx`` names the row; row
        max_slots is the chunk sample).  ``prev_out`` None feeds from a
        zero buffer (nothing in flight).  Returns this dispatch's own
        buffer on the device."""
        extra = {"chain_idx": np.asarray(chain_idx, np.int32),
                 "use_prev": np.asarray(use_prev, bool)}
        return self._unified("unified_step_chained", prev_out, extra,
                             tokens, sampling, active, chunk_prompt,
                             block_ids, start, length)

    @torch.no_grad()
    def decode(self, tokens: np.ndarray) -> torch.Tensor:
        """One per-token decode step for all slots (tokens [max_slots]);
        returns the logits [max_slots, V] on the device."""
        dev = self._upload(toks=np.asarray(tokens, np.int32))
        self.dispatches += 1
        self.steps["decode"] += 1
        with self.tracer.span("dispatch:decode", cat="device"), \
                self._label("decode"):
            logits, self.state = T.decode_step(self.cfg, self.params,
                                               self.state, dev["toks"],
                                               self.rt)
        return logits

    @torch.no_grad()
    def megastep(self, tokens: np.ndarray, sampling: Dict[str, np.ndarray],
                 active: np.ndarray, n_steps: int) -> np.ndarray:
        """One fused horizon; returns the [n_steps, max_slots] token
        buffer as numpy (the one host sync of the dispatch)."""
        dev = self._upload(toks=np.asarray(tokens, np.int32),
                           active=np.asarray(active, bool),
                           **self._sampling_arrays(sampling))
        self.dispatches += 1
        self.steps["decode"] += int(n_steps)
        with self.tracer.span("dispatch:megastep", cat="device",
                              args={"n_steps": int(n_steps)}), \
                self._label("megastep"):
            out, self.state = T.decode_megastep(
                self.cfg, self.params, self.state, dev["toks"],
                self._sampling(sampling, dev), dev["active"], n_steps,
                max_horizon=self.max_horizon, rt=self.rt)
            return self._readback(out[:n_steps])

    @torch.no_grad()
    def sample(self, logits: torch.Tensor,
               sampling: Dict[str, np.ndarray]) -> np.ndarray:
        """Per-row sampling of device logits (the first tokens of chunks
        that ran on their own, whole-prompt waves, the per-token oracle);
        returns the tokens as numpy."""
        dev = self._upload(**self._sampling_arrays(sampling))
        sp = self._sampling(sampling, dev)
        self.dispatches += 1
        with self.tracer.span("dispatch:sample", cat="device"), \
                self._label("sample"):
            tok = sample_from_logits(
                logits, sp["keys"], sp["counts"], sp["temps"], sp["top_ks"],
                sp["top_ps"], poison=sp.get("poison"),
                guard=bool(self.rt.get("sampling_guard")), plan=sp["plan"])
            return self._readback(tok)

    # ------------------------------------------------------------ CoW
    @torch.no_grad()
    def copy_cow(self, pairs: Seq[Tuple[int, int]]) -> None:
        """Resolve copy-on-write on the device (block contents never visit
        the host).  pairs: [(src_block, dst_block), ...]."""
        dev = self._upload(src=np.array([p[0] for p in pairs], np.int32),
                           dst=np.array([p[1] for p in pairs], np.int32))
        self.dispatches += 1
        with self.tracer.span("dispatch:cow", cat="device",
                              args={"pairs": len(pairs)}), \
                self._label("copy_cow"):
            for k in _POOL_KEYS:
                if k in self.state:
                    copy_blocks(self.state[k], dev["src"], dev["dst"])

    # ------------------------------------------------------------ memory
    def kv_pool_bytes(self) -> int:
        """Device bytes held by the paged KV pools."""
        return sum(self.state[k].numel() * self.state[k].element_size()
                   for k in _POOL_KEYS if k in self.state)

    def kv_bytes_per_token(self) -> float:
        """KV bytes per cached token position, across all layers (scales
        amortized over the block)."""
        bs = self.cfg.paging.block_size
        return self.kv_pool_bytes() / float(self.num_blocks * bs)
