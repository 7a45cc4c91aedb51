"""Device-side half of the serving engine: the decode state and the step
functions.

Owns the paged KV pools (bf16, or int8 with their scales; updated in
place) and the per-slot recurrent state of a hybrid's RG-LRU layers or a
Mamba stack (which has no pool and no block table: the host keeps its
block bookkeeping, the device gets no table), the unified step and its
chained variant, the decode megastep, the per-token decode, the
standalone prefill chunk, the whole-prompt prefill wave and sampling,
and the copy-on-write block copies.  It knows nothing about queues or
request lifecycles — the ``Scheduler`` does.
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

With ``capture_graphs`` (the default) the fixed-shape steps — the unified
step, its chained variant, the megastep's decode-plus-sample step and the
standalone prefill chunk — run as captured CUDA graphs
(``step_graph.StepGraph``), the counterpart of the reference's one jitted
executable per step.  Each dispatch of them is one staged copy into the
graph's static inputs, one graph launch (the megastep: one per decode
step of its horizon) and the readback.  The decode state is then static:
``self.state`` keeps its tensors for the runner's life, tables from
``sync_tables`` are copied into them, and every state entry a step
returns as a new tensor is copied back inside the captured region.
Whole-prompt waves (a graph per (rows, bucket), each with its own
activations, for a wave that runs once per admission), the standalone
``sample`` (its row count varies), the per-token ``decode`` oracle and
the CoW block copies stay eager.  On the CPU the same bookkeeping runs
the step functions on the static buffers.
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
from repro_torch.kernels import gptq_matmul, paged_attention
from repro_torch.models import transformer as T
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serving import step_graph
from repro_torch.serving.step_graph import (Fields, StepGraph, _unwords,
                                            _words)

# decode-state entries that are pool-shaped [L, NB, ...]
_POOL_KEYS = ("k_pool", "v_pool", "k_scales", "v_scales")
# per-slot recurrent state [layers, max_slots, ...] of a hybrid's RG-LRU
# layers and of a Mamba stack
_SLOT_KEYS = ("lru_h", "rec_conv", "ssm_h", "ssm_conv")
_SAMPLING_KEYS = ("keys", "counts", "temps", "top_ks", "top_ps", "poison")


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
            dev = torch.empty(n, dtype=torch.int32, device=self.device)
            self.upload_into(dev, words)
        else:
            dev = torch.from_numpy(np.concatenate(words))
        return {name: _unwords(dev[o:o + size], dtype).reshape(shape)
                for name, shape, dtype, o, size in items}

    def upload_into(self, dst: torch.Tensor, words: List[np.ndarray]
                    ) -> None:
        """Copy the concatenated int32 ``words`` into the first words of
        the device buffer ``dst`` (a step graph's static inputs) in one
        non-blocking copy from the next pinned buffer."""
        n = sum(w.size for w in words)
        if not self.cuda:
            dst[:n].copy_(torch.from_numpy(np.concatenate(words)))
            return
        i = self._next
        self._next = (i + 1) % self.DEPTH
        if self._used[i]:
            self._events[i].synchronize()
        if self._bufs[i] is None or self._bufs[i].numel() < n:
            self._bufs[i] = torch.empty(max(n, 1024), dtype=torch.int32,
                                        pin_memory=True)
        host = self._bufs[i][:n]
        np.concatenate(words, out=host.numpy())
        dst[:n].copy_(host, non_blocking=True)
        self._events[i].record()
        self._used[i] = True


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
                 profile_labels: bool = False, capture_graphs: bool = True):
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
        # the tables the device keeps: a Mamba stack has no block table
        self._table_keys = tuple(k for k in ("block_table", "seq_lens")
                                 if k in self.state)
        # the chained step's feed buffer when nothing is in flight
        self.zero_prev = torch.zeros(max_slots + 1, dtype=torch.int32,
                                     device=self.device)
        # the fixed-shape steps as step graphs, made at their first
        # dispatch; on the card they share one capture stream and pool
        self.capture_graphs = bool(capture_graphs)
        self.graphs: Dict[str, StepGraph] = {}
        # captures per kind of graphs released by ``close``
        self._closed_captures: Dict[str, int] = {}
        self._capture_stream = None
        self._pool = None

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
            arrays.update(self._table_arrays(tables))
            self._tables = None
        dev = self._staging.upload(arrays)
        if tables is not None:
            self._keep({k: dev.pop(f"t_{k}") for k in self._table_keys})
        return dev

    def _table_arrays(self, tables: Tuple[np.ndarray, np.ndarray]) -> dict:
        """The host tables ``sync_tables`` built, by the staged names of
        the ones the device keeps."""
        return {f"t_{k}": t for k, t in zip(("block_table", "seq_lens"),
                                             tables)
                if k in self._table_keys}

    def _keep(self, new: Dict[str, torch.Tensor]) -> None:
        """Take state entries an eager dispatch produced: copied into the
        static tensors when graphs are on, else bound in their place."""
        if self.capture_graphs:
            step_graph.copy_back(self.state, new)
        else:
            self.state.update(new)

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

    # ------------------------------------------------------------ graphs
    def _fields(self, kind: str) -> Fields:
        """The static inputs of a dispatch kind, ``_Staging``'s names: the
        chunk's, the decode rows and sampling rows (``max_slots`` rows, one
        more for the chunk in the unified kinds), the chained feed's
        gather, the megastep's step index, and the tables ``sync_tables``
        may send along (``t_set`` says whether it did)."""
        B, MB = self.max_slots, self.mb
        shapes = {"block_table": (B, MB), "seq_lens": (B,)}
        f: Fields = {f"t_{k}": (shapes[k], np.int32)
                     for k in self._table_keys}
        f["t_set"] = ((), np.bool_)
        if kind != "chunk":
            rows = B if kind == "megastep" else B + 1
            f.update(toks=((B,), np.int32), active=((B,), np.bool_),
                     sp_keys=((rows, 2), np.uint32),
                     sp_counts=((rows,), np.int32),
                     sp_temps=((rows,), np.float32),
                     sp_top_ks=((rows,), np.int32),
                     sp_top_ps=((rows,), np.float32),
                     sp_poison=((rows,), np.float32))
        if kind == "chained":
            f.update(chain_idx=((B,), np.int32), use_prev=((B,), np.bool_))
        if kind == "megastep":
            f["step"] = ((), np.int32)
        else:
            f.update(c_toks=((1, self.chunk_tokens), np.int32),
                     c_bt=((1, MB), np.int32), c_off=((), np.int32),
                     c_tl=((), np.int32))
        return f

    def _graph(self, kind: str) -> StepGraph:
        g = self.graphs.get(kind)
        if g is not None:
            return g
        if self.device.type == "cuda" and self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        buffers = {}
        if kind == "chained":
            buffers["prev"] = torch.zeros_like(self.zero_prev)
        elif kind == "megastep":
            buffers["out"] = torch.zeros((self.max_horizon, self.max_slots),
                                         dtype=torch.int32,
                                         device=self.device)
        body = {"unified": self._unified_body, "chained": self._unified_body,
                "megastep": self._megastep_body,
                "chunk": self._chunk_body}[kind]
        g = StepGraph(kind, self._fields(kind), self.device,
                      lambda key: body(kind, key), buffers=buffers,
                      stream=self._capture_stream, pool=self._pool)
        self.graphs[kind] = g
        return g

    def _stage(self, kind: str, arrays: dict) -> StepGraph:
        """One staged copy of a dispatch's host arrays, and the tables
        ``sync_tables`` set since the last dispatch, into the static
        inputs of its kind's graph."""
        g = self._graph(kind)
        if self._tables is not None:
            arrays = dict(arrays, **self._table_arrays(self._tables),
                          t_set=np.bool_(True))
            self._tables = None
        g.stage(self._staging, arrays)
        return g

    def _variant(self, sampling: Dict[str, np.ndarray]) -> tuple:
        """Every host-side choice of a sampling step, as a graph variant
        key: ``sampling_plan``'s (samples, filters), the guard, and
        whether a poison row rides along."""
        return (*sampling_plan(sampling["temps"], sampling["top_ks"],
                               sampling["top_ps"]),
                bool(self.rt.get("sampling_guard")), "poison" in sampling)

    def _apply_tables(self, inp: dict, now=None) -> None:
        """Inside a step: the staged tables written into the static state
        where ``t_set`` (and ``now``) hold, else the state kept."""
        on = inp["t_set"] if now is None else inp["t_set"] & now
        for name in self._table_keys:
            dst = self.state[name]
            dst.copy_(torch.where(on, inp[f"t_{name}"], dst))

    @staticmethod
    def _graph_sampling(inp: dict, key: tuple) -> dict:
        samples, filters, _, poison = key
        sp = {k: inp[f"sp_{k}"] for k in _SAMPLING_KEYS if k != "poison"}
        if poison:
            sp["poison"] = inp["sp_poison"]
        sp["plan"] = (samples, filters)
        return sp

    def _unified_body(self, kind: str, key: tuple) -> torch.Tensor:
        g = self.graphs[kind]
        inp = g.inputs()
        self._apply_tables(inp)
        sp = self._graph_sampling(inp, key)
        chunk = (inp["c_toks"], inp["c_bt"], inp["c_off"], inp["c_tl"])
        if kind == "chained":
            out, new = T.unified_step_chained(
                self.cfg, self.params, dict(self.state), g.buffers["prev"],
                inp["chain_idx"], inp["use_prev"], inp["toks"], sp,
                inp["active"], *chunk, self.rt)
        else:
            out, new = T.unified_step(
                self.cfg, self.params, dict(self.state), inp["toks"], sp,
                inp["active"], *chunk, self.rt)
        step_graph.copy_back(self.state, new)
        return out

    def _megastep_body(self, kind: str, key: tuple) -> None:
        g = self.graphs[kind]
        inp = g.inputs()
        t = inp["step"]
        # the tables land before the horizon's first step only
        self._apply_tables(inp, now=t == 0)
        sp = self._graph_sampling(inp, key)
        row, feed, new = T.decode_sample_step(
            self.cfg, self.params, dict(self.state), inp["toks"], sp,
            inp["active"], sp["counts"] + t, key[2], self.rt)
        step_graph.copy_back(self.state, new)
        g.buffers["out"].index_copy_(0, t.long().reshape(1), row[None])
        inp["toks"].copy_(feed)
        t.add_(1)

    def _chunk_body(self, kind: str, key: tuple) -> torch.Tensor:
        inp = self.graphs[kind].inputs()
        self._apply_tables(inp)
        logits, cache = T.prefill_chunk(
            self.cfg, self.params, cache_from_state(self.state),
            inp["c_toks"], inp["c_bt"], inp["c_off"], inp["c_tl"], self.rt)
        step_graph.copy_back(self.state, cache_to_state(cache))
        return logits

    def graph_stats(self) -> Dict[str, dict]:
        """Per dispatch kind: variants captured (their keys), replays, the
        seconds spent capturing."""
        return {k: {"captures": g.captures, "replays": g.replays,
                    "variants": [list(v) for v in g.variants],
                    "capture_s": g.capture_s}
                for k, g in self.graphs.items()}

    def close(self) -> None:
        """Release the step graphs, their static outputs and pool, and the
        decode kernel's scratch and the int4 matmul's split-K counters on
        the capture stream.  A later dispatch captures anew."""
        if self._capture_stream is not None:
            torch.cuda.current_stream(self.device).synchronize()
        for kind, g in self.graphs.items():
            self._closed_captures[kind] = \
                self._closed_captures.get(kind, 0) + g.captures
            g.reset()
        self.graphs.clear()
        if self._capture_stream is not None:
            paged_attention.drop_scratch(self._capture_stream.cuda_stream)
            gptq_matmul.drop_counters(self._capture_stream.cuda_stream)
        self._capture_stream = self._pool = None

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
        logits [len(seqs), V] on the device.  The wave starts each row's
        recurrent state (a hybrid's RG-LRU layers, a Mamba stack) from
        zeros and returns its rows, which are written at the wave's slots
        in place (the state keeps its tensors: step graphs read them).  A
        model without attention layers gets no block table."""
        B = len(seqs)
        toks = np.zeros((B, maxlen), np.int32)
        lens = np.zeros((B,), np.int32)
        bt = np.zeros((B, self.mb), np.int32)
        for i, s in enumerate(seqs):
            toks[i, :s.seq_len] = s.req.prompt
            lens[i] = s.seq_len
            bt[i, :len(s.block_ids)] = s.block_ids
        tables = {"bt": bt} if "block_table" in self.state else {}
        dev = self._upload(toks=toks, lens=lens, **tables,
                           slots=np.array([s.slot for s in seqs], np.int32))
        # the wave's own block table and lengths; the pools are shared
        sub = dict(self.state, seq_lens=dev["lens"])
        if tables:
            sub["block_table"] = dev["bt"]
        slots = dev["slots"].long()
        slot_keys = [k for k in _SLOT_KEYS if k in self.state]
        self.dispatches += 1
        self.steps["wave"] += 1
        with self.tracer.span("dispatch:prefill", cat="device",
                              args={"batch": B, "maxlen": maxlen}), \
                self._label("prefill"):
            logits, sub = T.prefill(self.cfg, self.params, sub,
                                    {"tokens": dev["toks"],
                                     "ctx_lens": dev["lens"]}, self.rt)
        self._keep({k: sub[k] for k in _POOL_KEYS if k in sub})
        for k in slot_keys:
            self.state[k].index_copy_(1, slots, sub[k])
        return logits

    @torch.no_grad()
    def prefill_chunk(self, seq, start: int, length: int) -> torch.Tensor:
        """One prefill chunk of one sequence on its own; returns the
        last-live-token logits [1, V] on the device."""
        arrays = self._chunk_arrays(seq.req.prompt, seq.block_ids, start,
                                    length)
        graph = self._stage("chunk", arrays) if self.capture_graphs \
            else None
        dev = None if graph is not None else self._upload(**arrays)
        self.dispatches += 1
        self.steps["chunk"] += 1
        with self.tracer.span("dispatch:chunk", cat="device",
                              args={"start": start, "length": length}), \
                self._label("prefill_chunk"):
            if graph is not None:
                return graph.run(())
            logits, cache = T.prefill_chunk(
                self.cfg, self.params, cache_from_state(self.state),
                dev["c_toks"], dev["c_bt"], dev["c_off"], dev["c_tl"],
                self.rt)
        self._keep(cache_to_state(cache))
        return logits

    # ------------------------------------------------------------ steps
    def _unified(self, name: str, prev_out: Optional[torch.Tensor],
                 extra: dict, tokens: np.ndarray,
                 sampling: Dict[str, np.ndarray], active: np.ndarray,
                 chunk_prompt: Seq[int], block_ids: Seq[int], start: int,
                 length: int) -> torch.Tensor:
        arrays = dict(toks=np.asarray(tokens, np.int32),
                      active=np.asarray(active, bool), **extra,
                      **self._sampling_arrays(sampling),
                      **self._chunk_arrays(chunk_prompt, block_ids, start,
                                           length))
        kind = "chained" if extra else "unified"
        graph = self._stage(kind, arrays) if self.capture_graphs else None
        if graph is not None and extra:
            graph.buffers["prev"].copy_(
                self.zero_prev if prev_out is None else prev_out)
        dev = None if graph is not None else self._upload(**arrays)
        self.dispatches += 1
        self.steps["decode"] += 1
        self.steps["chunk"] += 1
        span = "dispatch:unified_chained" if extra else "dispatch:unified"
        with self.tracer.span(span, cat="device",
                              args={"start": start, "length": length}), \
                self._label(name):
            if graph is not None:
                return graph.run(self._variant(sampling))
            sp = self._sampling(sampling, dev)
            chunk = (dev["c_toks"], dev["c_bt"], dev["c_off"], dev["c_tl"])
            if prev_out is None and not extra:
                out, state = T.unified_step(
                    self.cfg, self.params, self.state, dev["toks"], sp,
                    dev["active"], *chunk, self.rt)
            else:
                out, state = T.unified_step_chained(
                    self.cfg, self.params, self.state,
                    self.zero_prev if prev_out is None else prev_out,
                    dev["chain_idx"], dev["use_prev"], dev["toks"], sp,
                    dev["active"], *chunk, self.rt)
        self._keep(state)
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
            logits, state = T.decode_step(self.cfg, self.params,
                                          self.state, dev["toks"], self.rt)
        self._keep(state)
        return logits

    @torch.no_grad()
    def megastep(self, tokens: np.ndarray, sampling: Dict[str, np.ndarray],
                 active: np.ndarray, n_steps: int) -> np.ndarray:
        """One fused horizon; returns the [n_steps, max_slots] token
        buffer as numpy (the one host sync of the dispatch).  With graphs
        on, one captured decode-plus-sample step replays ``n_steps``
        times: it advances its own step index, which picks its row of the
        token buffer and its stream position, so one graph serves every
        horizon (the reference's ``lax.fori_loop``)."""
        n_steps = int(n_steps)
        if not 0 < n_steps <= self.max_horizon:
            raise ValueError(f"megastep of {n_steps} steps: the horizon is "
                             f"1..{self.max_horizon}")
        arrays = dict(toks=np.asarray(tokens, np.int32),
                      active=np.asarray(active, bool),
                      **self._sampling_arrays(sampling))
        if self.capture_graphs:
            graph = self._stage("megastep", dict(arrays, step=np.int32(0)))
        else:
            dev = self._upload(**arrays)
        self.dispatches += 1
        self.steps["decode"] += n_steps
        with self.tracer.span("dispatch:megastep", cat="device",
                              args={"n_steps": n_steps}), \
                self._label("megastep"):
            if self.capture_graphs:
                key = self._variant(sampling)
                for _ in range(n_steps):
                    graph.run(key)
                return self._readback(graph.buffers["out"][:n_steps])
            out, state = T.decode_megastep(
                self.cfg, self.params, self.state, dev["toks"],
                self._sampling(sampling, dev), dev["active"], n_steps,
                max_horizon=self.max_horizon, rt=self.rt)
            self._keep(state)
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

    def prefill_compiles(self) -> float:
        """Captures of the step graphs that run prefill work (the unified
        step, its chained variant, the standalone chunk), the most of any
        one kind, released graphs included: the counterpart of the
        reference's compile count of that executable, 1 for a healthy
        fixed-shape run.  NaN where no graph runs prefill: graphs off, or
        whole-prompt waves (eager here; one executable per shape in the
        reference)."""
        if not self.capture_graphs or self.chunk_tokens is None:
            return float("nan")
        kinds = ("unified", "chained", "chunk")
        return float(max(
            [self._closed_captures.get(k, 0)
             + (self.graphs[k].captures if k in self.graphs else 0)
             for k in kinds]))

    def kv_bytes_per_token(self) -> float:
        """KV bytes per cached token position, across all layers (scales
        amortized over the block)."""
        bs = self.cfg.paging.block_size
        return self.kv_pool_bytes() / float(self.num_blocks * bs)
