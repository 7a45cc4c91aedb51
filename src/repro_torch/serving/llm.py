"""``LLM`` — one-line construction of a (quantized) serving stack::

    from repro_torch.serving import LLM, SamplingParams

    llm = LLM.load("qwen2-1.5b", quant="rtn-int4", seed=0)   # on the card
    outs = llm.generate(prompts, SamplingParams(max_tokens=32))

    # GPTQ (Hessian OBQ) over calibration tokens, on the card:
    llm = LLM.load("qwen2-1.5b", quant="gptq-int4", seed=0,
                   calib_batches=[{"tokens": toks}, ...])

    # int8 paged KV (half the pool bytes of bf16) and/or whole-prompt
    # prefill waves instead of chunked prefill:
    llm = LLM.load("qwen2-1.5b", quant="rtn-int4", kv_cache_dtype="int8",
                   enable_chunked_prefill=False)

    # the MoE decoder (60 routed experts, top-4, plus shared ones), with
    # bf16 weights as the reference serves it
    llm = LLM.load("qwen2-moe-a2.7b", seed=0)

    # weights from a checkpoint directory the JAX package's Checkpointer
    # wrote (the latest step_*), quantized after the restore
    llm = LLM.load("qwen2-1.5b", checkpoint="ckpt/", quant="rtn-int4")

    # the sliding-window decoder: each sequence a private ring of
    # max_blocks_per_seq blocks (512 x 16 = its 8192 window), served by
    # whole-prompt waves (it cannot chunk) over a bf16 ring
    llm = LLM.load("h2o-danube-3-4b", quant="rtn-int4", max_slots=8,
                   max_blocks_per_seq=512, num_blocks=4137)

The engine runs the reference's default mode: the async pipelined step,
telemetry and the non-finite guard on (``enable_async_step=False`` reads
back every step; see ``ServingEngine`` for every argument).

Prompts are token-id lists (the repo has no tokenizer).  Without a
``checkpoint``, ``load`` serves random weights made from ``seed``;
``LLM(cfg, params, ...)`` serves any params in the JAX layout (for
example bridged from the JAX package with ``bridge.params_from_numpy``).
"""
from __future__ import annotations

import time
from typing import Callable, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.reader import restore_params
from repro_torch.configs.base import ModelConfig, QuantConfig
from repro_torch.configs.registry import get_config, get_reduced
from repro_torch.models import transformer as T
from repro_torch.models.quantize import (gptq_quantize_model,
                                         quantize_params_rtn,
                                         require_gptq_family,
                                         require_rtn_family)
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.params import RequestOutput, SamplingParams

QUANT_MODES = (None, "rtn-int4", "gptq-int4")

Prompt = Sequence[int]


def _synthetic_calib(cfg: ModelConfig, seed: int, n_batches: int = 2,
                     batch: int = 2, seq: int = 32) -> List[dict]:
    """Random-token calibration batches for GPTQ when none are supplied
    (good enough for smoke-scale models; pass real data for quality).
    Drawn on the CPU from a ``torch.Generator`` seeded with ``seed``, so a
    load on the card calibrates on the tokens a CPU load does; not
    bit-equal to the JAX package's ``jax.random`` draw."""
    gen = torch.Generator().manual_seed(seed)
    return [{"tokens": torch.randint(0, cfg.vocab_size, (batch, seq),
                                     generator=gen)}
            for _ in range(n_batches)]


class LLM:
    """Facade owning a config, (possibly quantized) params and an engine."""

    def __init__(self, cfg, params, *,
                 detokenizer: Optional[Callable[[List[int]], str]] = None,
                 device="cuda", **engine_kw):
        self.cfg = cfg
        self.engine = ServingEngine(cfg, params, detokenizer=detokenizer,
                                    device=device, **engine_kw)
        self.params = self.engine.runner.params
        self.load_s: dict = {}     # seconds per step, filled by ``load``

    @classmethod
    def load(cls, config_name: str, *, quant: Optional[str] = None,
             kv_cache_dtype: str = "bf16",
             checkpoint: Optional[str] = None, reduced: bool = False,
             overrides: Optional[dict] = None, seed: int = 0,
             quant_group_size: int = 32,
             calib_batches: Optional[list] = None, device="cuda",
             capture_graphs: bool = True, **engine_kw) -> "LLM":
        """Build a ready-to-serve ``LLM`` from a registry config name.

        quant: None | "rtn-int4" (round-to-nearest int4 of every matmul
        weight) | "gptq-int4" (Hessian OBQ over ``calib_batches``, a list
        of {"tokens": [B, S]} tensors or numpy arrays; synthetic tokens
        from ``seed`` when None), either done in torch on ``device``.
        kv_cache_dtype: "bf16" (the pool holds the activation dtype) or
        "int8" (int8 values plus one f32 scale per block and KV head).
        MoE configs serve with ``quant=None`` only: the reference refuses
        ``gptq-int4`` for them and cannot serve its ``rtn-int4`` (ROADMAP
        C8), so both raise ``ValueError`` before anything is loaded; the
        hybrid and Mamba families take ``rtn-int4`` and refuse
        ``gptq-int4``, as the reference.  A seeded ``rtn-int4`` load
        quantizes each layer as it is drawn (``load_s["init"]`` covers
        both).
        reduced: the tiny same-family CPU config.  overrides:
        ``ModelConfig.replace`` fields applied after config resolution.
        checkpoint: a directory the JAX package's ``Checkpointer`` wrote;
        its latest step's ``params`` replace the seeded init (each leaf
        checked against the config's shapes), and quantization runs
        after the restore, as in the reference.
        capture_graphs: run the fixed-shape serving steps as captured
        CUDA graphs (on the CPU: the same static-buffer bookkeeping);
        False runs every step one op at a time, the counterpart of
        ``jax.disable_jit``.
        engine_kw: forwarded to ``ServingEngine``, every argument of the
        reference's engine (max_slots, num_blocks, max_blocks_per_seq,
        max_num_batched_tokens, max_horizon, enable_chunked_prefill,
        enable_unified_step, enable_async_step, use_fused,
        prefill_bucket, rt; robustness: max_waiting, shed_policy,
        enable_guards, fault_injector, max_dispatch_retries,
        retry_backoff_s; observability: enable_telemetry, trace_capacity,
        profile_labels).  The returned ``LLM``'s ``load_s`` holds the
        seconds of each step of the load.
        """
        if quant not in QUANT_MODES:
            raise ValueError(f"unknown quant mode {quant!r}; "
                             f"expected one of {QUANT_MODES}")
        dev = resolve_device(device)
        cfg = (get_reduced(config_name, **(overrides or {})) if reduced
               else get_config(config_name))
        if overrides and not reduced:
            cfg = cfg.replace(**overrides)
        T.require_decoder(cfg)       # an encoder has no engine to serve it
        if quant == "rtn-int4":
            require_rtn_family(cfg)
        elif quant == "gptq-int4":
            require_gptq_family(cfg)
        t0 = time.perf_counter()
        rtn_as_drawn = quant == "rtn-int4" and checkpoint is None
        # what is served cast to the activation dtype is stored so from the
        # start: unquantized weights (a bf16 qwen2-moe peaks near its 28.6
        # GB) and, in a seeded rtn-int4 load, whatever each layer's
        # quantization leaves dense, and the embedding (command-r's tied
        # one: 6.29 GB in bf16, 12.58 in f32); GPTQ calibrates and a
        # restored tree is quantized on f32 weights
        dtype = T.act_dtype(cfg) if quant is None or rtn_as_drawn else None
        if checkpoint is not None:
            params = restore_params(checkpoint,
                                    T.init_params(cfg, device="meta"), dev,
                                    dtype)
        else:
            # rtn-int4 quantizes each layer as it is drawn (the same codes
            # as the whole tree's): the load never holds the f32 tree
            # (falcon-mamba-7b: 28 GB); a restored tree is quantized a
            # layer at a time after the restore
            params = T.init_params(
                cfg, seed, dev, dtype=dtype,
                layer_fn=(lambda layer: quantize_params_rtn(
                    layer, cfg, group_size=quant_group_size))
                if rtn_as_drawn else None)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        load_s = {"restore" if checkpoint is not None else "init":
                  time.perf_counter() - t0}
        if quant == "rtn-int4" and not rtn_as_drawn:
            params = quantize_params_rtn(params, cfg,
                                         group_size=quant_group_size)
        elif quant == "gptq-int4":
            calib = calib_batches or _synthetic_calib(cfg, seed)
            params = gptq_quantize_model(
                cfg, params, calib,
                QuantConfig(bits=4, group_size=quant_group_size),
                timings=load_s)
        llm = cls(cfg, params, seed=seed, kv_cache_dtype=kv_cache_dtype,
                  device=dev, capture_graphs=capture_graphs, **engine_kw)
        llm.load_s = load_s
        return llm

    # ------------------------------------------------------------ serving
    @staticmethod
    def _as_prompt_list(prompts) -> List[List[int]]:
        if prompts and isinstance(prompts[0], (int, np.integer)):
            return [[int(t) for t in prompts]]          # a single prompt
        return [[int(t) for t in p] for p in prompts]

    def _submit(self, prompts, sampling_params) -> List[int]:
        plist = self._as_prompt_list(prompts)
        if sampling_params is None or isinstance(sampling_params,
                                                 SamplingParams):
            sps = [sampling_params] * len(plist)
        else:
            sps = list(sampling_params)
            if len(sps) != len(plist):
                raise ValueError(f"{len(plist)} prompts but "
                                 f"{len(sps)} sampling params")
        return [self.engine.add(p, sp) for p, sp in zip(plist, sps)]

    def generate(self, prompts: Union[Prompt, Sequence[Prompt]],
                 sampling_params: Union[SamplingParams,
                                        Sequence[SamplingParams],
                                        None] = None
                 ) -> List[RequestOutput]:
        """Run all prompts to completion; one finished ``RequestOutput``
        per prompt, in submission order."""
        rids = self._submit(prompts, sampling_params)
        final = {}
        for out in self.engine.stream():
            if out.finished:
                final[out.request_id] = out
        missing = [r for r in rids if r not in final]
        if missing:
            raise RuntimeError(f"requests {missing} did not finish "
                               f"(engine stalled?)")
        return [final[r] for r in rids]

    def stream(self, prompts: Union[Prompt, Sequence[Prompt]],
               sampling_params: Union[SamplingParams,
                                      Sequence[SamplingParams],
                                      None] = None
               ) -> Iterator[RequestOutput]:
        """Submit prompts and yield ``RequestOutput`` deltas as steps
        complete."""
        self._submit(prompts, sampling_params)
        yield from self.engine.stream()

    def abort(self, request_id: int) -> bool:
        return self.engine.abort(request_id)

    def close(self) -> None:
        self.engine.close()

    def __enter__(self) -> "LLM":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
