#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails loudly (any failure exits non-zero):

1. build   — compile the hand-written kernels (``csrc/*.cu``, nvcc for
             sm_90a, one process per source), print the build time, and
             count the tensor-core instructions (HMMA / HGMMA) that
             ``cuobjdump --dump-sass`` shows in every instantiation of the
             bf16 paged decode, chunk prefill, static attention and int4
             matmul kernels (none is a failure; the static attention's
             five must each show HGMMA, wgmma), and ptxas's registers and
             spills of the static attention's five (a spill is a
             failure);
2. kernels — run each kernel at the serving shapes of full-width
             qwen2-1.5b in bf16 (int8 pools where the kernel reads them)
             against its plain torch version on the card, print its time
             beside the plain version's, the library call's where one
             computes the same function, and its bound (bytes over
             3.35 TB/s or flops over 989 TFLOP/s): the paged decode
             kernels also with a sliding window, ALiBi and sequences that
             end inside a split, the chunk kernels also with a window,
             ALiBi and a prefix to the end of the block table (and their
             2- and 4-warp grids timed at the serve's chunks), the static
             attention also at a ragged 333 tokens and head dim 64,
             ``gptq_matmul`` at every M of GPTQ_MS for each linear; every
             case of these five is called twice and the two outputs must
             be bitwise equal;
   sampling — ``core.sampling``'s threefry stream on the card against the
             CPU over 9 rows of the full vocabulary: the uniforms bitwise
             equal, and ``sample_from_logits`` on the same logits (greedy,
             temperature 0.8, top-k 20, top-p 0.9 rows mixed) the same
             tokens; the legacy single-key ``serving.sampler``'s
             ``sample_device`` on [8, vocab] bf16 logits (greedy and
             sampled rows, top-k 0 and 40) the same tokens;
3. model   — full-width qwen2-1.5b cut to 2 layers, int4 weights, bf16
             and int8 pools: the same params and inputs through the decode
             step, the prefill chunk, the unified step and the
             whole-prompt ``T.prefill`` on the card and on the CPU (where
             the port takes the plain versions), logits compared at a
             stated bf16 tolerance;
4. serve   — ``LLM.load("qwen2-1.5b", quant="rtn-int4", seed=0, ...)`` at
             full depth serves 8 greedy requests (20 to ~900 prompt tokens,
             two sharing a 64-token prefix, up to 32 new tokens each)
             four times: on the synchronous engine (``SYNC``) chunked
             prefill over the bf16 pool, chunked prefill over the int8
             pool (``kv_cache_dtype="int8"``) and whole-prompt prefill
             waves over the bf16 pool (``enable_chunked_prefill=False``);
             then ``bf16-chunked-async``, the engine's defaults (async
             pipelined step, telemetry and guards on) on the bf16-chunked
             traffic.  The kernels' launch counters are zeroed just before
             each serve and read just after: every request finishes, every
             token is in vocabulary, each serve launched exactly its own
             kernels (the attention kernels 28 times the runner's own
             count of decode steps, chunks and waves, and the synchronous
             ones exactly ATTENTION_LAUNCHES times), the allocator audit is
             clean; TTFT and inter-token percentiles come from the
             engine's histograms, host and device ms per step from
             ``attribution()``.  Each serve is re-run under
             ``torch.profiler`` (device busy time and idle share, copies
             from or to pageable host memory); the int8 chunked serve may
             not copy from the device to the host more often per step than
             the bf16 one; the async serve must give bf16-chunked's tokens,
             take pipelined steps and make no pageable copy.  Every serve
             of phases 4 to 7 runs the runner's step graphs (the
             defaults): each variant captured once, none in the re-run,
             the graph kinds of its mode run; over a profiled serve of
             two requests the profiler's kernel records must count each
             kernel's launches as its wrapper's counter does (a replay
             adds what its capture recorded), and the host's launch calls
             per step are counted in the re-run; then the same
             traffic is served by a second engine over the same weights
             with ``capture_graphs=False`` and must give the same tokens
             (phases 4 and 6 do not re-run that serve under the profiler:
             no check reads its profile; the later phases do).
             ``bf16-chunked-async``'s graphs-off serve runs under
             ``torch.cuda.set_sync_debug_mode("warn")`` (R1's twin, no
             phase of its own): each sync torch warns of must lie in a
             function where the static checker's R1 reports a finding,
             and a control sync R1 reports must be recorded;
5. gptq    — (b) ``LLM.load("qwen2-1.5b", quant="gptq-int4")`` at full
             depth on 8 x [4, 512] seeded calibration tokens, the load's
             seconds split (init, calibration forward plus Hessians, OBQ,
             pack), exactly 224 static ``flash_attention`` launches and no
             other, every served leaf on the card, and GPTQ's
             Hessian-weighted proxy loss summed over the 56 (layer,
             Hessian) pairs below RTN's, layer 0's two Hessians within
             HESSIAN_TOL_REL of a float64 CPU replay of the same tokens;
             (a) one full-width w_gate through
             the port's OBQ on the card and on the CPU (codes equal in at
             least 99.99% of entries, scales and zeros bitwise, proxy loss
             within 1e-6); (c) the 2-layer full-width GPTQ model's
             ``T.forward`` logits on the card within LOGIT_TOL of the
             CPU's, and its mean logit error against the dense model
             below 1.25 x RTN's; (d) one full-width qwen1.5-0.5b MHA layer
             converted to 4 KV heads on the card and on the CPU (same
             groups, merged K/V within 2e-2); then a fourth serve,
             ``gptq-chunked``: the bf16-chunked traffic on the GPTQ-loaded
             model, with the bf16-chunked serve's launches, profiled.
6. moe     — qwen2-moe-a2.7b (60 routed experts, top-4, 4 shared; 16
             query heads over 16 KV heads, G = 1): the paged decode
             kernels (bf16 and int8 pools) and the chunk kernels (both
             branches) in every case of PAGED_CASES / CHUNK_CASES at its
             heads, as in phase 2; one full-width layer's ``moe_apply``
             (``torch._grouped_mm`` over the sorted assignments) at 8 and
             256 rows against ``moe_apply_dense_ref`` within TOL of the
             largest entry, bitwise repeatable, timed beside the bound of
             the experts it touches; the full-width model cut to 1 layer
             (MOE_MODEL_LAYERS) in f32 card vs CPU (as phase 3, within
             MOE_LOGIT_TOL); then
             three full-depth serves of ``LLM.load("qwen2-moe-a2.7b",
             seed=0, ...)`` with bf16 weights on serve_prompts' traffic:
             ``moe-chunked-async`` (the defaults), ``moe-chunked``
             (``SYNC``) and ``moe-int8-chunked``, each launching only its
             own attention kernels, 24 times the runner's decode steps
             and chunks, with its load seconds and peak
             ``torch.cuda.max_memory_allocated``, profiled; the async
             serve must give moe-chunked's tokens with no pageable copy.
             Last, the checkpoint reader: full-width qwen2-1.5b cut to 2
             layers written in the JAX package's checkpoint layout
             (``write_checkpoint``) and served through
             ``LLM.load(checkpoint=...)``, token-exact against the same
             params in memory.
7. sliding — h2o-danube-3-4b (every layer a sliding window of 8192 over a
             private ring cache; 32 query heads over 8 KV heads, head dim
             120): the static kernel at head dim 120 on the serve's wave
             [8, 8192] (causal inside the window) and on a band case with
             Sk 10240 > window 8192, each against its plain version run
             one (sequence, KV head) group at a time, bitwise repeatable;
             ``gptq_matmul`` at danube's linears (N = 960 included) at
             decode and at the wave's 65,536 rows; the full-width model
             cut to 2 layers in f32 over 64-slot rings card vs CPU (a
             prompt of 100 wraps at prefill, 40 decode steps); then
             full-depth ``LLM.load("h2o-danube-3-4b", quant="rtn-int4")``
             with 8 rings of 512 blocks serves serve_prompts' traffic with
             the 900-token prompt replaced by one of 8,180 tokens asking
             for 40 (its ring wraps after 12), on the engine's defaults
             (a ring stack cannot chunk, so they run synchronous
             whole-prompt waves: checked), profiled: one wave,
             ``flash_attention`` 24 times the waves, no decode kernel (the
             ring decode is plain torch), 0 pageable copies; every served
             token against teacher forcing (``T.forward``): agreement and
             logit gap; one full ring decode step and one layer's ring
             attention timed.  The static kernel's cases here, in phase
             2 and in phase 8 are also held per query row to
             FLASH_REL_TOL of the row's own RMS.
   (b)     — the same model, full width and full depth, through
             ``LLM.load("h2o-danube-3-4b", quant="gptq-int4")`` on 8 x
             [4, 512] seeded calibration tokens over the same 8 rings:
             the calibration, OBQ and pack seconds and the peak memory,
             exactly 24 x 8 static ``flash_attention`` launches at head
             dim 120 and no other; GPTQ's Hessian loss summed over the 48
             (layer, Hessian) pairs below RTN's (each pair's ratio
             printed), layer 0's Hessians within HESSIAN_TOL_REL of a
             float64 CPU replay, layer 0's wk [3840, 960] through OBQ on
             the card and on the CPU (at least 99.99% of codes equal,
             scales and zeros bitwise); then the same traffic served
             with graphs on, profiled: 0 pageable copies,
             ``gptq_matmul`` once a linear, layer and step
             (``check_gptq_serve_launches``), every served token against
             teacher forcing.
8. hybrid  — recurrentgemma-2b (18 RG-LRU layers with per-slot recurrent
             state, 8 sliding-window layers over private rings; 10 query
             heads over 1 KV head, head dim 256): the static kernel's
             D = 256 instantiation (HGMMA in its SASS, ptxas's registers
             and spills) on the serve's wave [8, 2048] causal inside the
             2048 window, a band case Sk 2560 > window, a ragged 333 and
             a window at a q_offset, against the plain version one
             group at a time, bitwise repeatable, timed beside SDPA and
             its bound; ``gptq_matmul`` at its linears at decode and at
             the wave's 16,384 rows; the full-width model cut to 6 layers
             (4 RG-LRU, 2 sliding) card vs CPU in f32 (dense) and bf16
             (rtn-int4): logits, ``lru_h`` after the wave and at the end,
             pools; then full-depth ``LLM.load("recurrentgemma-2b",
             quant="rtn-int4")`` with 8 rings of 128 blocks serves
             serve_prompts' traffic with the 900-token prompt replaced by
             one of 2,040 tokens asking for 40 (its ring wraps after 8),
             graphs on and off, profiled: ``flash_attention`` 8 times a
             wave, 0 pageable copies, every served token against teacher
             forcing, ``linear_scan`` 18 times a wave and a decode step;
             one wave's device time split between ``gptq_matmul``, the
             static kernel, the time scan and the rest.
9. ssm     — falcon-mamba-7b (64 Mamba-1 layers, din 8192, state 16; no
             attention, no paged pool): the time-scan kernel
             (``csrc/time_scan.cu``) against its plain versions on the
             card, each output within SCAN_REL_TOL of its RMS, bitwise
             repeatable: ``selective_scan`` (the scan alone) on the
             serve's wave, on a [8, 1024] wave with ragged masked rows
             and on a decode step; its fused entry (``ops.ssm_scan``:
             softplus, scan, D skip and gate in one launch) on inputs
             made by the model's projections from falcon-mamba's init at
             the serve's wave, the ragged wave from a random state,
             decode, a single [1, 4096] prompt with a unit B and C, and
             in f32 (also on a memory-carrying init), gated y within
             FUSED_Y_TOL of its largest |y| (bf16) or SCAN_REL_TOL of
             its RMS (f32), the scan's share of y at least
             SCAN_SHARE_MIN limits where the state carries into y, each
             timed beside the unfused path, its byte bound and its
             exponentials' MUFU time, ptxas's registers and spills
             printed; ``linear_scan``
             on recurrentgemma's [8, 2048] wave (and whether it gives the
             addcmul loop's bits); ``gptq_matmul`` at in_proj / out_proj
             at decode and at the wave's 7,680 rows; the full-width model
             cut to 2 layers card vs CPU in f32 (dense) and bf16
             (rtn-int4): logits, ``ssm_h`` and ``ssm_conv``; then
             full-depth ``LLM.load("falcon-mamba-7b", quant="rtn-int4")``
             (each layer quantized as it is drawn) serves serve_prompts'
             traffic on the engine's defaults (whole-prompt waves,
             synchronous: checked), graphs on and off, profiled:
             ``selective_scan`` 64 times a wave and a decode step, no
             attention kernel, 0 pageable copies, every served token
             against teacher forcing; one wave's device time split.
10. vlm    — llava-next-mistral-7b (a dense GQA decoder, 32 query heads
             over 8 KV heads, behind 2,880 patch embeddings): the decode
             and chunk kernels at its G = 4 in every case of PAGED_CASES
             / CHUNK_CASES, the static kernel at the vision wave's shape
             [4, 3080] causal, ``gptq_matmul`` at its linears (K 14,336
             for w_down) at decode and at the wave's 12,320 rows; the
             full-width model cut to 1 layer card vs CPU with the prefix
             in f32 (dense) and bf16 (rtn-int4): ``T.prefill`` (seq_lens
             prefix + text) and 3 decode steps, greedy agreement, and
             other patch embeddings moving the logits (the control); then
             full-depth ``LLM.load("llava-next-mistral-7b",
             quant="rtn-int4")`` serves serve_prompts' text traffic on
             the engine's defaults (``llava-defaults``: chunked, async,
             graphs on and off, profiled, 0 pageable copies), and
             ``vision_wave`` runs four requests of 2,880 patches plus 20
             to 200 text tokens through one ``T.prefill`` and 16
             ``T.decode_step``s over a private table, launches counted
             per wave and step, every token held to teacher forcing
             (``T.forward`` over prefix, text and served tokens); the
             wave's device time split.
11. audio  — hubert-xlarge (an encoder: layernorm, non-causal ALiBi, 16
             query heads over 16 KV heads at head dim 80, 504 frame
             labels; no decode): the static kernel's D = 80 instantiation
             (HGMMA in its SASS, ptxas's registers and spills) on frames
             [8, 1500] not causal with ALiBi, causal, and not causal
             without ALiBi, timed beside SDPA with the same additive
             bias; ``gptq_matmul`` at its linears at 12,000 rows; the
             full-width encoder cut to 2 layers card vs CPU in f32 and
             bf16 (rtn-int4); then the full-depth rtn-int4 bf16
             ``T.forward`` on [8, 1500] frames: finite logits, 48 static
             launches each not causal with ALiBi at head dim 80,
             ``gptq_matmul`` as its plans give, device ms, frames per
             second, peak memory and time split, held to the f32 forward
             of the same int4 weights.
12. cmdr   — command-r-plus-104b (64 layers, d 12,288, 96 query heads
             over 8 KV heads: G = 12, layernorm, a tied 256,000 x 12,288
             embedding; rtn-int4 at group size 128, 62.9 GB served): the
             decode and chunk kernels at G = 12 in every case of
             PAGED_CASES / CHUNK_CASES, each live row also within
             FLASH_REL_TOL of its RMS; ``gptq_matmul`` at group 128 at its
             linears at decode and at a chunk (w_down K 33,792); the
             full-width model cut to 2 layers card vs CPU with drawn
             norms, over bf16 and int8 pools (decode step, chunk, unified
             step) and through ``T.forward`` over 128 positions, logits
             within CMDR_LOGIT_REL_TOL of their largest, greedy agreement,
             a dropped-layernorm-bias control that must miss; then the
             full-depth ``LLM.load(..., quant_group_size=128)`` (seconds,
             peak) served on the engine's defaults (``cmdr-defaults``,
             graphs on and off, profiled, 0 pageable copies, attention 64
             x the runner's steps, ``gptq_matmul`` as its plans give) and
             one full decode step timed beside the bytes of the served
             tree over 3.35 TB/s.
13. cli    — ``repro_torch.launch.serve.main`` in process: full-depth
             qwen2-1.5b rtn-int4, 16 requests of 32 tokens, as Opt-GQA
             and with ``--mha-baseline``: every request finished, the
             paged decode, chunk and int4 kernels launched and no other
             attention kernel, ``--trace-out`` valid, ``--metrics-out``
             finite, the KV bytes a token 6.0 apart; then a short run
             under ``--profile-dir`` whose trace holds kernel records.
   (b)     — the port's examples (``examples/repro_torch/``), each
             ``main([..., "--device", "cuda"])`` in process on qwen2-1.5b
             at full width (4 layers; ``train_small`` 6 layers, 4 steps):
             each launches its kernels (``EXAMPLES``) and no other, its
             numbers checked (``check_example``), its seconds printed.
14. train  — the trainer on qwen2-1.5b at full width (f32 master weights,
             bf16 activations): (a) B5 under autograd
             (``FlashAttentionFn``: the kernel forward, the plain
             version's backward) at the trainer's [8, 512] and at a
             window, ALiBi, an offset and head dims 80, 120 and 256: one
             counted launch a forward, the output within TOL and each row
             within FLASH_REL_TOL of the plain version, dq / dk / dv
             bitwise the plain autograd, two calls bitwise equal, the
             forward and the backward timed beside their bounds (and at
             [8, 512] beside the plain version's and SDPA's); (b) the
             model cut to 2 layers, loss and every leaf's gradient card vs
             CPU within TRAIN_LOSS_REL and TRAIN_GRAD_RMS of the leaf's
             RMS, with attention's output detached as a control that must
             miss; (c) full depth through ``launch.train.main``: 8 steps
             of [8, 512] SyntheticLM batches and one save, exactly 56 B5
             launches a step and no other kernel of the port, finite
             losses, step ms, tokens/s, peak memory, the save's seconds
             and bytes (the directory removed after), then two steps on
             one batch under ``torch.profiler`` (device idle share, time
             by part; the loss descends) and AdamW's update timed beside
             its bound; (d) the model cut to 2 layers through the
             ``Supervisor``: a failure injected before step 3, restored
             from step 2, held to the uninterrupted run's losses; (e)
             every serving-only kernel raises under autograd instead of
             returning an output without a gradient; (f) the MoE, hybrid
             and Mamba families: the time scans' backward kernels
             (``linear_scan_bwd``; ``selective_scan_bwd``, the scan alone
             from the forward's checkpoints and the fused core's, bf16 and
             f32, its recomputed states bitwise the forward's) against
             their plain versions, each family cut to 2 or 3 layers card
             vs CPU with a control, and each at depth through
             ``launch.train.main`` (falcon-mamba's with the plain core
             composition refused on the card).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Details also go to
``chiprun_out/chip_smoke.json``.  Without a card it exits non-zero and
prints no result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12        # dense bf16 tensor-core peak
TOL = 2e-2                       # bf16 kernel tolerance (tests/test_kernels.py)
LOGIT_TOL = 0.1                  # bf16 end-to-end logits, card vs CPU
# static attention: each query row's error over its own RMS (row_rel_err).
# chip_faults.py on an H100 80GB HBM3 at 700 W: the sound kernel reads
# 0.026-0.036 in every case (the wgmma body 0.026-0.035); a band that
# skips its first key tile or leaves its edge tiles unmasked reads
# 1.65-5.8 (2.2-29.9) in every windowed case
FLASH_REL_TOL = 0.1
SPIN_CYCLES = 2_000_000          # ~1 ms of device clock before each timing

H, KV, D, BS, NB, MB, B, W = 12, 2, 128, 16, 512, 64, 8, 256
LINEARS = {"wq/wo": (1536, 1536), "wk/wv": (1536, 256),
           "gate/up": (1536, 8960), "down": (8960, 1536)}
GS = 32


_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def log_time(phase: str) -> None:
    log(f"[time] {phase} done at {time.perf_counter() - _T0:.1f} s")


def bound_ms(nbytes: float, flops: float):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / BF16_FLOPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def time_ms(fn, iters: int = 10) -> float:
    """Mean device time of ``fn`` over ``iters`` runs, each timed with CUDA
    events and each preceded (outside the timed region) by a write of
    256 MB, so every run finds the 50 MB L2 cold as the serving path does
    (a layer's weights and pages are not re-read before 27 other
    layers'), then by a ~1 ms spin on the device, so the host has queued
    all of ``fn``'s launches before the device reaches the start event:
    the time is the kernels', without the host's launch overhead, which
    is larger than a 10-50 us kernel and varies with the host's load."""
    import torch
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / iters


# The bf16 kernels that must run on the tensor cores: library -> function.
TENSOR_CORE_KERNELS = {"flash_attention": "flash_attention_mma_kernel",
                       "gptq_matmul": "gptq_wgmma_kernel",
                       "paged_attention": "paged_attention_mma_kernel",
                       "flash_attention_chunk": "chunk_attention_mma_kernel"}
# ... and those whose every instantiation must run on wgmma (HGMMA), not
# merely on mma.sync (HMMA)
WGMMA_KERNELS = {"flash_attention": "flash_attention_mma_kernel",
                 "gptq_matmul": "gptq_wgmma_kernel"}
# the static kernel's bf16 instantiations, as cuobjdump and ptxas name
# them: (head dim, narrow block) -> name
FLASH_MMA_KERNELS = {
    (d, small): f"flash_attention_mma_kernelILi{d}ELb{small}E"
    for d in (64, 80, 120, 128, 256) for small in (0, 1)}
# the int4 matmul's wgmma instantiations: token tile -> name
GPTQ_WGMMA_KERNELS = {nt: f"gptq_wgmma_kernelILi{nt}E"
                      for nt in (8, 16, 32, 64, 128, 256)}


def tensor_core_sass(build) -> dict:
    """Count the tensor-core instructions that ``cuobjdump --dump-sass``
    shows in every instantiation of each kernel of TENSOR_CORE_KERNELS in
    the built libraries: {name: {"HMMA": n, "HGMMA": n}}.  Fails if a
    kernel is missing, one of its instantiations has neither, or one of
    WGMMA_KERNELS has no HGMMA."""
    cuobjdump = str(Path(build.nvcc()).with_name("cuobjdump"))
    counts = {}
    for lib, fn in TENSOR_CORE_KERNELS.items():
        path = build.BUILD_ROOT / build.sources_hash() / f"lib{lib}.so"
        sass = subprocess.run([cuobjdump, "--dump-sass", str(path)],
                              capture_output=True, text=True, timeout=300)
        if sass.returncode != 0:
            raise RuntimeError(f"cuobjdump failed on {path}: {sass.stderr}")
        name = None
        for line in sass.stdout.splitlines():
            if "Function :" in line:
                name = line.split("Function :", 1)[1].strip()
                if fn in name:
                    counts[name] = {"HMMA": 0, "HGMMA": 0}
            elif name in counts:
                for op in ("HGMMA", "HMMA"):
                    if op in line:
                        counts[name][op] += 1
        mine = {n: c for n, c in counts.items() if fn in n}
        if not mine or not all(sum(c.values()) for c in mine.values()):
            raise AssertionError(f"{fn}: no HMMA/HGMMA in {path}: {mine}")
        if lib in WGMMA_KERNELS and not all(c["HGMMA"]
                                            for c in mine.values()):
            raise AssertionError(f"{fn}: an instantiation without HGMMA "
                                 f"(wgmma) in {path}: {mine}")
    return counts


def _ptxas_clean(build, lib: str, names: dict, label: str) -> dict:
    """ptxas's registers and spills of each instantiation in ``names``
    ({key: mangled-name fragment}) of ``lib``'s kernels (from
    ``build_all(verbose=True)``'s log); fails if one spills or ptxas
    serialised a wgmma of ``lib`` (C7510-C7520: "wgmma.mma_async
    instructions are serialized").  {} when the libraries came from an
    earlier build (no log)."""
    log = build.LOGS.get(lib, "")
    if not log:
        return {}
    usage = {key: ptxas_usage(log, fn) for key, fn in names.items()}
    spilled = {k: u for k, u in usage.items()
               if not u or u["spill_store_bytes"] or u["spill_load_bytes"]}
    if spilled:
        raise AssertionError(f"{label} spills (or has no ptxas report): "
                             f"{spilled}")
    serial = [line for line in log.splitlines()
              if "wgmma.mma_async instructions are serialized" in line
              and any(fn in line for fn in names.values())]
    if serial:
        raise AssertionError(f"{label}: ptxas serialised wgmma: {serial}")
    return usage


def flash_ptxas(build) -> dict:
    """The static kernel's bf16 instantiations (five head dims, wide and
    narrow block) through ``_ptxas_clean``."""
    return _ptxas_clean(
        build, "flash_attention",
        {f"D={d}{' narrow' if small else ''}": fn
         for (d, small), fn in FLASH_MMA_KERNELS.items()},
        "flash_attention_mma_kernel")


def gptq_ptxas(build) -> dict:
    """The int4 matmul's wgmma instantiations (six token tiles) through
    ``_ptxas_clean``."""
    return _ptxas_clean(build, "gptq_matmul",
                        {f"NT={nt}": fn
                         for nt, fn in GPTQ_WGMMA_KERNELS.items()},
                        "gptq_wgmma_kernel")


# --------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

PAGED_SEQ_LENS = (0, 37, 64, 300, 512, 777, 901, 1024)
# (label, seq_lens, options): the first is timed; 0 (inactive) / partial
# page / page boundary / long / full table; then sequences that end inside
# a split of the walk (128 keys at the serving shape), a window that leaves
# whole splits outside it, and ALiBi
PAGED_CASES = (("seq_lens 0..1024", PAGED_SEQ_LENS, {}),
               ("ends mid-split", (1, 127, 129, 200, 383, 640, 1000, 1023),
                {}),
               ("sliding window 200", PAGED_SEQ_LENS,
                {"sliding_window": 200}),
               ("ALiBi", PAGED_SEQ_LENS, {"alibi": True}))


def _int8_pool(shape, gen):
    """Random K or V blocks [NB, BS, KV, D] quantized as the serving path
    writes them: int8 codes and [NB, KV] f32 scales."""
    import torch
    from repro_torch.core.kv_quant import quantize_blocks
    x = torch.randn(shape, generator=gen, device="cuda")
    return quantize_blocks(x, torch.ones(shape[:2], dtype=torch.bool,
                                         device="cuda"))


def _repeat_equal(name: str, label: str, call, out) -> None:
    """A second call on the same inputs must give the same bits (the split
    combine and every sum run in a fixed order)."""
    import torch
    if not torch.equal(call(), out):
        raise AssertionError(f"{name} {label}: two calls differ (not "
                             "deterministic)")


def check_paged_attention(gen, int8: bool = False, heads=(H, KV),
                          row_check: bool = False):
    """The decode kernel over the bf16 pool, or (``int8``) over the int8
    pool, in every case of PAGED_CASES at ``heads`` (query heads, KV
    heads): live rows within TOL of the plain version, seq_len-0 rows
    exactly 0, two calls bitwise equal; with ``row_check`` every live
    (sequence, head) row also within FLASH_REL_TOL of its own RMS
    (``row_rel_err``); each case timed beside its bound, the first also
    beside the plain version."""
    import torch
    H, KV = heads
    from repro_torch.core.alibi import alibi_slopes
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.paged_attention_quant import \
        paged_attention_quant
    dev = "cuda"
    q = torch.randn((B, H, D), generator=gen, device=dev).bfloat16()
    if int8:
        name, kernel, plain = ("paged_attention_quant", paged_attention_quant,
                               ref.paged_attention_quant_ref)
        kp, ks = _int8_pool((NB, BS, KV, D), gen)
        vp, vs = _int8_pool((NB, BS, KV, D), gen)
        pools = (kp, ks, vp, vs)
    else:
        name, kernel, plain = ("paged_attention", paged_attention,
                               ref.paged_attention_ref)
        pools = tuple(torch.randn((NB, BS, KV, D), generator=gen,
                                  device=dev).bfloat16() for _ in range(2))
    bt = torch.randperm(NB, generator=gen, device=dev)[:B * MB] \
        .reshape(B, MB).int()
    rows, worst = [], 0.0
    for label, lens, opt in PAGED_CASES:
        sl = torch.tensor(lens, dtype=torch.int32, device=dev)
        win = opt.get("sliding_window", 0)
        slopes = alibi_slopes(H, dev) if opt.get("alibi") else None
        args = (q, *pools, bt, sl, slopes)

        def call():
            return kernel(*args, sliding_window=win)
        out = call()
        want = plain(*args[:-1], alibi_slopes=slopes, sliding_window=win)
        torch.cuda.synchronize()
        live = sl > 0
        err = (out[live].float() - want[live].float()).abs().max().item()
        zero = out[~live].float().abs().max().item() if (~live).any() else 0.
        rel = row_rel_err(out[live], want[live]) if row_check else 0.0
        if not (err <= TOL and rel <= FLASH_REL_TOL) or zero != 0.0:
            raise AssertionError(f"{name} {label}: max err {err} (tol {TOL})"
                                 f", row err over RMS {rel} (limit "
                                 f"{FLASH_REL_TOL}), seq_len 0 rows max "
                                 f"{zero} (want 0)")
        _repeat_equal(name, label, call, out)
        worst = max(worst, err)
        seen = [min(n, win) if win else n for n in lens]
        toks, pages = sum(seen), sum((n + BS - 1) // BS for n in seen)
        kv_bytes = toks * KV * D * 2 * (1 if int8 else 2)
        if int8:
            kv_bytes += pages * KV * 4 * 2
        nbytes = 2 * (2 * B * H * D) + kv_bytes + 4 * (B + pages)
        row = {"case": label, "seq_lens": list(lens), "max_abs_err": err,
               "ms": time_ms(call),
               "bound": bound_ms(nbytes, 4 * H * D * toks)}
        if row_check:
            row["row_rel_err"] = rel
        rows.append(row)
        log(f"{name} {label}: kernel_ms={row['ms']:.4f} "
            f"bound_ms={row['bound'][0]:.5f} ({row['bound'][1]}) "
            f"max_abs_err={err:.3e}"
            + (f" row_rel_err={rel:.3e}" if row_check else ""))
    main, sl = rows[0], torch.tensor(PAGED_SEQ_LENS, dtype=torch.int32,
                                     device=dev)
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": ("src/repro/kernels/paged_attention_quant.py:62"
                         if int8 else
                         "src/repro/kernels/paged_attention.py:131"),
            "max_abs_err": worst, "ms": main["ms"],
            "plain_ms": time_ms(lambda: plain(q, *pools, bt, sl), iters=3),
            "bound": main["bound"], "library_ms": None, "heads": [H, KV],
            "shape": f"q[{B},{H},{D}] " + (f"int8 pool[{NB},{BS},{KV},{D}] + "
                                           f"scales[{NB},{KV}]" if int8 else
                                           f"pool[{NB},{BS},{KV},{D}]")
                     + f" seq_lens {list(PAGED_SEQ_LENS)}; checked also "
                     + "; ".join(c[0] for c in PAGED_CASES[1:]),
            "per_case": rows}


def check_paged_attention_quant(gen, heads=(H, KV)):
    return check_paged_attention(gen, int8=True, heads=heads)


# (q_offset, live length, options) of the chunk cases, the timed one last:
# q_offset 0 / aligned / unaligned, a partial chunk, a prefix that runs to
# the end of the 64-page table, a window, ALiBi, then a chunk of 256
# after 768 pooled tokens
CHUNK_CASES = ((0, W, {}), (256, W, {}), (300, 100, {}), (1000, 24, {}),
               (300, W, {"sliding_window": 200}), (300, W, {"alibi": True}),
               (768, W, {}))


def check_flash_attention_chunk(gen, int8: bool = False, heads=(H, KV),
                                row_check: bool = False):
    """The chunk kernel over the bf16 pool, or (``int8``) its int8-pool
    branch, in every case of CHUNK_CASES at ``heads`` (query heads, KV
    heads): the live rows within TOL of the plain version (with
    ``row_check`` also each live (query, head) row within FLASH_REL_TOL
    of its own RMS), two calls bitwise equal, each case timed beside its
    bound (the last also beside the plain version)."""
    import torch
    H, KV = heads
    from repro_torch.core.alibi import alibi_slopes
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        flash_attention_chunk, flash_attention_chunk_int8)
    dev = "cuda"
    if int8:
        kernel = flash_attention_chunk_int8
        (kp, ks), (vp, vs) = (_int8_pool((NB, BS, KV, D), gen)
                              for _ in range(2))
        kp, ks, vp, vs = kp[None], ks[None], vp[None], vs[None]
        scales = {"k_scales": ks[0], "v_scales": vs[0]}
    else:
        kernel = flash_attention_chunk
        kp = torch.randn((1, NB, BS, KV, D), generator=gen,
                         device=dev).bfloat16()
        vp = torch.randn((1, NB, BS, KV, D), generator=gen,
                         device=dev).bfloat16()
        ks = vs = None
        scales = {}
    bt = torch.randperm(NB, generator=gen, device=dev)[:MB][None].int()

    rows, worst = [], 0.0
    for q_off, n, opt in CHUNK_CASES:
        label = f"q_offset {q_off} len {n}" + "".join(
            f" {k} {v}" for k, v in opt.items())
        q = torch.randn((1, W, H, D), generator=gen, device=dev).bfloat16()
        kr = torch.randn((1, W, KV, D), generator=gen, device=dev).bfloat16()
        vr = torch.randn((1, W, KV, D), generator=gen, device=dev).bfloat16()
        off = torch.tensor(q_off, dtype=torch.int32, device=dev)
        tl = torch.tensor(q_off + n, dtype=torch.int32, device=dev)
        win = opt.get("sliding_window", 0)
        slopes = alibi_slopes(H, dev) if opt.get("alibi") else None

        def call():
            return kernel(q, kp[0], vp[0], bt, off, tl, kr, vr, slopes,
                          sliding_window=win, **scales)
        want = ref.chunk_prefill_attention_ref(
            q, kp, vp, ks, vs, 0, bt, off, tl, kr, vr, alibi_slopes=slopes,
            sliding_window=win)
        out = call()
        torch.cuda.synchronize()
        err = (out[:, :n].float() - want[:, :n].float()).abs().max().item()
        rel = row_rel_err(out[:, :n], want[:, :n]) if row_check else 0.0
        if not (err <= TOL and rel <= FLASH_REL_TOL):
            raise AssertionError(f"{kernel.name} {label}: max err {err} "
                                 f"(tol {TOL}), row err over RMS {rel} "
                                 f"(limit {FLASH_REL_TOL})")
        _repeat_equal(kernel.name, label, call, out)
        worst = max(worst, err)
        # visible (query, key) pairs, and the prefix keys any query sees
        pairs = sum(min(q_off + i + 1, win) if win else q_off + i + 1
                    for i in range(n))
        pre = q_off - (max(0, q_off - win + 1) if win else 0)
        pool_bytes = pre * KV * D * 2 * (1 if int8 else 2)
        if int8:
            pool_bytes += ((pre + BS - 1) // BS) * KV * 4 * 2
        nbytes = 2 * (2 * W * H * D + 2 * W * KV * D) + pool_bytes
        row = {"case": label, "max_abs_err": err, "ms": time_ms(call),
               "bound": bound_ms(nbytes, 4 * H * D * pairs)}
        if row_check:
            row["row_rel_err"] = rel
        rows.append(row)
        log(f"{kernel.name} {label}: kernel_ms={row['ms']:.4f} "
            f"bound_ms={row['bound'][0]:.5f} ({row['bound'][1]}) "
            f"max_abs_err={err:.3e}"
            + (f" row_rel_err={rel:.3e}" if row_check else ""))
    main = rows[-1]
    return {"name": kernel.name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_chunk.cu",
            "replaces": "src/repro/kernels/flash_attention.py:310"
                        + (" (quantized branch :125-129, :175-177)"
                           if int8 else ""),
            "max_abs_err": worst, "ms": main["ms"],
            "plain_ms": time_ms(lambda: ref.chunk_prefill_attention_ref(
                q, kp, vp, ks, vs, 0, bt, off, tl, kr, vr), iters=3),
            "bound": main["bound"], "library_ms": None, "heads": [H, KV],
            "shape": f"q[1,{W},{H},{D}] q_offset 768 total 1024"
                     + (" int8 pool" if int8 else "") + "; checked also "
                     + "; ".join(r["case"] for r in rows[:-1]),
            "per_case": rows}


def check_flash_attention_chunk_int8(gen, heads=(H, KV)):
    return check_flash_attention_chunk(gen, int8=True, heads=heads)


WAVE_B, WAVE_S = 8, 960     # the whole-prompt serve's wave: 8 x 900 -> 960


def _sdpa_ms(q, k, v, bias):
    """One SDPA call (grouped K/V) on the same inputs, the library
    yardstick: ``is_causal`` for a plain causal square, else the additive
    mask ``bias``.  None (with the reason printed) where this torch refuses
    the call."""
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kw = {"is_causal": True} if bias is None else {"attn_mask": bias}
    try:
        return time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True, **kw))
    except (TypeError, RuntimeError) as e:
        log(f"[kernel] flash_attention: SDPA yardstick refused: {e}")
        return None


def row_rel_err(out, want) -> float:
    """The largest error of any query row relative to that row's size:
    max over (b, q, h) of max_d |out - want| / RMS_d(want).  A softmax
    average of unit-normal V over n keys is about sqrt(1/n) in size, so
    over thousands of keys an absolute limit is as large as the values
    themselves; this one is not.  Rows the plain version leaves all zero
    (no live key) count only where the kernel's are not zero too."""
    import torch
    rel = 0.0
    for o, w in zip(out.split(1024, dim=1), want.split(1024, dim=1)):
        w = w.float()
        diff = (o.float() - w).abs().amax(-1)
        rms = w.pow(2).mean(-1).sqrt()
        # 0 / 0 (a row all zero in both) counts 0, x / 0 counts inf
        rel = max(rel, (diff / rms).nan_to_num(nan=0.0, posinf=float("inf"))
                  .max().item())
    return rel


def _flash_rows(cases, plain, name: str = "flash_attention"):
    """Each (label, (q, k, v), kwargs) of ``cases`` through the static
    prefill kernel against ``plain`` on the same inputs (within TOL, and
    every query row within FLASH_REL_TOL of its own RMS, ``row_rel_err``;
    two calls bitwise equal), timed beside one SDPA call (a plain causal
    square as ``is_causal``, else an additive mask) and its bound (the
    live (q, k) pairs).  Returns (worst error, rows)."""
    import torch
    from repro_torch.core.gqa import NEG_INF
    from repro_torch.kernels.flash_attention import flash_attention
    dev = "cuda"
    worst, rows = 0.0, []
    for label, (q, k, v), kw in cases:
        out = flash_attention(q, k, v, **kw)
        want = plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        rel = row_rel_err(out, want)
        del want
        if not (err <= TOL and rel <= FLASH_REL_TOL):
            raise AssertionError(f"{name} {label}: max err {err} (tol "
                                 f"{TOL}), row-relative err {rel} (tol "
                                 f"{FLASH_REL_TOL})")
        _repeat_equal(name, label, lambda: flash_attention(q, k, v, **kw),
                      out)
        del out
        worst = max(worst, err)
        b, sq, h, d = q.shape
        sk, kvh = k.shape[1], k.shape[2]
        q_pos = kw.get("q_offset", 0) + torch.arange(sq, device=dev)
        dist = q_pos[:, None] - torch.arange(sk, device=dev)[None]
        live = torch.ones_like(dist, dtype=torch.bool)
        if kw.get("causal", True):
            live &= dist >= 0
        if kw.get("sliding_window", 0):
            live &= dist < kw["sliding_window"]
        pairs = b * int(live.sum())
        nbytes = 2 * (2 * b * sq * h * d + 2 * b * sk * kvh * d)
        # a window as wide as the keys leaves a plain causal square
        win = kw.get("sliding_window", 0)
        square = (sq == sk and kw.get("q_offset", 0) == 0
                  and kw.get("causal", True) and "alibi_slopes" not in kw
                  and (win == 0 or win >= sk))
        bias = None
        if kw and not square:
            bias = torch.where(live, 0.0, NEG_INF)[None, None].expand(
                1, h, sq, sk)
            if "alibi_slopes" in kw:
                bias = bias - kw["alibi_slopes"][:, None, None] \
                    * dist.abs()[None].float()
            bias = bias.bfloat16()
        del dist, live
        row = {"case": label, "q": list(q.shape), "kv": list(k.shape),
               "max_abs_err": err, "max_row_rel_err": rel,
               "ms": time_ms(lambda: flash_attention(q, k, v, **kw)),
               "library_ms": _sdpa_ms(q, k, v, bias),
               "bound": bound_ms(nbytes, 4 * h * d * pairs)}
        del bias
        rows.append(row)
        lib = row["library_ms"]
        log(f"{name} {label}: q{row['q']} kv{row['kv']} "
            f"kernel_ms={row['ms']:.4f} sdpa_ms="
            + ("null" if lib is None else f"{lib:.4f}")
            + f" bound_ms={row['bound'][0]:.5f} ({row['bound'][1]}) "
            f"max_abs_err={err:.3e} max_row_rel_err={rel:.3e}")
    return worst, rows


def _qkv(gen, b, sq, sk, h=H, kv=KV, d=D):
    import torch
    return tuple(torch.randn(shape, generator=gen, device="cuda").bfloat16()
                 for shape in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d)))


def check_flash_attention(gen):
    """The static prefill kernel at the whole-prompt serve's wave shape
    (causal), then at q_offset > 0 with Sq < Sk, a sliding band, ALiBi, a
    ragged Sq = Sk = 333 (causal and not), head dim 64 (qwen1.5-0.5b's
    16 heads over 16 KV heads, G = 1) and the GPTQ load's calibration batch
    (plain causal, [CALIB_B, CALIB_S]).  Every case is timed beside one SDPA
    call on its inputs (the library yardstick; a mask where the case is not
    a plain causal square) and its bound (the live (q, k) pairs)."""
    from repro_torch.core.alibi import alibi_slopes
    from repro_torch.kernels import ref
    dev = "cuda"

    def qkv(*a):
        return _qkv(gen, *a)

    cases = [("causal wave", qkv(WAVE_B, WAVE_S, WAVE_S), {}),
             ("q_offset 128, Sq 256 < Sk 384", qkv(2, 256, 384),
              {"q_offset": 128}),
             ("sliding window 128", qkv(2, 512, 512),
              {"sliding_window": 128}),
             ("ALiBi", qkv(2, 512, 512),
              {"alibi_slopes": alibi_slopes(H, dev)}),
             ("ragged Sq = Sk = 333", qkv(2, 333, 333), {}),
             ("ragged 333, not causal, ALiBi", qkv(2, 333, 333),
              {"causal": False, "alibi_slopes": alibi_slopes(H, dev)}),
             ("head dim 64, 16 heads / 16 KV, causal",
              qkv(2, 512, 512, 16, 16, 64), {}),
             ("q_offset 64, window 100, Sq 200 < Sk 333", qkv(2, 200, 333),
              {"q_offset": 64, "sliding_window": 100}),
             (f"calibration [{CALIB_B},{CALIB_S}] causal",
              qkv(CALIB_B, CALIB_S, CALIB_S), {})]
    worst, rows = _flash_rows(cases, ref.flash_attention_ref)
    q, k, v = cases[0][1]
    main = rows[0]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:386",
            "max_abs_err": worst, "ms": main["ms"],
            "plain_ms": time_ms(lambda: ref.flash_attention_ref(q, k, v),
                                iters=2),
            "bound": main["bound"], "library_ms": main["library_ms"],
            "shape": f"q[{WAVE_B},{WAVE_S},{H},{D}] k/v[{WAVE_B},{WAVE_S},"
                     f"{KV},{D}] causal; checked also at "
                     + "; ".join(c[0] for c in cases[1:]),
            "per_case": rows}


GPTQ_MS = (1, 8, 16, 64, 200, 256, 7680)   # decode, chunks, ragged, wave
# (name, K, N, group size, Ms) of every product checked: the four linears,
# then one whose last k tile, N edge (odd, not a multiple of 4) and group
# size (not a power of two) are all ragged
GPTQ_SHAPES = [(lname, K, N, GS, GPTQ_MS) for lname, (K, N) in
               LINEARS.items()] + [("ragged", 1056, 1001, 96, (8, 200))]


def _int4pack(qw, sc, zr):
    """The library yardstick's operands, made once outside any timing:
    codes -> uint8 [N, K/2] (even k in the high nibble, as torch's own
    tests pack it) -> ``torch._convert_weight_to_int4pack``, and
    [K/gs, N, 2] bf16 (scale, (8 - zero) * scale), since tinygemm computes
    (q - 8) * s + z' and (q - z) * s = (q - 8) * s + (8 - z) * s."""
    import torch
    from repro_torch.core.quant import unpack_int4
    ct = unpack_int4(qw, qw.shape[0] * 8).t().contiguous()     # [N, K]
    u8 = (ct[:, 0::2] << 4 | ct[:, 1::2]).to(torch.uint8).contiguous()
    sz = torch.stack([sc, (8 - zr) * sc], -1).bfloat16().contiguous()
    return torch._convert_weight_to_int4pack(u8, 8), sz


def _library_check(row, call, want, lim) -> str:
    """Time the library ``call`` into ``row`` if it runs and agrees with
    the plain version ``want`` within ``lim``; say why not otherwise."""
    import torch
    try:
        got = call()
        torch.cuda.synchronize()
    except RuntimeError as e:
        return f"_weight_int4pack_mm refused: {e}"
    diff = (got.float() - want.float()).abs()
    if not bool((diff <= lim).all()):
        return f"disagrees with the plain version: {diff.max().item():.3e}"
    row["library_ms"] = time_ms(call)
    return f"max err {diff.max().item():.3e}"


def _host_us(fn, calls: int = 50) -> float:
    """The host's microseconds a call of ``fn`` takes to return (argument
    checks, planning, tensor-map encoding and the launch; the device
    runs behind)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def check_gptq_matmul(gen, shapes=None, main_shape=("gate/up", 8),
                      shape="x[8,1536] @ int4[1536,8960] gs 32 (gate/up, "
                            "decode)", library_max_m=None):
    """Each product of ``shapes`` (GPTQ_SHAPES by default) against the
    plain version; two calls must give bitwise-equal outputs (split-K
    sums in a fixed order).  Each shape is timed beside the plain
    version, the library call (``torch._weight_int4pack_mm`` on weights
    repacked once, checked against the plain version first; only up to
    ``library_max_m`` rows when given) and a dense bf16 matmul on the
    dequantized weight (another function: what int4 is meant to beat).
    The record's numbers are those of ``main_shape`` (linear, M)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.gptq_matmul import gptq_matmul
    dev = "cuda"
    rows, worst, main = [], 0.0, None
    lib_fn = getattr(torch, "_weight_int4pack_mm", None)
    for lname, K, N, gs, ms in shapes or GPTQ_SHAPES:
        qw = torch.randint(-2 ** 31, 2 ** 31 - 1, (K // 8, N), generator=gen,
                           device=dev, dtype=torch.int64).int()
        sc = (torch.rand((K // gs, N), generator=gen, device=dev) * 0.01)
        # f32 zeros anywhere in [0, 15], not only whole codes: the kernel
        # rounds (8 - zero) x scale to bf16 for any of them
        zr = torch.rand((K // gs, N), generator=gen, device=dev) * 15
        w16 = ref.gptq_matmul_ref(torch.eye(K, device=dev,
                                            dtype=torch.bfloat16), qw, sc, zr)
        packed, why = None, "torch has no _weight_int4pack_mm"
        if lib_fn is not None:
            try:
                packed, sz = _int4pack(qw, sc, zr)
            except RuntimeError as e:
                why = f"_convert_weight_to_int4pack refused: {e}"
        for M in ms:
            x = torch.randn((M, K), generator=gen, device=dev).bfloat16()
            y = gptq_matmul(x, qw, sc, zr)
            want = ref.gptq_matmul_ref(x, qw, sc, zr)
            again = gptq_matmul(x, qw, sc, zr)
            torch.cuda.synchronize()
            diff = (y.float() - want.float()).abs()
            scale = want.float().abs().max().item()
            lim = TOL * scale + TOL * want.float().abs()
            err = diff.max().item()
            if not bool((diff <= lim).all()):
                raise AssertionError(f"gptq_matmul {lname} M={M}: max err "
                                     f"{err} (tol {TOL} x max|ref| {scale})")
            if not torch.equal(y, again):
                raise AssertionError(f"gptq_matmul {lname} M={M}: two calls "
                                     "differ (not deterministic)")
            worst = max(worst, err / scale)
            nbytes = M * K * 2 + K * N // 2 + 2 * (K // gs) * N * 4 + M * N * 2
            flops = 2 * M * K * N
            row = {"linear": lname, "M": M, "K": K, "N": N, "gs": gs,
                   # (the older trees chip_pair.py times have no
                   # plan_for)
                   "plan": (gptq_matmul.plan_for(x, N, gs)._asdict()
                            if hasattr(gptq_matmul, "plan_for") else None),
                   "host_us": _host_us(lambda: gptq_matmul(x, qw, sc, zr)),
                   "ms": time_ms(lambda: gptq_matmul(x, qw, sc, zr)),
                   "plain_ms": time_ms(lambda: ref.gptq_matmul_ref(
                       x, qw, sc, zr), iters=3),
                   "bound": bound_ms(nbytes, flops), "rel_err": err / scale,
                   "library_ms": None, "library_note": why,
                   "dense_bf16_matmul_ms": time_ms(lambda: x @ w16)}
            if packed is not None and library_max_m is not None \
                    and M > library_max_m:
                row["library_note"] = f"not timed above M {library_max_m}"
            elif packed is not None:
                row["library_note"] = _library_check(
                    row, lambda: lib_fn(x, packed, gs, sz), want, lim)
            row["bound_share"] = row["bound"][0] / row["ms"]
            rows.append(row)
            lib = row["library_ms"]
            pl = row["plan"] or {"route": "?", "tile": "?", "splits": "?"}
            log(f"gptq_matmul {lname:8s} M={M:4d} K={K} N={N} gs={gs}: "
                f"kernel_ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                f"library_ms=" + ("null" if lib is None else f"{lib:.4f}")
                + f" bound_ms={row['bound'][0]:.4f} ({row['bound'][1]}) "
                f"share_of_bound={row['bound_share']:.3f} "
                f"dense_bf16_matmul_ms={row['dense_bf16_matmul_ms']:.4f} "
                f"rel_err={row['rel_err']:.2e} host_us={row['host_us']:.1f} "
                f"plan={pl['route']}/{pl['tile']}x{pl['splits']} "
                f"[{row['library_note']}]")
            if (lname, M) == main_shape:
                main = row
            del x, y, want, again, diff, lim
    return {"name": "gptq_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gptq_matmul.cu",
            "replaces": "src/repro/kernels/gptq_matmul.py:75",
            "max_abs_err": worst, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound": main["bound"],
            "library_ms": main["library_ms"],
            "shape": shape + "; max_abs_err relative to max|ref|",
            "per_shape": rows}


# --------------------------------------------------------------------------
# The threefry sampling stream on the card and on the CPU
# --------------------------------------------------------------------------

SAMPLE_ROWS = 9


def phase_sampling(dev: str = "cuda") -> dict:
    """``core.sampling`` on the card against the CPU over SAMPLE_ROWS rows
    of qwen2-1.5b's full vocabulary: the uniforms (integer arithmetic and
    one exact f32 subtraction) bitwise equal; then ``sample_from_logits``
    on the same logits (made on the CPU, copied to the card), temperature
    0.8 rows with top-k 20 and / or top-p 0.9 mixed with greedy rows, the
    same tokens.  Times the sampled and the all-greedy call on the card
    (the threefry stream's cost)."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core import sampling as S
    V = get_config("qwen2-1.5b").vocab_size
    n = SAMPLE_ROWS
    keys = np.stack([S.threefry_seed(1000 + i) for i in range(n)])
    counts = np.arange(n, dtype=np.int32) * 7
    u_cpu = S.uniform(S.fold_in(keys, counts), V)
    u_card = S.uniform(S.fold_in(keys, counts, dev), V).cpu()
    uniforms_equal = torch.equal(u_cpu.view(torch.int32),
                                 u_card.view(torch.int32))
    g_err = (S.gumbel(S.fold_in(keys, counts, dev), V).cpu()
             - S.gumbel(S.fold_in(keys, counts), V)).abs().max().item()
    rng = np.random.default_rng(0)
    logits = torch.from_numpy((rng.normal(size=(n, V)) * 3)
                              .astype(np.float32))
    temps = np.array([0, .8, .8, 0, .8, .8, 0, .8, .8], np.float32)
    top_ks = np.array([0, 20, 0, 0, 20, 0, 0, 20, 20], np.int32)
    top_ps = np.array([1, 1, .9, 1, .9, 1, 1, 1, .9], np.float32)
    rows = (keys, counts, temps, top_ks, top_ps)
    want = S.sample_from_logits(logits, *rows)
    card = logits.to(dev)
    got = S.sample_from_logits(card, *rows).cpu()
    greedy = (keys, counts, np.zeros_like(temps), top_ks, top_ps)
    out = {"rows": n, "vocab": V, "uniforms_equal": uniforms_equal,
           "gumbel_max_abs_err": g_err, "tokens_cpu": want.tolist(),
           "tokens_card": got.tolist(),
           "tokens_equal": torch.equal(got, want),
           "sampled_call_ms": time_ms(
               lambda: S.sample_from_logits(card, *rows)),
           "greedy_call_ms": time_ms(
               lambda: S.sample_from_logits(card, *greedy))}
    if not (uniforms_equal and out["tokens_equal"]):
        raise AssertionError(f"sampling: card vs CPU {out}")
    out["sample_device"] = legacy_sampler(dev)
    return out


# the legacy single-key sampler's batch: bf16 logits [8, vocab], greedy
# and sampled rows mixed, top-k off and 40
SAMPLE_DEVICE_TEMPS = (0.0, 0.8, 1.0, 0.0, 0.5, 1.3, 0.0, 0.7)
SAMPLE_DEVICE_TOP_KS = (0, 40)


def legacy_sampler(dev: str = "cuda") -> dict:
    """``serving.sampler.sample_device`` (one shared key, uniform top-k,
    noise over the B x V positions flattened) on [8, V] bf16 logits of
    qwen2-1.5b's vocabulary, on the card and on the CPU from the same
    logits and key: the same token ids for each top-k of
    SAMPLE_DEVICE_TOP_KS.  Timed on the card."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.sampling import threefry_seed
    from repro_torch.serving.sampler import sample, sample_device
    V = get_config("qwen2-1.5b").vocab_size
    rng = np.random.default_rng(4)
    logits = torch.from_numpy((rng.normal(size=(len(SAMPLE_DEVICE_TEMPS), V))
                               * 3).astype(np.float32)).bfloat16()
    card = logits.to(dev)
    temps = list(SAMPLE_DEVICE_TEMPS)
    out = {"shape": list(logits.shape), "dtype": "bfloat16", "cases": []}
    for top_k in SAMPLE_DEVICE_TOP_KS:
        key = threefry_seed(11 + top_k)
        want = sample(logits, key, temps, top_k)
        got = sample(card, key, temps, top_k)
        t = torch.tensor(temps, device=dev)
        case = {"top_k": top_k, "tokens_cpu": want.tolist(),
                "tokens_card": got.tolist(),
                "tokens_equal": bool(np.array_equal(got, want)),
                "call_ms": time_ms(
                    lambda: sample_device(card, key, t, top_k))}
        out["cases"].append(case)
        if not case["tokens_equal"]:
            raise AssertionError(f"sample_device top_k {top_k}: card vs "
                                 f"CPU {case}")
    return out


# --------------------------------------------------------------------------
# Phase 3: the 2-layer full-width model on the card and on the CPU
# --------------------------------------------------------------------------

# card vs CPU logits of the 2-layer MoE model in f32: the sums run in
# another order (rounding ~1e-6 of logits of size ~5); bf16 is not used
# because MoE routing turns its rounding into other experts
MOE_LOGIT_TOL = 1e-3


def phase_model(dev: str, ref_dev: str = "cpu", layers: int = 2,
                kv: str = "bf16", config: str = "qwen2-1.5b",
                gs: int = GS, init_dev=None, wave: bool = True,
                rel_tol=None) -> dict:
    """The same params, pools and inputs through the decode step, a chunk
    at q_offset 160, the unified step and a whole-prompt ``T.prefill``
    wave on ``dev`` and on ``ref_dev``; ``kv`` picks the pool format.
    ``config``'s full width cut to ``layers``: a dense config with int4
    (RTN, group size ``gs``) weights and bf16 activations, held to
    LOGIT_TOL; an MoE config with f32 weights and activations, held to
    MOE_LOGIT_TOL.  The weights are drawn on ``init_dev`` (``ref_dev``
    by default; command-r's 2 full-width layers and 3.15e9-element
    embedding are drawn on the card, much faster than the CPU's
    one-thread generator).  The ``ref_dev`` side takes each int4 weight
    as the plain version's own dequantized weight (``dequantized``): the
    same products bit for bit, without dequantizing every weight again at
    every call on the CPU.  Without
    ``wave`` the whole-prompt wave is left out (a chunked serve never runs
    one); with ``rel_tol`` the logits are held to ``rel_tol`` times their
    largest magnitude.  A layernorm's weights and biases are drawn
    (``random_norms``): the init's ones and zeros leave the bias out."""
    import numpy as np
    import torch
    from repro_torch.bridge import tree_to
    from repro_torch.configs.registry import get_config
    from repro_torch.core.kv_quant import (cache_from_state,
                                           dequantize_blocks, quantize_blocks)
    from repro_torch.models import transformer as T
    from repro_torch.models.quantize import quantize_params_rtn
    cfg = get_config(config).replace(num_layers=layers)
    if cfg.num_experts:
        cfg = cfg.replace(dtype="float32")
        params, tol = T.init_params(cfg, 1, dev), MOE_LOGIT_TOL
    else:
        params = quantize_params_rtn(
            T.init_params(cfg, 1, init_dev or ref_dev), cfg, gs)
        if cfg.norm == "layernorm":
            params = random_norms(params)
        tol = LOGIT_TOL
    rng = np.random.default_rng(0)
    nb, mb, slots = 128, MB, B
    bs = cfg.paging.block_size
    pool_shape = (layers, nb, bs, cfg.num_kv_heads, cfg.resolved_head_dim)
    pools = {}
    for name in ("k", "v"):
        x = torch.from_numpy(rng.normal(size=pool_shape).astype(np.float32))
        if kv == "int8":
            pools[name] = quantize_blocks(x, torch.ones(pool_shape[:3],
                                                        dtype=torch.bool))
        else:
            pools[name] = (x, None)
    bt = rng.permutation(nb)[:slots * 10].reshape(slots, 10).astype(np.int32)
    bt = np.concatenate([bt, np.zeros((slots, mb - 10), np.int32)], 1)
    sl = np.array([0, 9, 16, 37, 64, 100, 150, 160], np.int32)
    toks = rng.integers(0, cfg.vocab_size, slots).astype(np.int32)
    active = sl > 0
    ctoks = rng.integers(0, cfg.vocab_size, (1, W)).astype(np.int32)
    cbt = np.zeros((1, mb), np.int32)
    cbt[0, :24] = rng.permutation(np.setdiff1d(np.arange(nb), bt))[:24]
    q_off, n = 160, 200                  # an unaligned later chunk
    # a whole-prompt wave: 4 prompts padded to 256, one of a single token
    wlens = np.array([256, 200, 77, 1], np.int32)
    wtoks = rng.integers(0, cfg.vocab_size, (4, 256)).astype(np.int32)
    wbt = np.zeros((4, mb), np.int32)
    wbt[:, :16] = rng.permutation(nb)[:64].reshape(4, 16)
    sampling = {"keys": np.zeros((slots + 1, 2), np.uint32),
                "counts": np.zeros(slots + 1, np.int32),
                "temps": np.zeros(slots + 1, np.float32),
                "top_ks": np.zeros(slots + 1, np.int32),
                "top_ps": np.ones(slots + 1, np.float32)}

    def pool_values(st):
        """The K pool as f32 values (dequantized in int8) and, in int8,
        the size of one quantization step per (block, KV head)."""
        k = st["k_pool"].float().cpu()
        if kv != "int8":
            return k, torch.zeros(())
        s = st["k_scales"].cpu()
        return dequantize_blocks(k.to(torch.int8), s), s[:, :, None, :, None]

    res = {}
    with torch.no_grad():
        for d in (ref_dev, dev):
            tree = dequantized(params, T.act_dtype(cfg)) \
                if d == ref_dev else params
            p = T.split_layers(T.cast_params(tree_to(tree, d),
                                             T.act_dtype(cfg)))
            del tree

            def fresh(table, lens):
                st = T.make_decode_state(cfg, slots, nb, mb,
                                         kv_cache_dtype=kv, device=d)
                for name in ("k", "v"):
                    vals, scales = pools[name]
                    st[f"{name}_pool"].copy_(vals)
                    if scales is not None:
                        st[f"{name}_scales"].copy_(scales)
                st["block_table"] = torch.from_numpy(table).to(d)
                st["seq_lens"] = torch.from_numpy(lens).to(d)
                return st

            def i32(a):
                return torch.from_numpy(np.asarray(a, np.int32)).to(d)

            st = fresh(bt, sl)
            dec, st = T.decode_step(cfg, p, st, i32(toks))
            chunk, _ = T.prefill_chunk(cfg, p, cache_from_state(st),
                                       i32(ctoks), i32(cbt), i32(q_off),
                                       i32(q_off + n))
            st = fresh(bt, sl)
            nxt, st = T.unified_step(cfg, p, st, i32(toks), sampling,
                                     torch.from_numpy(active).to(d),
                                     i32(ctoks), i32(cbt), i32(q_off),
                                     i32(q_off + n))
            unified_pool = pool_values(st)
            if wave:
                st = fresh(wbt, wlens)
                wlg, st = T.prefill(cfg, p, st, {"tokens": i32(wtoks),
                                                 "ctx_lens": i32(wlens)})
                wlg = wlg.float().cpu()
            else:
                wlg = torch.zeros((1, 1))
            res[d] = (dec.float().cpu(), chunk.float().cpu(), wlg,
                      nxt.cpu(), unified_pool, pool_values(st))
    (d0, c0, w0, n0, *p0), (d1, c1, w1, n1, *p1) = res[ref_dev], res[dev]
    # inactive decode rows (seq_len 0) are garbage by contract: the kernel
    # writes zeros there, the plain version an average — compare live rows
    live = torch.from_numpy(active)
    d0, d1 = d0[live], d1[live]
    err = max((a - b).abs().max().item()
              for a, b in ((d1, d0), (c1, c0), (w1, w0)))
    scale = max(t.abs().max().item() for t in (d0, c0, w0))
    if rel_tol is not None:
        tol = rel_tol * scale
    # pools: the bf16 tolerance on values, plus one quantization step in
    # int8 (a value that differs in bf16 may round to the next code)
    pool_err, pool_ok = 0.0, True
    for (k0, _), (k1, step) in zip(p0, p1):
        diff = (k1 - k0).abs()
        pool_err = max(pool_err, diff.max().item())
        pool_ok &= bool((diff <= min(TOL, tol) * k0.abs().max()
                         + step).all())
    rows = torch.cat([live, torch.ones(1, dtype=torch.bool)])
    agree = float((n1[rows] == n0[rows]).float().mean())
    wave_agree = float((w1.argmax(-1) == w0.argmax(-1)).float().mean())
    if not (err <= tol and pool_ok):
        raise AssertionError(f"model {config} {kv}: logits max err {err} "
                             f"(tol {tol}, max|logit| {scale}), pool err "
                             f"{pool_err}")
    if not all(torch.isfinite(t).all() for t in (d1, c1, w1)):
        raise AssertionError(f"model {config} {kv}: non-finite logits on "
                             "the card")
    return {"config": config, "dtype": cfg.dtype, "layers": layers,
            "kv_cache_dtype": kv,
            "logit_max_abs_err": err, "max_abs_logit": scale,
            "pool_max_abs_err": pool_err, "greedy_agreement": agree,
            "prefill_wave_greedy_agreement": wave_agree if wave else None,
            "tolerance": tol, "relative_tolerance": rel_tol}


def random_norms(params, seed: int = 7):
    """``params`` with every norm's weight ``w`` drawn as 1 + 0.1 N(0, 1)
    and a layernorm's bias ``b`` as 0.1 N(0, 1) (seeded, on the params'
    device): the init's ones and zeros would leave the bias out of a
    check."""
    import torch
    gens = {}

    def walk(tree, in_norm=False, key=""):
        if isinstance(tree, dict):
            return {k: walk(v, in_norm or k.endswith("norm"), k)
                    for k, v in tree.items()}
        if not in_norm:
            return tree
        dev = tree.device
        gen = gens.setdefault(dev, torch.Generator(device=dev)
                              .manual_seed(seed))
        noise = 0.1 * torch.randn(tree.shape, generator=gen, device=dev)
        return noise if key == "b" else 1.0 + noise
    return walk(params)


def dequantized(params, dtype):
    """``params`` with every int4 dict replaced by the weight the plain
    int4 product multiplies by (``core.quant.dequantize`` in ``dtype``,
    computed where the dict lies): ``quant_matmul_ref`` is that
    dequantization followed by ``x @ w``, which the dense ``linear`` path
    computes on the same weight, so a forward over this tree gives the
    plain int4 path's numbers bit for bit
    (``tests/test_torch_command_r.py`` holds that on the CPU).  The
    dequantization is integer unpacking, one f32 subtraction and one
    product, then the cast: the card and the CPU give the same bits."""
    import torch
    from repro_torch.core.quant import PACK, dequantize

    def one(w):
        return dequantize(w, w["qweight"].shape[-2] * PACK, dtype)

    def walk(tree):
        if isinstance(tree, dict):
            if "qweight" in tree:          # one layer's, or a layer stack's
                if tree["qweight"].dim() == 2:
                    return one(tree)
                return torch.stack([one({k: v[i] for k, v in tree.items()})
                                    for i in range(len(tree["qweight"]))])
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return tree
    return walk(params)


# --------------------------------------------------------------------------
# Phase 4: serve full-depth qwen2-1.5b with int4 weights
# --------------------------------------------------------------------------

# the serves' prompt lengths; prompts 1 and 2 share 64 tokens
SERVE_LENS = (20, 64 + 40, 64 + 300, 150, 420, 600, 777, 900)


def serve_prompts(vocab: int, lens=SERVE_LENS, seed: int = 0):
    import numpy as np
    rng = np.random.default_rng(seed)
    ps = [rng.integers(0, vocab, n).tolist() for n in lens]
    ps[2][:64] = ps[1][:64]              # a shared 64-token prefix
    return ps


# The synchronous engine (read back every step, no span tracer): the
# first four serves run it, the fifth the engine's defaults.
SYNC = {"enable_async_step": False, "enable_telemetry": False}
# the time-scan kernels, which only the recurrent families launch
SCAN_KERNELS = {"selective_scan", "linear_scan"}
BF16_CHUNKED_KERNELS = (
    {"paged_attention", "flash_attention_chunk", "gptq_matmul"},
    {"paged_attention_quant", "flash_attention_chunk_int8",
     "flash_attention"} | SCAN_KERNELS)
# The serves: (label, LLM.load options, kernels that must launch, kernels
# that must not).  Each runs its own path: the int8 serve never touches a
# bf16-pool attention kernel, the whole-prompt serve never the chunk
# kernel.  The last runs the engine's defaults (async pipelined step,
# telemetry and guards on) on bf16-chunked's traffic.
SERVES = (
    ("bf16-chunked", SYNC, *BF16_CHUNKED_KERNELS),
    ("int8-chunked", {**SYNC, "kv_cache_dtype": "int8"},
     {"paged_attention_quant", "flash_attention_chunk_int8", "gptq_matmul"},
     {"paged_attention", "flash_attention_chunk", "flash_attention"}
     | SCAN_KERNELS),
    ("bf16-whole-prompt", {**SYNC, "enable_chunked_prefill": False},
     {"flash_attention", "paged_attention", "gptq_matmul"},
     {"flash_attention_chunk", "flash_attention_chunk_int8",
      "paged_attention_quant"} | SCAN_KERNELS),
    ("bf16-chunked-async", {}, *BF16_CHUNKED_KERNELS),
)


# The synchronous serves' attention launches (one per call: 28 layers x
# the serve's decode steps / chunks), fixed by their schedule; every serve
# is also held to 28 x the runner's own count of decode steps, chunks and
# waves.  gptq_matmul's count depends on its plan and is checked through
# must / never only.
ATTENTION_LAUNCHES = {
    "bf16-chunked": {"paged_attention": 1092, "paged_attention_quant": 0,
                     "flash_attention_chunk": 588,
                     "flash_attention_chunk_int8": 0},
    "int8-chunked": {"paged_attention": 0, "paged_attention_quant": 1092,
                     "flash_attention_chunk": 0,
                     "flash_attention_chunk_int8": 588},
    "bf16-whole-prompt": {"paged_attention": 868, "paged_attention_quant": 0,
                          "flash_attention_chunk": 0,
                          "flash_attention_chunk_int8": 0}}
# the GPTQ-loaded model (its engine synchronous) serves the bf16-chunked
# traffic and schedule
GPTQ_SERVE = ("gptq-chunked", SYNC, *SERVES[0][2:])
ATTENTION_LAUNCHES["gptq-chunked"] = ATTENTION_LAUNCHES["bf16-chunked"]
# R1's twin on the card: this serve's graphs-off run (the engine's
# defaults, every step eager, no PERF.md figure) goes under
# torch.cuda.set_sync_debug_mode("warn"), and every sync it warns of must
# lie in a function where the static checker's R1 reports a finding
SYNC_TWIN_SERVE = "bf16-chunked-async"
_SYNC_WARNING = "synchronizing CUDA operation"


def record_syncs(run):
    """``run()`` under ``torch.cuda.set_sync_debug_mode("warn")``: its
    result, and for each sync torch warned of the innermost frame of the
    call stack inside ``src/repro_torch`` as (path, line) (None for a
    sync the harness made itself)."""
    import traceback
    import warnings
    import torch
    port = str((ROOT / "src" / "repro_torch").resolve())
    frames = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if _SYNC_WARNING not in str(message):
            return
        inner = [f for f in traceback.extract_stack()[:-1]
                 if str(Path(f.filename).resolve()).startswith(port)]
        frames.append((inner[-1].filename, inner[-1].lineno)
                      if inner else None)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, frames


def check_syncs(frames, steps: int, label: str) -> dict:
    """Hold the syncs ``record_syncs`` saw to R1: each must lie in a
    function where ``repro_torch.analysis``'s R1 reports a finding
    (baselined or allowed); one that R1 does not see fails.  A control
    first: the once-per-tensor ``g_idx`` check of ``gptq_matmul`` on a
    fresh tensor is a sync R1 reports (``GptqMatmul._check_groups``), and
    must be recorded there, or the recording sees nothing."""
    import torch
    from repro_torch.analysis.project import Project
    from repro_torch.analysis.rules_sync import check_host_sync
    from repro_torch.kernels.gptq_matmul import gptq_matmul
    t0 = time.perf_counter()
    project = Project.from_root(ROOT)
    r1 = {(f.path, f.qualname) for f in check_host_sync(project)}
    g_idx = torch.arange(64, device="cuda", dtype=torch.int32) // 32
    _, control = record_syncs(lambda: gptq_matmul._check_groups(g_idx, 64,
                                                                32))
    control_sites = _sync_sites(project, control)
    if not any(s.endswith("(GptqMatmul._check_groups)")
               for s in control_sites):
        raise AssertionError(f"serve {label}: the control sync was not "
                             f"recorded at GptqMatmul._check_groups: "
                             f"{control}")
    sites = _sync_sites(project, frames)
    unseen = {s for s in sites
              if (s.split(":")[0], s[s.index("(") + 1:-1]) not in r1}
    n = sum(sites.values())
    rec = {"syncs": n, "harness_syncs": len(frames) - n,
           "syncs_per_step": n / max(steps, 1), "sites": sites,
           "control": control_sites,
           "r1_functions": sorted(f"{p}::{q}" for p, q in r1),
           "check_s": time.perf_counter() - t0}
    if unseen:
        raise AssertionError(f"serve {label}: syncs at {sorted(unseen)} lie "
                             "in no function where R1 reports a finding")
    return rec


def _sync_sites(project, frames) -> dict:
    """``path:line (function)`` -> count of the recorded port frames."""
    sites = {}
    for fr in frames:
        if fr is None:
            continue
        rel = Path(fr[0]).resolve().relative_to(ROOT.resolve()).as_posix()
        fn = project.by_rel[rel].function_at(fr[1]) \
            if rel in project.by_rel else None
        site = f"{rel}:{fr[1]} " \
            f"({fn.qualname if fn is not None else '<module>'})"
        sites[site] = sites.get(site, 0) + 1
    return sites


def phase_serve(dev: str, config: str = "qwen2-1.5b", reduced: bool = False,
                max_tokens: int = 32, kernels=(), label: str = "bf16-chunked",
                options=None, must=(), never=(), profile: bool = False,
                llm=None, quant="rtn-int4", lens=None,
                graphs_off: bool = False, state_keys=(),
                profile_off: bool = True, sync_twin: bool = False) -> dict:
    """Serve the 8 requests of ``serve_prompts`` (of ``lens`` tokens when
    given) on ``llm`` or, when none is given, on ``LLM.load(config,
    quant=quant, **options)``; request i asks for ``max_tokens - 3 i`` new
    tokens, or ``max_tokens[i]`` when it is a sequence.  On the card the
    peak of ``torch.cuda.max_memory_allocated`` over the load and over
    the whole phase is recorded.  The engine runs its defaults' step
    graphs (``capture_graphs``) unless ``options`` turns them off; with
    ``graphs_off`` the same traffic is then served again by a second
    engine over the same weights with graphs off (``"off"`` in the
    record), which must give the same tokens, and the runner's state
    entries ``state_keys`` after the serve within SERVE_STATE_TOL of
    graphs off's (``"state_on_off"``); that serve is re-run under the
    profiler too only with ``profile_off`` (its record then has the
    graphs-off profile: every check a profile feeds reads the graphs-on
    one).  With ``sync_twin`` the graphs-off serve runs under
    ``record_syncs``, held to R1."""
    import torch
    from repro_torch.serving import LLM
    card = dev != "cpu"
    if card:
        torch.cuda.reset_peak_memory_stats()
    if llm is None:
        t0 = time.perf_counter()
        llm = LLM.load(config, quant=quant, seed=0, device=dev,
                       reduced=reduced, **(options or {}))
        if card:
            torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    else:
        load_s = sum(llm.load_s.values())
    load_peak = torch.cuda.max_memory_allocated() if card else None
    prompts = serve_prompts(llm.cfg.vocab_size) if lens is None \
        else serve_prompts(llm.cfg.vocab_size, lens)
    out = serve_once(llm, prompts, max_tokens, kernels, label, options,
                     must, never, profile, state_keys)
    out.update(load_s=load_s, load_max_memory_allocated=load_peak)
    if graphs_off:
        engine_kw = {**(options or {}), "capture_graphs": False}
        off_llm = LLM(llm.cfg, llm.params, seed=0, device=dev, **engine_kw)
        out["off"] = off = serve_once(off_llm, prompts, max_tokens, kernels,
                                      label + "/graphs-off", engine_kw, must,
                                      never, profile and profile_off,
                                      state_keys, syncs=sync_twin)
        off_llm.close()
        del off_llm
        if off["tokens"] != out["tokens"]:
            raise AssertionError(
                f"serve {label}: tokens with graphs on differ from graphs "
                f"off (agreement {agreement(out['tokens'], off['tokens']):.3f})")
        on_st, off_st = out.pop("state"), off.pop("state")
        out["state_on_off"] = cmp = {
            k: {"rel_err": _rel(on_st[k], off_st[k]),
                "rms": off_st[k].pow(2).mean().sqrt().item(),
                "bitwise": torch.equal(on_st[k], off_st[k]),
                "finite": bool(torch.isfinite(on_st[k]).all())}
            for k in state_keys}
        del on_st, off_st
        if not all(c["finite"] and c["rms"] > 0
                   and c["rel_err"] <= SERVE_STATE_TOL for c in cmp.values()):
            raise AssertionError(
                f"serve {label}: the state after the serve with graphs on "
                f"against graphs off (largest error over RMS, limit "
                f"{SERVE_STATE_TOL}): {cmp}")
    del llm
    if card:
        torch.cuda.empty_cache()
    return out


def serve_once(llm, prompts, max_tokens, kernels, label, options, must,
               never, profile, state_keys=(), syncs: bool = False) -> dict:
    """One warm request, then the serve of ``prompts`` on ``llm`` with
    its checks (finished, in vocabulary, full length, its own kernels,
    the attention launches, a clean allocator audit), then optionally its
    profiled re-run; the record, with a CPU copy of the runner's state
    entries ``state_keys`` as the serve left them (``"state"``).  Step graphs: the kinds captured, each
    variant once, none in the re-run, and the seconds and graph-pool
    bytes they cost (the pool released after).  With ``syncs`` the serve
    runs under ``record_syncs`` and its syncs are held to R1
    (``"syncs"``)."""
    import torch
    from repro_torch.serving import SamplingParams
    card = llm.engine.runner.device.type == "cuda"
    vocab = llm.cfg.vocab_size
    if card:
        torch.cuda.reset_peak_memory_stats()
        start_alloc = torch.cuda.memory_allocated()
    llm.generate([list(range(1, 40))], SamplingParams(max_tokens=2))  # warm
    mts = list(max_tokens) if isinstance(max_tokens, (tuple, list)) \
        else [max_tokens - 3 * i for i in range(8)]
    sps = [SamplingParams(max_tokens=m) for m in mts]
    eng = llm.engine
    # chip_pair.py also serves older trees of the port through this
    # function: what their engine lacks (the runner's step counts, the
    # metrics registry, the span tracer, step graphs) is left out of their
    # record
    new_engine = hasattr(eng, "obs")
    graphed = getattr(eng.runner, "capture_graphs", False)
    base = {k: eng.metrics.get(k, 0)
            for k in ("gen_tokens", "prompt_tokens", "work_steps",
                      "device_dispatches", "decode_steps", "prefill_chunks",
                      "async_steps")}
    steps0 = dict(eng.runner.steps) if new_engine else {}
    # latency percentiles over this serve only
    hist = {k: eng.obs.get(f"repro_{k}_ms")
            for k in ("request_ttft", "itl")} if new_engine else {}
    for h in hist.values():
        h.clear_samples()
    for k in kernels:
        k.launches = 0
    t0_ns = time.perf_counter_ns()
    t0 = time.perf_counter()
    if syncs:
        outs, frames = record_syncs(lambda: llm.generate(prompts, sps))
    else:
        outs, frames = llm.generate(prompts, sps), None
    if card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    state = {k: eng.runner.state[k].float().cpu() for k in state_keys}
    m = {k: eng.metrics.get(k, 0) - v for k, v in base.items()}
    steps = {k: eng.runner.steps[k] - steps0[k] for k in steps0}
    sync_rec = None if frames is None \
        else check_syncs(frames, m["work_steps"], label)
    latency = {f"{k.split('_')[-1]}_p{q}_ms": h.percentile(q)
               for k, h in hist.items() for q in (50, 99)}
    attribution = {}
    if new_engine and eng.tracer.enabled:
        attribution = eng.attribution(window=max(m["work_steps"], 1))
        # the host's waits on the device for tokens (the "readback" spans)
        attribution["readback_ms_per_step"] = sum(
            sp.dur for sp in eng.tracer.spans()
            if sp.name == "readback" and sp.ts >= t0_ns) / 1e6 \
            / max(m["work_steps"], 1)
    bad = [o.request_id for o in outs
           if not o.finished or o.finish_reason not in ("length", "stop")]
    toks = [t for o in outs for t in o.token_ids]
    if bad:
        raise AssertionError(f"serve {label}: requests {bad} did not finish")
    if any(t < 0 or t >= vocab for t in toks):
        raise AssertionError(f"serve {label}: token -1 or out of vocabulary")
    if [len(o.token_ids) for o in outs] != [sp.max_tokens for sp in sps]:
        raise AssertionError(f"serve {label}: a request stopped short of "
                             "max_tokens")
    missing = [k for k in must if launches.get(k, 0) <= 0]
    stray = [k for k in never if launches.get(k, 0) > 0]
    if missing or stray:
        raise AssertionError(f"serve {label}: kernels {missing} never "
                             f"launched, {stray} launched off their path: "
                             f"{launches}")
    if kernels and new_engine:
        # each attention call launches its kernel once per attention
        # layer (a hybrid's RG-LRU layers launch none); a ring stack
        # decodes in plain torch (no decode kernel reads a ring)
        L = sum(llm.cfg.layer_kind(i) in ("full", "sliding")
                for i in range(llm.cfg.num_layers))
        int8 = eng.kv_cache_dtype == "int8"
        ring = getattr(eng.scheduler, "ring_only", False)
        want = {"paged_attention_quant" if int8 else "paged_attention":
                0 if ring else L * steps["decode"],
                "flash_attention_chunk_int8" if int8
                else "flash_attention_chunk": L * steps["chunk"],
                "flash_attention": L * steps["wave"]}
        got = {k: launches.get(k, 0) for k in want}
        if got != want:
            raise AssertionError(f"serve {label}: attention launches {got}, "
                                 f"want {want} ({L} x the runner's steps "
                                 f"{steps})")
    audit = eng.alloc.audit()
    if audit["live_blocks"] != 0:
        raise AssertionError(f"serve {label}: allocator audit not clean: "
                             f"{audit}")
    peak = torch.cuda.max_memory_allocated() if card else None
    graphs = eng.runner.graph_stats() if graphed else {}
    prof = profile_serve(llm, prompts, sps, outs, kernels,
                         tries=PROFILE_TRIES.get(label, 1)) if profile \
        else None
    accounting = check_launch_accounting(llm, kernels, label) \
        if profile and kernels and graphed else None
    if graphed:
        for kind, g in eng.runner.graph_stats().items():
            if g["captures"] != len(g["variants"]) \
                    or kind in graphs and g["captures"] \
                    != graphs[kind]["captures"]:
                raise AssertionError(
                    f"serve {label}: step graph {kind} captured "
                    f"{g['captures']} times for {len(g['variants'])} "
                    f"variants ({graphs.get(kind, {}).get('captures')} "
                    "before the re-run): a variant captured twice")
        graphs = eng.runner.graph_stats()
        # every fixed-shape step of this engine's mode ran from its graph
        want = {"megastep"} | ({"chained"} if eng.async_step else
                               {"unified"} if eng.unified else set())
        ran = {k for k, g in graphs.items() if g["captures"] + g["replays"]}
        if not want <= ran:
            raise AssertionError(f"serve {label}: step graphs {sorted(ran)} "
                                 f"ran, want {sorted(want)}")
    pool_bytes = None
    if graphed and card:
        # the graphs' private pool: what releasing them gives back
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_reserved()
        eng.runner.close()
        torch.cuda.empty_cache()
        pool_bytes = held - torch.cuda.memory_reserved()
    return {"label": label, "options": options or {}, "profile": prof,
            "config": llm.cfg.name, "layers": llm.cfg.num_layers,
            "requests": len(outs), "prompt_lens": [len(p) for p in prompts],
            "wall_s": wall, "max_memory_allocated": peak,
            "memory_allocated_at_start": start_alloc if card else None,
            "capture_graphs": graphed, "graphs": graphs,
            "capture_s": sum(g["capture_s"] for g in graphs.values()),
            "graph_pool_bytes": pool_bytes, "state": state,
            "gen_tokens": m["gen_tokens"], "prompt_tokens": m["prompt_tokens"],
            "gen_tok_s": m["gen_tokens"] / wall,
            "total_tok_s": (m["gen_tokens"] + m["prompt_tokens"]) / wall,
            "work_steps": m["work_steps"],
            "mean_step_ms": wall / max(m["work_steps"], 1) * 1e3,
            "dispatches_per_step": m["device_dispatches"]
            / max(m["work_steps"], 1),
            "decode_steps": m["decode_steps"],
            "prefill_chunks": m["prefill_chunks"],
            "async_steps": m["async_steps"], "runner_steps": steps,
            "latency": latency, "attribution": attribution,
            "kv_pool_bytes": eng.runner.kv_pool_bytes(),
            "blocks_reused": eng.alloc.stats["reused"], "audit": audit,
            "launches": launches, "launch_accounting": accounting,
            "syncs": sync_rec, "tokens": [o.token_ids for o in outs]}


# Our kernels' device functions (every instantiation) -> wrapper name; an
# int8 pool ("signed char") names the quantized entry.
OURS = {"paged_attention_": "paged_attention",
        "chunk_attention_": "flash_attention_chunk",
        "flash_attention_": "flash_attention", "gptq_": "gptq_matmul",
        # the split-K sum kernel of older trees (chip_pair.py serves them)
        "splitk_reduce_kernel": "gptq_matmul",
        "selective_scan_kernel": "selective_scan",
        "linear_scan_kernel": "linear_scan",
        "selective_scan_bwd_kernel": "selective_scan_bwd",
        "linear_scan_bwd_kernel": "linear_scan_bwd"}
INT8_NAMES = {"paged_attention": "paged_attention_quant",
              "flash_attention_chunk": "flash_attention_chunk_int8"}


def ours_name(key: str):
    """The wrapper whose kernel a profiler key names, or None."""
    for frag, name in OURS.items():
        if frag in key:
            return INT8_NAMES.get(name, name) if "signed char" in key \
                else name
    return None


# Profiled two-request windows per serve for the launch accounting: the
# profiler drops a kernel record now and then, so a window may read a few
# short; an accounting fault would read wrong in every window
ACCOUNTING_WINDOWS = 3
# The host's calls that start work on the device, as the profiler names
# its CUDA runtime (and driver) events
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch")


def _events(prof):
    """A profile's raw records as (name, on the device, device ms): read
    straight from the profiler's result, without building its Python
    event tree (seconds for the ~200,000 device records of a serve)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() == cuda
        yield e.name(), on_device, e.duration_ns() / 1e6 if on_device else 0.0


def _marked_window(prof, names) -> tuple:
    """From a profile holding one spin kernel (``torch.cuda._sleep``, the
    marker): each of ``names``' kernel records that started before the
    marker and after it, our device functions' records after it by their
    first 60 characters, and the host's calls among LAUNCH_CALLS."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    marks = [e.start_ns() for e in events
             if e.device_type() == cuda and "spin_kernel" in e.name()]
    if len(marks) != 1:
        raise AssertionError(f"launch accounting: {len(marks)} marker "
                             "kernels in the profile (want 1)")
    before, after = dict.fromkeys(names, 0), dict.fromkeys(names, 0)
    functions, calls = {}, {}
    for e in events:
        name = e.name()
        if e.device_type() != cuda:
            if name in LAUNCH_CALLS:
                calls[name] = calls.get(name, 0) + 1
            continue
        ours = ours_name(name)
        if ours not in after:
            continue
        if e.start_ns() < marks[0]:
            before[ours] += 1
        else:
            after[ours] += 1
            functions[name[:60]] = functions.get(name[:60], 0) + 1
    return before, after, functions, calls


def check_launch_accounting(llm, kernels, label: str) -> dict:
    """Two of serve_prompts' requests (8 new tokens each) served with the
    step graphs under ``torch.profiler``: each kernel's launches in the
    profiler's device records must equal its wrapper's counter over the
    same window (a replay adds the launches its capture recorded: this
    holds that accounting to the device's own record), and graphs must
    have been launched.  The window is padded by a synchronize and 0.5 s
    on both sides.  The profiler loses the first few kernel records of a
    session (an H100 at 700 W: 2 to 6 ``gptq_matmul`` records in the
    windows of four serves, eager or graphed, and the same six in every
    window of llava's late in the script), so inside the session a
    warm-up request runs first, then a marker kernel, and only the
    records after the marker are held to the counters, zeroed at the
    marker (the warm-up's own shortfall is logged).  A window that reads
    short is run again, up to ACCOUNTING_WINDOWS times; one must be
    exact, and none may read more than the counters."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import SamplingParams
    prompts = serve_prompts(llm.cfg.vocab_size)[:2]
    warm = [list(range(1, 25))]
    tries = []
    for _ in range(ACCOUNTING_WINDOWS):
        for k in kernels:
            k.launches = 0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            time.sleep(0.5)
            llm.generate(warm, SamplingParams(max_tokens=2))
            torch.cuda.synchronize()
            warm_counted = {k.name: k.launches for k in kernels}
            for k in kernels:
                k.launches = 0
            torch.cuda._sleep(1000)          # the marker
            llm.generate(prompts, SamplingParams(max_tokens=8))
            torch.cuda.synchronize()
            time.sleep(0.5)
        counted = {k.name: k.launches for k in kernels}
        warm_traced, traced, functions, calls = _marked_window(prof, counted)
        short = {k: n - traced[k] for k, n in counted.items()
                 if n != traced[k]}
        warm_short = {k: n - warm_traced[k] for k, n in warm_counted.items()
                      if n != warm_traced[k]}
        tries.append(short)
        if short or warm_short:      # what the window ran, for the record
            log(f"[profile] {label}: window short by {json.dumps(short)} "
                f"(the warm-up by {json.dumps(warm_short)}); host calls "
                f"{json.dumps(calls)}; records by function "
                f"{json.dumps(functions)}")
        if any(v < 0 for v in short.values()):
            raise AssertionError(f"serve {label}: more kernel launches in "
                                 f"the profiler's records {traced} than the "
                                 f"wrappers counted {counted}")
        if not calls.get("cudaGraphLaunch"):
            raise AssertionError(f"serve {label}: no cudaGraphLaunch with "
                                 f"graphs on: {calls}")
        if not short:
            break
    else:
        raise AssertionError(f"serve {label}: kernel launches in the "
                             f"profiler's records short of the wrappers' "
                             f"counters {counted} in every window: {tries}")
    return {"launches": counted, "records_short": tries,
            "host_launch_calls": calls}


# Serves whose profile's device-to-host copies main() compares (the int8
# serve may not copy more a step than the bf16 one): a session that lost
# device records may have lost a copy too, so such a serve is profiled
# again, up to this many sessions, until one loses none
PROFILE_TRIES = {"bf16-chunked": 3, "int8-chunked": 3}


def profile_serve(llm, prompts, sps, outs, kernels=(), tries: int = 1
                  ) -> dict:
    """Serve the same requests again under ``torch.profiler`` (after the
    launch counts were read) and sum the device time by kernel: ours, and
    every other kernel PyTorch launched; count the device-to-host copies
    per engine step, the copies from or to pageable host memory and the
    host's launch calls (kernels and graphs) per step.  Also checks the
    re-run's tokens against the first run's (greedy: identical).  The
    profiler loses a few of the ~200,000 device records of a serve
    (``records_lost``: our kernels' counters less their records), so the
    busy time may read low by about that share; with ``tries`` > 1 a
    session that lost records is repeated, up to ``tries`` sessions, and
    the last one read (``sessions``)."""
    for session in range(1, tries + 1):
        out = _profile_session(llm, prompts, sps, outs, kernels)
        if not out["records_lost"]:
            break
    out["sessions"] = session
    return out


def _profile_session(llm, prompts, sps, outs, kernels) -> dict:
    """One profiled re-run of the serve: ``profile_serve``'s record."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    steps0 = llm.engine.metrics["work_steps"]
    for k in kernels:
        k.launches = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        again = llm.generate(prompts, sps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counted = {k.name: k.launches for k in kernels}
    steps = llm.engine.metrics["work_steps"] - steps0
    if [o.token_ids for o in again] != [o.token_ids for o in outs]:
        raise AssertionError("serve: the profiled re-run changed tokens")
    by, dtoh, pageable, ops, calls = {}, 0, 0, 0, {}
    for name, on_device, ms in _events(prof):
        if not on_device:
            if name in LAUNCH_CALLS:
                calls[name] = calls.get(name, 0) + 1
            continue
        ops += 1
        if "Memcpy DtoH" in name:
            dtoh += 1
        # a copy from or to pageable host memory blocks the host on the
        # stream: it would stall the async engine's pipeline
        if "Memcpy" in name and "Pageable" in name:
            pageable += 1
        key = ours_name(name) or name[:60]
        t, n = by.get(key, (0.0, 0))
        by[key] = (t + ms, n + 1)
    traced = {k: by.get(k, (0.0, 0))[1] for k in counted}
    busy = sum(ms for ms, _ in by.values())
    top = sorted(by.items(), key=lambda kv: -kv[1][0])[:12]
    n_calls = sum(calls.values())
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / (wall * 1e3),
            "work_steps": steps, "dtoh_copies": dtoh,
            "dtoh_per_step": dtoh / max(steps, 1),
            "pageable_copies": pageable,
            "device_ops_per_step": ops / max(steps, 1),
            "host_launch_calls": calls,
            "host_launches_per_step": n_calls / max(steps, 1)
            if n_calls else None,
            "records_lost": sum(counted.values()) - sum(traced.values()),
            "ours_ms": {v: by[v][0] for v in
                        (*OURS.values(), *INT8_NAMES.values()) if v in by},
            "top": [{"kernel": k, "ms": ms, "calls": n}
                    for k, (ms, n) in top]}


# --------------------------------------------------------------------------
# Phase 5: GPTQ (Hessian OBQ over calibration activations)
# --------------------------------------------------------------------------

CALIB_N, CALIB_B, CALIB_S = 8, 4, 512   # calibration batches of [4, 512]
OBQ_CODES_EQUAL = 0.9999      # card OBQ vs CPU OBQ, share of equal codes
OBQ_ERR_REL = 1e-6            # card vs CPU proxy loss, relative
GPTQ_LOGIT_RATIO = 1.25       # tests/test_quantized_model.py:67
# merged wk / wv, card vs CPU, relative to the CPU's max |wk|, |wv|: a
# plain (unweighted) merge reads ~3e-3 of it, f32 rounding ~1e-7
GROUPING_TOL_REL = 1e-5


def gptq_load(kernels, dev: str = "cuda", reduced: bool = False,
              config: str = "qwen2-1.5b", options=None):
    """(b) ``LLM.load(config, quant="gptq-int4")`` at full depth on
    CALIB_N x [CALIB_B, CALIB_S] seeded calibration tokens, with the
    engine ``options`` (SYNC when None).  The launch counters are zeroed
    just before the load: the calibration forward must launch the static
    ``flash_attention`` once per layer and batch, and nothing else; every
    leaf of the served params lies on ``dev``.  On the card the peak of
    ``torch.cuda.max_memory_allocated`` over the load is recorded."""
    import torch
    from repro_torch.configs.registry import get_config, get_reduced
    from repro_torch.models import transformer as T
    from repro_torch.serving import LLM
    from repro_torch.serving.llm import _synthetic_calib
    cfg = get_reduced(config) if reduced else get_config(config)
    calib = _synthetic_calib(cfg, 1, CALIB_N, CALIB_B, CALIB_S)
    for k in kernels:
        k.launches = 0
    if dev != "cpu":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    llm = LLM.load(config, quant="gptq-int4", seed=0, reduced=reduced,
                   calib_batches=calib, device=dev,
                   **(SYNC if options is None else options))
    if dev != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if dev != "cpu" else None
    launches = {k.name: k.launches for k in kernels}
    want = {k.name: 0 for k in kernels}
    if dev != "cpu":
        want["flash_attention"] = cfg.num_layers * CALIB_N
    if launches != want:
        raise AssertionError(f"gptq load: launches {launches}, want {want}")
    off = {str(t.device) for t in T._leaves(llm.params)
           if t.device.type != torch.device(dev).type}
    if off:
        raise AssertionError(f"gptq load: params left on {off}")
    return llm, calib, {"wall_s": wall, "load_s": llm.load_s,
                        "launches": launches, "max_memory_allocated": peak}


def _qt_of(layer_params: dict, names, din: int):
    """The int4 dicts of ``names`` (one layer) as one QuantizedTensor,
    concatenated along the output axis."""
    import torch
    from repro_torch.core.gptq import QuantizedTensor
    from repro_torch.core.quant import unpack_int4
    ds = [layer_params[n] for n in names]
    return QuantizedTensor(
        q=torch.cat([unpack_int4(d["qweight"], din) for d in ds], 1),
        scales=torch.cat([d["scales"] for d in ds], 1),
        zeros=torch.cat([d["zeros"] for d in ds], 1),
        g_idx=ds[0]["g_idx"], bits=4)


def gptq_quality(llm, calib, dev: str = "cuda",
                 obq=("mlp", "w_gate")) -> dict:
    """(b) GPTQ's Hessian-weighted proxy loss against RTN's (group size
    GS, ``quantize_params_rtn``) on the same dense weights, for every
    (layer, Hessian) pair (qwen2-1.5b's 56, h2o-danube's 48): wq|wk|wv
    under the attention-input Hessian, w_gate|w_up under the MLP-input
    one.  The dense weights and Hessians are made again from the load's
    seed and calibration tokens.  Then (a): layer 0's ``obq`` weight
    (block, name; qwen2-1.5b's w_gate [1536, 8960]) through the port's
    OBQ on the card and on the CPU, the same float64 W and its block's
    Hessian."""
    import torch
    from repro_torch.configs.base import QuantConfig
    from repro_torch.core.gptq import quant_error
    from repro_torch.models import transformer as T
    from repro_torch.models.quantize import (calibration_hessians,
                                             quantize_params_rtn)
    cfg = llm.cfg
    d = cfg.d_model
    dense = T.init_params(cfg, 0, dev)
    hess = calibration_hessians(cfg, dense, calib)
    rtn = T.split_layers(quantize_params_rtn(dense, cfg, GS))
    dl = T.split_layers(dense)["layers"]
    rows, e_gptq, e_rtn = [], 0.0, 0.0
    for i, pair in enumerate(hess):
        for h, block, names in zip(pair, ("attn", "mlp"),
                                   (("wq", "wk", "wv"), ("w_gate", "w_up"))):
            w = torch.cat([dl[i][block][n].reshape(d, -1) for n in names], 1)
            eg = quant_error(w, _qt_of(llm.params["layers"][i][block], names,
                                       d), h.h)
            er = quant_error(w, _qt_of(rtn["layers"][i][block], names, d),
                             h.h)
            rows.append({"layer": i, "hessian": block, "gptq": eg,
                         "rtn": er, "ratio": eg / er})
            e_gptq += eg
            e_rtn += er
    ratios = [r["ratio"] for r in rows]
    out = {"pairs": len(rows), "gptq_sum": e_gptq, "rtn_sum": e_rtn,
           "sum_ratio": e_gptq / e_rtn, "ratio_min": min(ratios),
           "ratio_max": max(ratios), "per_pair": rows,
           "hessians_vs_cpu": hessian_replay(cfg, dense, calib, hess[0])}
    if not e_gptq < e_rtn:
        raise AssertionError(f"gptq: summed Hessian loss {e_gptq} not below "
                             f"RTN's {e_rtn}")

    # (a) card OBQ against CPU OBQ, one full-width weight
    qcfg = QuantConfig(bits=4, group_size=GS)
    block, name = obq
    w = dl[0][block][name].reshape(d, -1).double()
    h = hess[0][0 if block == "attn" else 1].h
    card, card_s = _timed_obq(w, h, qcfg)
    cpu, cpu_s = _timed_obq(w.cpu(), h.cpu(), qcfg)
    equal = float((card.q.cpu() == cpu.q).float().mean())
    same_sz = (torch.equal(card.scales.cpu(), cpu.scales)
               and torch.equal(card.zeros.cpu(), cpu.zeros))
    e_card = quant_error(w, card, h)
    e_cpu = quant_error(w.cpu(), cpu, h.cpu())
    rel = abs(e_card - e_cpu) / e_cpu
    # the load quantized the weight in one loop with its block's others:
    # its codes
    loaded = _qt_of(llm.params["layers"][0][block], (name,), d)
    out["obq"] = {"weight": name, "shape": list(w.shape), "card_s": card_s,
                  "cpu_s": cpu_s, "codes_equal": equal,
                  "scales_zeros_equal": same_sz, "err_card": e_card,
                  "err_cpu": e_cpu, "err_rel": rel,
                  "load_codes_equal": float((loaded.q.cpu()
                                             == cpu.q).float().mean()),
                  "rtn_err": quant_error(w, _qt_of(rtn["layers"][0][block],
                                                   (name,), d), h)}
    if not (equal >= OBQ_CODES_EQUAL and same_sz and rel <= OBQ_ERR_REL):
        raise AssertionError(f"gptq: card OBQ vs CPU OBQ: {out['obq']}")
    return out


# card (bf16 activations) vs a CPU float64 replay, relative Frobenius; on
# an H100 the full-width layer 0 reads 1.02e-3 (attention input) and
# 4.21e-3 (MLP input)
HESSIAN_TOL_REL = 1e-2


def hessian_replay(cfg, dense, calib, card_pair) -> dict:
    """C7: layer 0's two calibration Hessians as the card built them
    (``card_pair``: attention input, MLP input) against a float64 replay
    on the CPU of the same calibration tokens through the same layer,
    written out here (RMSNorm, q/k/v with bias, NeoX RoPE, causal GQA
    attention inside the config's sliding window, wo, residual): relative
    Frobenius difference of each."""
    import torch
    from repro_torch.models import transformer as T
    lp = {k: {n: t.cpu().double() for n, t in v.items()}
          for k, v in T._layer(dense, 0).items()}
    a = lp["attn"]

    def rms(x, w):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True)
                               + cfg.norm_eps) * w
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    d = cfg.d_model
    acc = [torch.zeros((d, d), dtype=torch.float64) for _ in range(2)]
    n = 0
    t0 = time.perf_counter()
    for batch in calib:
        toks = torch.as_tensor(batch["tokens"]).long()
        x = dense["embed"][toks.to(dense["embed"].device)].cpu().double()
        B, S, _ = x.shape
        h = rms(x, lp["attn_norm"]["w"])
        q = torch.einsum("bsd,dhk->bshk", h, a["wq"])
        k = torch.einsum("bsd,dhk->bshk", h, a["wk"])
        v = torch.einsum("bsd,dhk->bshk", h, a["wv"])
        if cfg.qkv_bias:
            q, k, v = q + a["bq"], k + a["bk"], v + a["bv"]
        d2 = Dh // 2
        freqs = cfg.rope_theta ** (-torch.arange(d2, dtype=torch.float64)
                                   / d2)
        ang = torch.arange(S, dtype=torch.float64)[:, None] * freqs
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]

        def rope(t):
            t1, t2 = t[..., :d2], t[..., d2:]
            return torch.cat([t1 * cos - t2 * sin, t1 * sin + t2 * cos], -1)
        q, k = rope(q), rope(k)
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
        sc = torch.einsum("bqhd,bkhd->bhqk", q, k) / Dh ** 0.5
        ahead = torch.ones(S, S, dtype=torch.bool).triu(1)
        if cfg.sliding_window:
            ahead |= torch.ones(S, S, dtype=torch.bool).tril(
                -cfg.sliding_window)
        sc = sc.masked_fill(ahead, float("-inf"))
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1), v)
        x = x + torch.einsum("bshk,hkd->bsd", o, a["wo"])
        h2 = rms(x, lp["mlp_norm"]["w"])
        for i, t in enumerate((h, h2)):
            t = t.reshape(-1, d)
            acc[i] += t.T @ t
        n += B * S
    rows = {}
    for name, card, cpu in zip(("attn", "mlp"), card_pair, acc):
        cpu = cpu * (2.0 / n)
        diff = (card.h.cpu() - cpu).norm() / cpu.norm()
        rows[name] = {"rel_frobenius": diff.item(),
                      "max_abs_diff": (card.h.cpu() - cpu).abs().max().item(),
                      "max_abs": cpu.abs().max().item()}
    out = {"tokens": n, "cpu_s": time.perf_counter() - t0,
           "limit": HESSIAN_TOL_REL, **rows}
    if not all(r["rel_frobenius"] <= HESSIAN_TOL_REL for r in rows.values()):
        raise AssertionError(f"gptq: layer-0 Hessians card vs CPU {out}")
    return out


def _timed_obq(w, h, qcfg):
    """The port's OBQ of one weight on w's device, and its seconds."""
    import torch
    from repro_torch.core.gptq import gptq_quantize
    sync = torch.cuda.synchronize if w.is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    qt = gptq_quantize(w, h, qcfg)
    sync()
    return qt, time.perf_counter() - t0


def gptq_logits(calib, dev: str = "cuda", ref_dev: str = "cpu",
                layers: int = 2) -> dict:
    """(c) The 2-layer full-width model, GPTQ-quantized on ``dev`` over
    ``calib``: ``T.forward`` on a held-out [2, 256] batch on ``dev`` and on
    ``ref_dev`` within LOGIT_TOL; then, on ``dev``, the mean |GPTQ - dense|
    logit error below GPTQ_LOGIT_RATIO x RTN's."""
    import torch
    from repro_torch.bridge import tree_to
    from repro_torch.configs.base import QuantConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.quantize import (gptq_quantize_model,
                                             quantize_params_rtn)
    cfg = get_config("qwen2-1.5b").replace(num_layers=layers)
    dense = T.init_params(cfg, 1, dev)
    gptq = gptq_quantize_model(cfg, dense, calib,
                               QuantConfig(bits=4, group_size=GS))
    rtn = quantize_params_rtn(dense, cfg, GS)
    gen = torch.Generator().manual_seed(7)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 256),
                                     generator=gen)}
    with torch.no_grad():
        lf = T.forward(cfg, dense, batch).float()
        lg = T.forward(cfg, gptq, batch).float()
        lr = T.forward(cfg, rtn, batch).float()
        ref = T.forward(cfg, tree_to(gptq, ref_dev), batch).float()
    err = (lg.cpu() - ref.cpu()).abs().max().item()
    eg = (lg - lf).abs().mean().item()
    er = (lr - lf).abs().mean().item()
    out = {"layers": layers, "card_vs_cpu_max_abs_err": err,
           "max_abs_logit": ref.abs().max().item(), "tolerance": LOGIT_TOL,
           "mean_abs_err_gptq": eg, "mean_abs_err_rtn": er,
           "ratio": eg / er, "ratio_limit": GPTQ_LOGIT_RATIO,
           "greedy_agreement_gptq_dense": float(
               (lg.argmax(-1) == lf.argmax(-1)).float().mean()),
           "greedy_agreement_rtn_dense": float(
               (lr.argmax(-1) == lf.argmax(-1)).float().mean())}
    if not (err <= LOGIT_TOL and bool(torch.isfinite(lg).all())):
        raise AssertionError(f"gptq logits: card vs CPU {out}")
    if not eg < GPTQ_LOGIT_RATIO * er:
        raise AssertionError(f"gptq logits: GPTQ error not below "
                             f"{GPTQ_LOGIT_RATIO} x RTN's: {out}")
    return out


def gqa_conversion(dev: str = "cuda", kv: int = 4) -> dict:
    """(d) One full-width qwen1.5-0.5b MHA layer (16 heads, head dim 64),
    key activations of [4, 512] tokens, converted to ``kv`` KV heads by
    activation similarity on ``dev`` and on the CPU: the same groups,
    merged wk / wv within GROUPING_TOL_REL of the CPU's largest entry, a
    limit that a plain (unweighted) merge must exceed."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.grouping import convert_mha_to_gqa
    from repro_torch.models import transformer as T
    cfg = get_config("qwen1.5-0.5b").replace(num_layers=1)
    params = T.init_params(cfg, 2, dev)
    a = {k: params["layers"]["attn"][k][0] for k in ("wq", "wk", "wv")}
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (4, 512), generator=gen)
    x = params["embed"][toks.to(dev)].float()
    H, Dh = cfg.num_heads, cfg.resolved_head_dim
    acts = torch.einsum("bsd,dhk->hbsk", x, a["wk"]).reshape(H, -1, Dh)
    t0 = time.perf_counter()
    got = convert_mha_to_gqa(a["wq"], a["wk"], a["wv"], acts, kv)
    card_s = time.perf_counter() - t0
    want = convert_mha_to_gqa(*(a[k].cpu() for k in ("wq", "wk", "wv")),
                              acts.cpu(), kv)
    err = max((got.wk.cpu() - want.wk).abs().max().item(),
              (got.wv.cpu() - want.wv).abs().max().item())
    tol = GROUPING_TOL_REL * max(want.wk.abs().max().item(),
                                 want.wv.abs().max().item())
    # what a wrong merge (plain mean, same groups) reads: the limit must fail it
    plain = convert_mha_to_gqa(*(a[k].cpu() for k in ("wq", "wk", "wv")),
                               acts.cpu(), kv, weighted=False)
    wrong = max((plain.wk - want.wk).abs().max().item(),
                (plain.wv - want.wv).abs().max().item())
    out = {"heads": H, "head_dim": Dh, "kv_heads": kv,
           "groups": got.groups, "same_groups": got.groups == want.groups,
           "merged_max_abs_err": err, "tolerance": tol,
           "plain_merge_max_abs_err": wrong,
           "intra_sim": got.intra_sim, "inter_sim": got.inter_sim,
           "wk": list(got.wk.shape), "card_s": card_s}
    if not (out["same_groups"] and err <= tol < wrong):
        raise AssertionError(f"grouping: card vs CPU {out}")
    return out


def check_async_serve(serve: dict, sync: dict) -> None:
    """The async pipelined serve against the synchronous serve of the same
    traffic (bf16-chunked-async against bf16-chunked, moe-chunked-async
    against moe-chunked): the same greedy tokens (fixed shapes and
    bitwise-repeatable kernels, so a difference is the pipeline's fault),
    pipelined steps taken, and no copy from or to pageable host memory
    (which would block the host behind the in-flight dispatch)."""
    a, b = serve["label"], sync["label"]
    if serve["tokens"] != sync["tokens"]:
        raise AssertionError(
            f"serve {a}: tokens differ from {b}'s (agreement "
            f"{agreement(serve['tokens'], sync['tokens']):.3f})")
    if not serve["async_steps"] > 0:
        raise AssertionError(f"serve {a}: no pipelined step")
    if serve["profile"]["pageable_copies"] != 0:
        raise AssertionError(
            f"serve {a}: {serve['profile']['pageable_copies']} pageable "
            "memcpys under the profiler (want 0)")
    log(f"[serve] {a}: tokens equal {b}'s; async_steps="
        f"{serve['async_steps']}, no pageable memcpy; wall "
        f"{serve['wall_s']:.3f} s against {sync['wall_s']:.3f} s")


def pair_async_sync(dev: str = "cuda", reduced: bool = False) -> dict:
    """The bf16-chunked traffic on the synchronous engine and on the
    async one (the defaults), two engines loaded side by side from the
    same seed and served in turns sync, async, async, sync after a warm
    serve each, so both see the same host: the walls of each turn."""
    import torch
    from repro_torch.serving import LLM, SamplingParams
    llms = {"sync": LLM.load("qwen2-1.5b", quant="rtn-int4", seed=0,
                             device=dev, reduced=reduced, **SYNC),
            "async": LLM.load("qwen2-1.5b", quant="rtn-int4", seed=0,
                              device=dev, reduced=reduced)}
    prompts = serve_prompts(llms["sync"].cfg.vocab_size)
    sps = [SamplingParams(max_tokens=32 - 3 * i) for i in range(8)]
    for llm in llms.values():
        llm.generate(prompts, sps)
    walls = {"sync": [], "async": []}
    for mode in ("sync", "async", "async", "sync"):
        t0 = time.perf_counter()
        llms[mode].generate(prompts, sps)
        if dev != "cpu":
            torch.cuda.synchronize()
        walls[mode].append(time.perf_counter() - t0)
    for llm in llms.values():
        llm.close()
    return {"walls_s": walls,
            "async_over_sync": sum(walls["async"]) / sum(walls["sync"])}


def agreement(a, b) -> float:
    """Share of generated tokens two serves agree on, position by
    position (printed, never asserted: near-ties flip greedy tokens)."""
    pairs = [(x, y) for ta, tb in zip(a, b) for x, y in zip(ta, tb)]
    return sum(x == y for x, y in pairs) / max(len(pairs), 1)


def phase_gptq(report: dict, kernels):
    """Phase 5, on the card: (b) the full GPTQ load and its proxy loss
    against RTN's, (a) card OBQ against CPU OBQ, (c) 2-layer logits, (d)
    a full-width MHA -> GQA conversion.  Returns the loaded ``LLM``."""
    g = report["gptq"] = {}
    t0 = time.perf_counter()
    llm, calib, g["load"] = gptq_load(kernels)
    ls = g["load"]["load_s"]
    log(f"[gptq] LLM.load qwen2-1.5b gptq-int4 x{llm.cfg.num_layers} layers, "
        f"calibration {CALIB_N} x [{CALIB_B}, {CALIB_S}] tokens: "
        f"wall_s={g['load']['wall_s']:.2f} "
        + " ".join(f"{k}_s={v:.2f}" for k, v in ls.items())
        + f" launches={json.dumps(g['load']['launches'])}")
    g["quality"] = q = gptq_quality(llm, calib)
    log(f"[gptq] layer-0 Hessians, card vs CPU float64 replay: "
        f"{json.dumps(q['hessians_vs_cpu'])}")
    o = q["obq"]
    log(f"[gptq] Hessian loss over {q['pairs']} (layer, Hessian) pairs: "
        f"gptq_sum={q['gptq_sum']:.6e} rtn_sum={q['rtn_sum']:.6e} "
        f"ratio={q['sum_ratio']:.4f} per-pair ratio "
        f"{q['ratio_min']:.4f}..{q['ratio_max']:.4f}")
    log(f"[gptq] OBQ of {o['weight']} {o['shape']}: card_s={o['card_s']:.3f} "
        f"cpu_s={o['cpu_s']:.3f} codes_equal={o['codes_equal']:.6f} "
        f"scales_zeros_equal={o['scales_zeros_equal']} "
        f"err_rel={o['err_rel']:.3e} (gptq {o['err_card']:.6e}, rtn "
        f"{o['rtn_err']:.6e}); codes equal to the load's (one loop with "
        f"w_up): {o['load_codes_equal']:.6f}")
    g["logits"] = lg = gptq_logits(calib)
    log(f"[gptq] 2-layer full-width logits: {json.dumps(lg)}")
    g["grouping"] = gr = gqa_conversion()
    log(f"[gptq] MHA -> GQA qwen1.5-0.5b layer: {json.dumps(gr)}")
    g["phase_s"] = time.perf_counter() - t0
    return llm


# --------------------------------------------------------------------------
# Phase 6: the MoE family (qwen2-moe-a2.7b) and the checkpoint reader
# --------------------------------------------------------------------------

MOE = "qwen2-moe-a2.7b"
MOE_HEADS = (16, 16)          # its 16 query heads over 16 KV heads: G = 1
# the attention kernels at the MoE model's heads: (check, label)
MOE_KERNEL_CHECKS = (
    (check_paged_attention, "paged_attention[G=1]"),
    (check_paged_attention_quant, "paged_attention_quant[G=1]"),
    (check_flash_attention_chunk, "flash_attention_chunk[G=1]"),
    (check_flash_attention_chunk_int8, "flash_attention_chunk_int8[G=1]"))
MOE_ROWS = (8, 256)           # a decode step's rows, a chunk's
# the f32 model check card vs CPU at full width, cut to 1 layer (its CPU
# side took ~37 s at 2 layers: ROADMAP C16)
MOE_MODEL_LAYERS = 1
MOE_BF16 = {"paged_attention", "flash_attention_chunk"}
MOE_INT8 = {"paged_attention_quant", "flash_attention_chunk_int8"}
# The MoE serves (bf16 weights, the reference's only MoE mode), full
# depth, on serve_prompts' traffic: (label, LLM.load options, kernels that
# must launch, kernels that must not).  No int4 matmul, no static
# attention: chunked prefill over the paged pool only.
MOE_SERVES = (
    ("moe-chunked-async", {}, MOE_BF16,
     MOE_INT8 | {"flash_attention", "gptq_matmul"} | SCAN_KERNELS),
    ("moe-chunked", SYNC, MOE_BF16,
     MOE_INT8 | {"flash_attention", "gptq_matmul"} | SCAN_KERNELS),
    ("moe-int8-chunked", {**SYNC, "kv_cache_dtype": "int8"}, MOE_INT8,
     MOE_BF16 | {"flash_attention", "gptq_matmul"} | SCAN_KERNELS))


def check_moe_ffn(gen) -> dict:
    """One full-width layer's ``moe_apply`` in bf16 (60 experts, top-4,
    4 shared) at MOE_ROWS tokens against ``moe_apply_dense_ref`` (every
    expert on every token) on the card: outputs within TOL of the largest
    entry, two calls bitwise equal.  Both take ``_route``'s ids; the ids
    must be k distinct real experts per token.  Timed beside the dense
    reference and the bound, whose bytes are the experts this routing
    touches (3 x d x f bf16 each) plus the shared experts, the router and
    x in and out; its operations 2 x rows x k x 3 x d x f plus the shared
    and router products.  The routed products are ``torch._grouped_mm``
    (the reference's ``ragged_dot`` is XLA, not a Pallas kernel)."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    cfg = get_config(MOE)
    d, f, k = cfg.d_model, cfg.moe_d_ff, cfg.moe_top_k
    fs = cfg.num_shared_experts * f
    lp = T.cast_params(M.moe_init(torch.Generator(device="cuda")
                                  .manual_seed(3), cfg, "cuda"),
                       torch.bfloat16)
    rows_out = []
    for n in MOE_ROWS:
        x = torch.randn((n, 1, d), generator=gen, device="cuda").bfloat16()
        ids, _ = M._route(cfg, lp, x.reshape(-1, d))
        srt = ids.sort(-1).values
        if not (bool((srt[:, 1:] != srt[:, :-1]).all())
                and int(ids.min()) >= 0 and int(ids.max()) < cfg.num_experts):
            raise AssertionError(f"moe_apply rows {n}: routing ids {ids}")
        out = M.moe_apply(cfg, lp, x)
        want = M.moe_apply_dense_ref(cfg, lp, x)
        torch.cuda.synchronize()
        scale = want.float().abs().max().item()
        err = (out.float() - want.float()).abs().max().item()
        if not err <= TOL * scale:
            raise AssertionError(f"moe_apply rows {n}: max err {err} (tol "
                                 f"{TOL} x max|ref| {scale})")
        _repeat_equal("moe_apply", f"rows {n}",
                      lambda: M.moe_apply(cfg, lp, x), out)
        touched = int(ids.unique().numel())
        nbytes = 2 * (touched * 3 * d * f + 3 * d * fs + d * cfg.num_experts
                      + 2 * n * d)
        flops = 2 * n * (k * 3 * d * f + 3 * d * fs + d * cfg.num_experts)
        row = {"rows": n, "experts_touched": touched, "max_abs_err": err,
               "max_abs_ref": scale,
               "ms": time_ms(lambda: M.moe_apply(cfg, lp, x)),
               "plain_ms": time_ms(lambda: M.moe_apply_dense_ref(cfg, lp, x),
                                   iters=3),
               "bound": bound_ms(nbytes, flops)}
        rows_out.append(row)
        log(f"[moe] one layer's moe_apply, {n} rows x 1, bf16: "
            f"experts touched {touched} of {cfg.num_experts}, "
            f"ms={row['ms']:.4f} dense_ref_ms={row['plain_ms']:.4f} "
            f"bound_ms={row['bound'][0]:.5f} ({row['bound'][1]}) "
            f"max_abs_err={err:.3e} (max|ref| {scale:.3e})")
    return {"name": "moe_apply (torch._grouped_mm)", "rows": rows_out}


def write_checkpoint(directory: Path, step: int, params) -> None:
    """The JAX package's ``Checkpointer`` layout, written with numpy:
    ``step_<N:08d>/manifest.json`` and one ``.npy`` per leaf of the
    ``params`` tree (``params.<dotted path>``, characters outside
    ``[A-Za-z0-9_.-]`` as ``_``)."""
    import re
    import numpy as np

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {p: v for k, t in tree.items()
                    for p, v in flat(t, f"{prefix}.{k}" if prefix
                                     else k).items()}
        return {prefix: tree}
    leaves = flat(params)
    out = directory / f"step_{step:08d}"
    out.mkdir(parents=True)
    for path, t in leaves.items():
        name = re.sub(r"[^A-Za-z0-9_.-]", "_", f"params.{path}") + ".npy"
        np.save(out / name, t.cpu().numpy())
    (out / "manifest.json").write_text(json.dumps(
        {"step": step, "trees": {"params": sorted(leaves)}, "extra": {}}))


CKPT_LAYERS = 2


def phase_checkpoint(dev: str = "cuda") -> dict:
    """Full-width qwen2-1.5b cut to CKPT_LAYERS layers: seeded f32 params
    written by ``write_checkpoint`` under ``build/`` (removed after), read
    back by ``LLM.load(checkpoint=...)`` on ``dev``; its greedy tokens on
    serve_prompts' traffic (8 new tokens each) must equal those of an
    ``LLM`` built on the same params in memory."""
    import shutil
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import LLM, SamplingParams
    cfg = get_config("qwen2-1.5b").replace(num_layers=CKPT_LAYERS)
    params = T.init_params(cfg, 4, dev)
    directory = ROOT / "build" / "checkpoint_smoke"
    shutil.rmtree(directory, ignore_errors=True)
    prompts = serve_prompts(cfg.vocab_size)
    sps = SamplingParams(max_tokens=8)
    try:
        t0 = time.perf_counter()
        write_checkpoint(directory, 7, params)
        write_s = time.perf_counter() - t0
        nbytes = sum(p.stat().st_size for p in directory.rglob("*"))
        t0 = time.perf_counter()
        llm = LLM.load("qwen2-1.5b", checkpoint=str(directory), device=dev,
                       overrides={"num_layers": CKPT_LAYERS}, **SYNC)
        if dev != "cpu":
            torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        got = [o.token_ids for o in llm.generate(prompts, sps)]
        llm.close()
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    ref = LLM(cfg, params, seed=0, device=dev, **SYNC)
    want = [o.token_ids for o in ref.generate(prompts, sps)]
    ref.close()
    out = {"config": cfg.name, "layers": CKPT_LAYERS, "bytes": nbytes,
           "write_s": write_s, "load_s": load_s, "tokens_equal": got == want,
           "tokens": got}
    if got != want:
        raise AssertionError(f"checkpoint: greedy tokens differ from the "
                             f"in-memory params' ({agreement(got, want):.3f})")
    return out


def log_serve(label: str, serve: dict, quant) -> None:
    """One serve's record, and its profiled re-run's, on the log; then
    the same for its graphs-off serve, if it has one."""
    log(f"[serve] {label}: {serve['config']} x{serve['layers']} layers "
        f"{quant} {json.dumps(serve['options'])}: {serve['requests']} "
        f"requests, {serve['gen_tokens']} new tokens in "
        f"{serve['wall_s']:.2f} s: gen_tok_s={serve['gen_tok_s']:.1f} "
        f"total_tok_s={serve['total_tok_s']:.1f} "
        f"mean_step_ms={serve['mean_step_ms']:.2f} "
        f"steps={serve['work_steps']} "
        f"dispatches_per_step={serve['dispatches_per_step']:.2f} "
        f"kv_pool_bytes={serve['kv_pool_bytes']} "
        f"async_steps={serve['async_steps']} "
        f"runner_steps={json.dumps(serve['runner_steps'])} "
        f"launches={serve['launches']} audit={serve['audit']}")
    log(f"[serve] {label}: load_s={serve.get('load_s', 0.0):.2f} "
        f"load_max_memory_allocated={serve.get('load_max_memory_allocated')} "
        f"max_memory_allocated={serve['max_memory_allocated']} "
        f"latency {json.dumps(serve['latency'])} "
        f"attribution {json.dumps(serve['attribution'])}")
    captures = {k: g["captures"] for k, g in serve["graphs"].items()}
    log(f"[graphs] {label}: capture_graphs={serve['capture_graphs']} "
        f"captures per kind {json.dumps(captures)} "
        f"capture_s={serve['capture_s']:.3f} "
        f"graph_pool_bytes={serve['graph_pool_bytes']} "
        f"graphs {json.dumps(serve['graphs'])}")
    prof = serve["profile"]
    if prof is None:
        log(f"[profile] {label}: not re-run under the profiler")
    else:
        log_profile(label, prof)
    acc = serve["launch_accounting"]
    if acc is not None:
        log(f"[profile] {label}: two requests profiled "
            f"{len(acc['records_short'])} time(s), kernel records equal "
            f"the counters {json.dumps(acc['launches'])}; host calls (the "
            f"warm-up's and the marker's included) "
            f"{json.dumps(acc['host_launch_calls'])}")
    if serve.get("syncs") is not None:
        sy = serve["syncs"]
        log(f"[syncs] {label}: under set_sync_debug_mode('warn'): "
            f"{sy['syncs']} syncs in the port over {serve['work_steps']} "
            f"steps ({sy['syncs_per_step']:.3f} a step; the harness "
            f"{sy['harness_syncs']}), at {json.dumps(sy['sites'])}; each in "
            f"a function where R1 reports a finding; the control sync "
            f"recorded at {json.dumps(sy['control'])} "
            f"({len(sy['r1_functions'])}: {sy['r1_functions']}; the "
            f"checker took {sy['check_s']:.2f} s)")
    if "off" in serve:
        log_serve(serve["off"]["label"], serve["off"], quant)
        log(f"[graphs] {label}: tokens with graphs on equal graphs off; "
            f"wall {serve['wall_s']:.3f} s on, {serve['off']['wall_s']:.3f} "
            "s off")


def log_profile(label: str, prof: dict) -> None:
    """A profiled re-run's record on the log, with its top kernels."""
    hl = prof["host_launches_per_step"]
    log(f"[profile] {label} re-run under torch.profiler: "
        f"wall_ms={prof['wall_ms']:.1f} "
        f"device_busy_ms={prof['device_busy_ms']:.1f} "
        f"device_idle_share={prof['device_idle_share']:.3f} "
        f"dtoh_copies={prof['dtoh_copies']} over "
        f"{prof['work_steps']} steps "
        f"({prof['dtoh_per_step']:.2f}/step) "
        f"pageable_copies={prof['pageable_copies']} "
        f"device_ops_per_step={prof['device_ops_per_step']:.0f} "
        "host_launches_per_step="
        + ("not measured" if hl is None else f"{hl:.1f}")
        + f" host_launch_calls={json.dumps(prof['host_launch_calls'])} "
        f"records_lost={prof['records_lost']} "
        f"sessions={prof['sessions']} "
        f"ours_ms={json.dumps(prof['ours_ms'])}")
    for row in prof["top"]:
        log(f"[profile]   {row['ms']:9.2f} ms  {row['calls']:6d} calls  "
            f"{row['kernel']}")


def phase_moe(report: dict, gen, kernels) -> list:
    """Phase 6 on the card: the attention kernels at the MoE model's
    heads, one layer's expert product, the MOE_MODEL_LAYERS-layer f32
    model card vs CPU, the three full-depth MoE serves (each with its
    launches counted from zero, graphs on and off; only the graphs-on
    serve re-run under the profiler), then the checkpoint reader.  The
    seconds of each part go to ``report["moe"]["seconds"]``.  Returns the
    kernel checks."""
    m = report["moe"] = {}
    secs = m["seconds"] = {}
    t_phase = t0 = time.perf_counter()

    def lap(part):
        nonlocal t0
        secs[part] = time.perf_counter() - t0
        t0 = time.perf_counter()
    checks = []
    for check, label in MOE_KERNEL_CHECKS:
        k = check(gen, heads=MOE_HEADS)
        k["label"] = label
        checks.append(k)
        log(f"[kernel] {label}: kernel_ms={k['ms']:.4f} "
            f"plain_ms={k['plain_ms']:.4f} "
            f"bound_ms={k['bound'][0]:.5f} ({k['bound'][1]}) "
            f"max_abs_err={k['max_abs_err']:.3e} [{k['shape']}]")
    m["kernels"] = checks
    lap("kernels")
    m["ffn"] = check_moe_ffn(gen)
    lap("ffn")
    m["model"] = res = phase_model("cuda", config=MOE,
                                   layers=MOE_MODEL_LAYERS)
    lap("model")
    log(f"[model] {MOE_MODEL_LAYERS}-layer full-width {MOE} f32, card vs "
        f"CPU: {json.dumps(res)} ({secs['model']:.1f} s)")
    serves = m["serve"] = {}
    for label, options, must, never in MOE_SERVES:
        serves[label] = serve = phase_serve(
            "cuda", config=MOE, quant=None, kernels=kernels, label=label,
            options=options, must=must, never=never, profile=True,
            graphs_off=True, profile_off=False)
        lap(f"serve {label}")
        log_serve(label, serve, "bf16")
    check_async_serve(serves["moe-chunked-async"], serves["moe-chunked"])
    same = agreement(serves["moe-chunked"]["tokens"],
                     serves["moe-int8-chunked"]["tokens"])
    log(f"[serve] greedy agreement moe-chunked vs moe-int8-chunked: "
        f"{same:.3f}")
    m["checkpoint"] = ck = phase_checkpoint()
    lap("checkpoint")
    log(f"[checkpoint] qwen2-1.5b x{ck['layers']} written ({ck['bytes']} "
        f"bytes, {ck['write_s']:.2f} s) and read by LLM.load(checkpoint=..)"
        f" in {ck['load_s']:.2f} s: greedy tokens equal the in-memory "
        "params'")
    secs["phase"] = time.perf_counter() - t_phase
    log(f"[moe] phase 6 took {secs['phase']:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()
                    if k != "phase"))
    return checks


# --------------------------------------------------------------------------
# Phase 7: sliding-window attention (h2o-danube-3-4b over private rings)
# --------------------------------------------------------------------------

DANUBE = "h2o-danube-3-4b"
DANUBE_HEADS = (32, 8, 120)      # its query heads, KV heads and head dim
DANUBE_WINDOW = 8192
DANUBE_WAVE = (8, 8192)          # the serve's one prefill wave: 8 x 8180 -> 8192
DANUBE_LINEARS = {"wq/wo": (3840, 3840), "wk/wv": (3840, 960),
                  "gate/up": (3840, 10240), "down": (10240, 3840)}
# every linear at decode and at the wave's 65,536 rows
DANUBE_GPTQ_SHAPES = [(lname, K, N, GS, (8, DANUBE_WAVE[0] * DANUBE_WAVE[1]))
                      for lname, (K, N) in DANUBE_LINEARS.items()]
DANUBE_RING_BLOCKS = 512         # 512 blocks of 16 tokens: the 8,192 window
# serve_prompts' traffic with the 900-token prompt replaced by one of 8,180
# tokens asking for 40 new tokens: it decodes positions 8,180 .. 8,218, so
# its ring wraps after 12 tokens (a chat turn over a long document beside
# short turns)
DANUBE_LENS = (20, 64 + 40, 64 + 300, 150, 420, 600, 777, 8180)
DANUBE_MAX_TOKENS = (32, 29, 26, 23, 20, 17, 14, 40)
DANUBE_KERNELS = ({"flash_attention", "gptq_matmul"},
                  {"paged_attention", "paged_attention_quant",
                   "flash_attention_chunk", "flash_attention_chunk_int8"}
                  | SCAN_KERNELS)
# the engine's defaults: a ring stack cannot chunk, and the async step
# rides the unified (chunked) step, so the serve runs synchronous waves
# and megasteps as the reference's engine does (``serve_ring``)
# the 2-layer full-width model in f32, card vs CPU: rings of 64 slots, a
# window of 48 inside them, a prompt of 100 (wraps and drops at prefill)
RING_MODEL = {"layers": 2, "slots": 3, "mb": 4, "nb": 16, "window": 48,
              "lens": (100, 64, 30), "steps": 40}
RING_LOGIT_TOL = 1e-3            # f32 card vs CPU, as MOE_LOGIT_TOL
# every served token against teacher forcing (``teacher_forced``): the
# share equal, and the largest gap between the teacher's top logit and
# the served token's.  chip_faults.py on an H100 80GB HBM3 at 700 W: the
# sound serve reads 0.980 and 0.031 (one bf16 step of the logits); a ring
# decode that reads V one slot off, halves the window or leaves the new
# token's own slot stale reads at most 0.806 and at least 1.11
TEACHER_AGREEMENT = 0.9
TEACHER_GAP = 0.25


def teacher_ok(tf: dict) -> bool:
    return tf["agreement"] >= TEACHER_AGREEMENT \
        and tf["max_gap"] <= TEACHER_GAP


def ring_pool_blocks(cfg, slots: int, ring_blocks: int) -> int:
    """The fewest pool blocks that admit ``slots`` rings of ``ring_blocks``
    blocks above the allocator's watermark (max(1, 1% of the pool))."""
    n = slots * ring_blocks
    while n - slots * ring_blocks < max(1, int(n * cfg.paging.watermark_frac)):
        n += 1
    return n


def ring_options(cfg, slots: int = DANUBE_WAVE[0],
                 ring_blocks: int = DANUBE_RING_BLOCKS) -> dict:
    """``LLM.load``'s engine options for ``slots`` private rings of
    ``ring_blocks`` blocks."""
    return {"max_slots": slots, "max_blocks_per_seq": ring_blocks,
            "num_blocks": ring_pool_blocks(cfg, slots, ring_blocks)}


def _plain_by_group(q, k, v, **kw):
    """``flash_attention_ref`` one (sequence, KV head) at a time, so the
    f32 scores of a [8192, 8192] square are built for one group of 4 heads
    (1.07 GB) at a time instead of all 256."""
    import torch
    from repro_torch.kernels import ref
    out = torch.empty_like(q)
    KVh = k.shape[2]
    G = q.shape[2] // KVh
    for b in range(q.shape[0]):
        for h in range(KVh):
            hs = slice(h * G, (h + 1) * G)
            kwh = dict(kw)
            if "alibi_slopes" in kw:
                kwh["alibi_slopes"] = kw["alibi_slopes"][hs]
            out[b:b + 1, :, hs] = ref.flash_attention_ref(
                q[b:b + 1, :, hs], k[b:b + 1, :, h:h + 1],
                v[b:b + 1, :, h:h + 1], **kwh)
    return out


def check_flash_attention_d120(gen):
    """The static kernel at h2o-danube-3-4b's heads (32 over 8, head dim
    120, staged padded to 128): the serve's wave [8, 8192] causal inside
    the 8192 window, a band case where Sk 10240 > window 8192 (the key
    tiles before the band are skipped, the edge tiles masked), then a
    window at a q_offset and ALiBi with a window; each against the plain
    version run one (sequence, KV head) group at a time."""
    from repro_torch.core.alibi import alibi_slopes
    h, kv, d = DANUBE_HEADS
    b, S = DANUBE_WAVE
    win = DANUBE_WINDOW
    cases = [(f"danube wave [{b},{S}] causal, window {win}",
              _qkv(gen, b, S, S, h, kv, d), {"sliding_window": win}),
             (f"band Sq = Sk = 10240 > window {win}",
              _qkv(gen, 1, 10240, 10240, h, kv, d), {"sliding_window": win}),
             ("q_offset 64, window 100, Sq 200 < Sk 333",
              _qkv(gen, 2, 200, 333, h, kv, d),
              {"q_offset": 64, "sliding_window": 100}),
             ("ALiBi, window 128, 512",
              _qkv(gen, 2, 512, 512, h, kv, d),
              {"alibi_slopes": alibi_slopes(h, "cuda"),
               "sliding_window": 128})]
    return _flash_wave_record(cases, "flash_attention[D=120]",
                              f"causal, window {win}")


def _flash_wave_record(cases, label: str, what: str) -> dict:
    """``cases`` (the first a serve's wave, which ``what`` describes)
    through ``_flash_rows`` against the plain version run one (sequence,
    KV head) group at a time; the kernel's record under ``label``, its
    numbers the wave's."""
    worst, rows = _flash_rows(cases, _plain_by_group)
    (q, k, v), kw = cases[0][1:]
    (b, S, h, d), kv = q.shape, k.shape[2]
    main = rows[0]
    also = "; ".join(c[0] for c in cases[1:])
    return {"name": "flash_attention", "label": label, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:386",
            "max_abs_err": worst, "ms": main["ms"],
            "plain_ms": time_ms(lambda: _plain_by_group(q, k, v, **kw),
                                iters=1),
            "bound": main["bound"], "library_ms": main["library_ms"],
            "shape": f"q[{b},{S},{h},{d}] k/v[{b},{S},{kv},{d}] {what}; "
                     + (f"checked also at {also}; " if also else "")
                     + "plain version one (sequence, KV head) at a time",
            "per_case": rows}


def phase_ring_model(dev: str = "cuda", ref_dev: str = "cpu",
                     reduced: bool = False) -> dict:
    """h2o-danube-3-4b at full width cut to RING_MODEL's 2 layers, f32, a
    window of 48 inside rings of 64 slots: the same params, tables and
    tokens through ``T.prefill`` (a prompt of 100: ``_write_ring`` drops
    its first 36 positions and wraps) and 40 teacher-forced
    ``T.decode_step``s on ``dev`` and on ``ref_dev``; every step's logits
    and the final pools within RING_LOGIT_TOL."""
    import numpy as np
    import torch
    from repro_torch.bridge import tree_to
    from repro_torch.configs.registry import get_config, get_reduced
    from repro_torch.models import transformer as T
    rm = RING_MODEL
    base = get_reduced(DANUBE) if reduced else get_config(DANUBE)
    cfg = base.replace(num_layers=rm["layers"], dtype="float32",
                       sliding_window=rm["window"])
    params = T.init_params(cfg, 1, ref_dev)
    rng = np.random.default_rng(0)
    B, lens, n = rm["slots"], np.array(rm["lens"], np.int32), rm["steps"]
    S = int(lens.max())
    toks = rng.integers(0, cfg.vocab_size, (B, S + n)).astype(np.int32)
    bt = rng.permutation(rm["nb"])[:B * rm["mb"]].reshape(B, rm["mb"]) \
        .astype(np.int32)
    res = {}
    t0 = time.perf_counter()
    with torch.no_grad():
        for d in (ref_dev, dev):
            p = T.split_layers(T.cast_params(tree_to(params, d),
                                             T.act_dtype(cfg)))
            st = T.make_decode_state(cfg, B, rm["nb"], rm["mb"], device=d)
            st["block_table"] = torch.from_numpy(bt).to(d)
            logits, st = T.prefill(cfg, p, st, {
                "tokens": torch.from_numpy(toks[:, :S]).to(d),
                "ctx_lens": torch.from_numpy(lens).to(d)})
            steps = [logits.cpu()]
            for t in range(n):
                pos = lens + t
                st["seq_lens"] = torch.from_numpy(pos + 1).to(d)
                logits, st = T.decode_step(
                    cfg, p, st,
                    torch.from_numpy(toks[np.arange(B), pos]).to(d))
                steps.append(logits.cpu())
            res[d] = (torch.stack(steps), st["k_pool"].cpu(),
                      st["v_pool"].cpu())
    (l0, k0, v0), (l1, k1, v1) = res[ref_dev], res[dev]
    err = (l1 - l0).abs().max().item()
    pool_err = max((k1 - k0).abs().max().item(),
                   (v1 - v0).abs().max().item())
    out = {"config": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype,
           "window": cfg.sliding_window, "ring_slots": rm["mb"] * 16,
           "prompt_lens": list(rm["lens"]), "decode_steps": n,
           "logit_max_abs_err": err, "max_abs_logit": l0.abs().max().item(),
           "pool_max_abs_err": pool_err,
           "greedy_agreement": float((l1.argmax(-1) == l0.argmax(-1))
                                     .float().mean()),
           "tolerance": RING_LOGIT_TOL,
           "seconds": time.perf_counter() - t0}
    if not (err <= RING_LOGIT_TOL and pool_err <= RING_LOGIT_TOL
            and bool(torch.isfinite(l1).all())):
        raise AssertionError(f"ring model: card vs CPU {out}")
    return out


def ring_decode_ms(llm, steps: int = 3) -> dict:
    """One full decode step of the served model with all 8 rings full
    (seq_len 8,200: every slot valid, the ring wrapped): its elapsed ms
    between events (``time_ms``; its ~2,000 launches outrun the spin, so
    this includes the host's launch gaps), the same replayed as one
    captured CUDA graph, and its device busy ms (the
    kernels' time summed by ``torch.profiler`` over ``steps`` steps);
    and one layer's ring attention alone (write, gather of the whole
    ring, f32 scores, softmax, output; few launches, so ``time_ms`` is
    its device time) beside its bound: the bytes of the K and V rings it
    must read.  Writes one token per slot into the pool, so it runs after
    the serves."""
    import torch
    from repro_torch.core.kv_quant import cache_from_state
    from repro_torch.models.attention import _ring_cache_attend
    cfg, runner = llm.cfg, llm.engine.runner
    slots, mb = runner.max_slots, runner.mb
    st = dict(runner.state)
    st["seq_lens"] = torch.full((slots,), 8200, dtype=torch.int32,
                                device="cuda")
    st["block_table"] = torch.arange(slots * mb, dtype=torch.int32,
                                     device="cuda").reshape(slots, mb)
    toks = torch.zeros(slots, dtype=torch.int32, device="cuda")
    h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn((slots, h, d), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((slots, kv, d), generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    cache = cache_from_state(st)
    ring = mb * cfg.paging.block_size
    nbytes = 2 * slots * ring * kv * d * 2
    out = decode_step_times(cfg, runner.params, st, toks, steps)
    with torch.no_grad():
        attn = time_ms(lambda: _ring_cache_attend(
            q, k, v, cache, st["block_table"], st["seq_lens"], 0,
            cfg.sliding_window))
    return {**out, "ring_attention_layer_ms": attn,
            "ring_attention_bound": bound_ms(nbytes, 4 * slots * h * d
                                             * ring),
            "ring_bytes_per_layer": nbytes, "slots": slots,
            "ring_slots": ring}


def decode_step_times(cfg, params, st, toks, steps: int = 3) -> dict:
    """One ``T.decode_step`` on ``st``: its elapsed ms between events
    (``time_ms``; a step's thousands of launches outrun the spin, so this
    includes the host's launch gaps), the same replayed as one captured
    CUDA graph (as the runner's megastep replays it), and its device busy
    ms and kernel records (``torch.profiler``, summed over ``steps``
    steps)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as T
    with torch.no_grad():
        step = time_ms(lambda: T.decode_step(cfg, params, st, toks), iters=5)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                T.decode_step(cfg, params, st, toks)
            torch.cuda.synchronize()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            T.decode_step(cfg, params, st, toks)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            T.decode_step(cfg, params, st, toks)
        torch.cuda.current_stream().wait_stream(side)
        graphed = time_ms(graph.replay, iters=5)
        graph.reset()
    busy, launches = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            busy += (e.self_cuda_time_total if us is None else us) / 1e3
            launches += e.count
    return {"decode_step_ms": step, "decode_step_graphed_ms": graphed,
            "decode_step_device_ms": busy / steps,
            "decode_step_device_ops": launches / steps}


def teacher_forced(llm, prompts, served, ring_blocks=DANUBE_RING_BLOCKS
                   ) -> dict:
    """Every served request's greedy tokens against teacher forcing: the
    argmax of ``T.forward`` (the static kernel, window 8192: no ring) over
    its prompt and the tokens it was served.  Teacher forcing compares
    each step on its own, so one flip does not carry to the next.  Returns
    the share equal (overall, per request, and for the wrapping request's
    tokens decoded from positions past the ring's end) and the gap, in
    the teacher's f32 logits, between its top logit and the served
    token's: 0 where they agree, small where a bf16 near-tie flipped.
    ``ring_blocks`` None: a model without rings (no wrap to report)."""
    import torch
    from repro_torch.models import transformer as T
    runner = llm.engine.runner
    same, gaps, per_request = [], [], []
    for prompt, toks in zip(prompts, served):
        seq = torch.tensor(prompt + toks[:-1], dtype=torch.int32,
                           device=runner.device)[None]
        with torch.no_grad():
            lg = T.forward(llm.cfg, runner.params, {"tokens": seq})[
                0, len(prompt) - 1:].float()
        got = torch.tensor(toks, device=lg.device)
        gap = lg.max(-1).values - lg.gather(-1, got[:, None])[:, 0]
        eq = (lg.argmax(-1) == got).cpu().tolist()
        same.append(eq)
        gaps += gap.cpu().tolist()
        per_request.append(sum(eq) / len(eq))
    long_prompt, long_eq = len(prompts[-1]), same[-1]
    flat = [e for eq in same for e in eq]
    out = {"agreement": sum(flat) / len(flat), "tokens": len(flat),
           "agreement_by_request": per_request,
           "max_gap": max(gaps), "mean_gap": sum(gaps) / len(gaps),
           "last_position": long_prompt + len(served[-1]) - 1}
    if ring_blocks is not None:
        ring = ring_blocks * llm.cfg.paging.block_size
        first_wrapped = ring - (long_prompt - 1)   # fed a position >= ring
        out.update(agreement_after_wrap=sum(long_eq[first_wrapped:])
                   / max(len(long_eq[first_wrapped:]), 1), ring_slots=ring)
    return out


def serve_ring(kernels, config: str = DANUBE, label: str = "danube-defaults",
               slots: int = DANUBE_WAVE[0],
               ring_blocks: int = DANUBE_RING_BLOCKS, lens=DANUBE_LENS,
               max_tokens=DANUBE_MAX_TOKENS, must_never=DANUBE_KERNELS
               ) -> tuple:
    """Full-depth ``config`` (a stack without full-attention layers),
    ``LLM.load`` with ``rtn-int4`` on the engine's defaults over ``slots``
    private rings of ``ring_blocks`` blocks, serving ``lens``' traffic
    (profiled), graphs on and again off, launching the kernels of
    ``must_never``'s first set and none of its second; each served token
    held to teacher forcing.  Returns (the LLM, the serve's record, the
    teacher-forced record); the caller closes the LLM."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.serving import LLM
    cfg = get_config(config)
    options = ring_options(cfg, slots, ring_blocks)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    llm = LLM.load(config, quant="rtn-int4", seed=0, **options)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    load_peak = torch.cuda.max_memory_allocated()
    eng = llm.engine
    log(f"[serve] {config} rtn-int4 loaded in {load_s:.2f} s (init "
        f"{llm.load_s.get('init', 0.0):.2f} s), peak {load_peak} B; "
        f"engine chunked="
        f"{eng.chunked} async_step={eng.async_step} "
        f"ring_only={eng.scheduler.ring_only}")
    if eng.chunked or eng.async_step or not eng.scheduler.ring_only:
        raise AssertionError(f"{config}: a ring stack must run whole-prompt, "
                             f"synchronous and ring_only (chunked="
                             f"{eng.chunked}, async_step={eng.async_step}, "
                             f"ring_only={eng.scheduler.ring_only})")
    must, never = must_never
    serve = phase_serve("cuda", config=config, kernels=kernels, label=label,
                        options=options, must=must, never=never,
                        profile=True, llm=llm, lens=lens,
                        max_tokens=max_tokens, graphs_off=True)
    serve["load_s"], serve["load_max_memory_allocated"] = load_s, load_peak
    log_serve(label, serve, "rtn-int4")
    tf = teacher_forced(llm, serve_prompts(cfg.vocab_size, lens),
                        serve["tokens"], ring_blocks=ring_blocks)
    return llm, serve, tf


def phase_sliding(report: dict, gen, kernels) -> list:
    """Phase 7 on the card: the static kernel at head dim 120 (serve's
    wave and the band), ``gptq_matmul`` at danube's linears (decode and
    the wave's rows), the 2-layer full-width ring model in f32 card vs
    CPU, then full-depth h2o-danube-3-4b with ``rtn-int4`` weights served
    on the engine's defaults over private rings of 512 blocks, profiled:
    0 pageable copies, the wrapping request past position 8,192, every
    served token held to teacher forcing; one ring decode step timed.
    Returns the kernel checks."""
    import torch
    r = report["sliding"] = {}
    t_phase = time.perf_counter()
    checks = [check_flash_attention_d120(gen)]
    g = check_gptq_matmul(
        gen, shapes=DANUBE_GPTQ_SHAPES, main_shape=("gate/up", 8),
        shape="x[8,3840] @ int4[3840,10240] gs 32 (gate/up, decode)",
        library_max_m=8192)
    g["label"] = "gptq_matmul[danube]"
    checks.append(g)
    for k in checks:
        lib = "null" if k["library_ms"] is None else f"{k['library_ms']:.4f}"
        log(f"[kernel] {k['label']}: kernel_ms={k['ms']:.4f} "
            f"plain_ms={k['plain_ms']:.4f} library_ms={lib} "
            f"bound_ms={k['bound'][0]:.5f} ({k['bound'][1]}) "
            f"max_abs_err={k['max_abs_err']:.3e} [{k['shape']}]")
    r["kernels"] = checks
    r["model"] = res = phase_ring_model()
    log(f"[model] 2-layer full-width {DANUBE} f32 over rings, card vs CPU: "
        f"{json.dumps(res)}")

    llm, serve, tf = serve_ring(kernels)
    r["serve"] = {serve["label"]: serve}
    r["teacher_forced"] = tf
    ring = tf["ring_slots"]
    if serve["profile"]["pageable_copies"]:
        raise AssertionError("danube serve: pageable memcpys under the "
                             "profiler (want 0)")
    if not tf["last_position"] >= ring:
        raise AssertionError(f"danube: the wrapping request ended at "
                             f"position {tf['last_position']} < {ring}")
    if not teacher_ok(tf):
        raise AssertionError(f"danube: served tokens against teacher "
                             f"forcing (agreement >= {TEACHER_AGREEMENT}, "
                             f"gap <= {TEACHER_GAP}): {tf}")
    r["ring_decode"] = rd = ring_decode_ms(llm)
    kv = {"kv_pool_bytes": serve["kv_pool_bytes"],
          "kv_bytes_per_token": llm.engine.runner.kv_bytes_per_token()}
    r.update(kv)
    llm.close()
    del llm
    torch.cuda.empty_cache()
    log(f"[serve] {serve['label']}: 0 pageable memcpys; KV pool "
        f"{json.dumps(kv)}; the {DANUBE_LENS[-1]}-token request decoded "
        f"through position {tf['last_position']} (ring {ring} slots); "
        f"teacher forcing over all {tf['tokens']} tokens: agreement "
        f"{tf['agreement']:.3f} (by request "
        f"{json.dumps(tf['agreement_by_request'])}, after the wrap "
        f"{tf['agreement_after_wrap']:.3f}), logit gap max "
        f"{tf['max_gap']:.4f} mean {tf['mean_gap']:.5f}")
    log(f"[ring] one decode step, 8 full rings x 24 layers: "
        f"{rd['decode_step_ms']:.3f} ms between events "
        f"({rd['decode_step_graphed_ms']:.3f} ms replayed as one graph), "
        f"{rd['decode_step_device_ms']:.3f} ms of device busy time in "
        f"{rd['decode_step_device_ops']:.0f} device ops; one layer's ring "
        f"attention "
        f"{rd['ring_attention_layer_ms']:.4f} ms, bound "
        f"{rd['ring_attention_bound'][0]:.5f} ms "
        f"({rd['ring_attention_bound'][1]}, {rd['ring_bytes_per_layer']} B)")
    r["seconds"] = time.perf_counter() - t_phase
    log(f"[sliding] phase 7 took {r['seconds']:.1f} s")
    return checks


# --------------------------------------------------------------------------
# Phase 7 (b): h2o-danube-3-4b with gptq-int4
# --------------------------------------------------------------------------

DANUBE_GPTQ = "danube-gptq"
# the one weight held card OBQ against CPU OBQ: layer 0's wk [3840, 960]
# (its CPU side takes seconds; w_gate's [3840, 10240] would take minutes)
DANUBE_OBQ = ("attn", "wk")


def phase_danube_gptq(report: dict, kernels, dev: str = "cuda",
                      reduced: bool = False) -> dict:
    """Phase 7 (b) on the card: full-width, full-depth h2o-danube-3-4b
    ``LLM.load(quant="gptq-int4")`` on CALIB_N x [CALIB_B, CALIB_S] seeded
    calibration tokens over its rings (``gptq_load``: the static kernel at
    head dim 120 exactly layers x CALIB_N times, nothing else; seconds by
    part and peak memory), GPTQ's Hessian loss below RTN's over the 48
    (layer, Hessian) pairs, layer 0's Hessians within HESSIAN_TOL_REL of
    a float64 CPU replay, layer 0's wk through OBQ on the card and on the
    CPU (``gptq_quality``), then the danube traffic of ``serve_ring``
    served on the engine's defaults with graphs on, profiled: 0 pageable
    copies, ``gptq_matmul`` once a linear, layer and step, every served
    token held to teacher forcing.  The serve joins phase 7's serves
    (``report["sliding"]["serve"]``), so the head-dim-120 and danube int4
    rows count its launches.  With ``dev="cpu", reduced=True`` the same
    steps run the reduced config on the plain path (no profile)."""
    import torch
    from repro_torch.configs.registry import get_config, get_reduced
    t_phase = time.perf_counter()
    card = dev != "cpu"
    cfg = get_reduced(DANUBE) if reduced else get_config(DANUBE)
    options = ring_options(cfg)
    r = report["danube_gptq"] = {}
    llm, calib, load = gptq_load(kernels, dev, reduced, DANUBE, options)
    r["load"] = load
    ls = load["load_s"]
    peak = load["max_memory_allocated"]
    log(f"[danube-gptq] LLM.load {DANUBE} gptq-int4 x{cfg.num_layers} "
        f"layers, calibration {CALIB_N} x [{CALIB_B}, {CALIB_S}] tokens: "
        f"wall_s={load['wall_s']:.2f} "
        + " ".join(f"{k}_s={v:.2f}" for k, v in ls.items())
        + " peak_gb=" + ("not measured" if peak is None
                         else f"{peak / 1e9:.2f}")
        + " "
        f"column_steps={cfg.num_layers * 2 * cfg.d_model} "
        f"launches={json.dumps(load['launches'])}")
    log_time("danube-gptq load")
    r["quality"] = q = gptq_quality(llm, calib, dev, obq=DANUBE_OBQ)
    o = q["obq"]
    log(f"[danube-gptq] layer-0 Hessians, card vs CPU float64 replay: "
        f"{json.dumps(q['hessians_vs_cpu'])}")
    log(f"[danube-gptq] Hessian loss over {q['pairs']} (layer, Hessian) "
        f"pairs: gptq_sum={q['gptq_sum']:.6e} rtn_sum={q['rtn_sum']:.6e} "
        f"ratio={q['sum_ratio']:.4f} per-pair ratios "
        + json.dumps([round(p["ratio"], 4) for p in q["per_pair"]]))
    log(f"[danube-gptq] OBQ of {o['weight']} {o['shape']}: "
        f"card_s={o['card_s']:.3f} cpu_s={o['cpu_s']:.3f} "
        f"codes_equal={o['codes_equal']:.6f} "
        f"scales_zeros_equal={o['scales_zeros_equal']} "
        f"err_rel={o['err_rel']:.3e} (gptq {o['err_card']:.6e}, rtn "
        f"{o['rtn_err']:.6e}); codes equal to the load's (one loop with "
        f"wq, wv): {o['load_codes_equal']:.6f}")
    log_time("danube-gptq quality")
    eng = llm.engine
    if eng.chunked or eng.async_step or not eng.scheduler.ring_only:
        raise AssertionError(f"{DANUBE} gptq-int4: a ring stack must run "
                             "whole-prompt, synchronous and ring_only")
    must, never = DANUBE_KERNELS
    serve = phase_serve(dev, config=DANUBE, kernels=kernels,
                        label=DANUBE_GPTQ, options=options,
                        must=must if kernels else (),
                        never=never if kernels else (), profile=card,
                        llm=llm, lens=DANUBE_LENS,
                        max_tokens=DANUBE_MAX_TOKENS)
    serve["load_s"] = load["wall_s"]
    serve["load_max_memory_allocated"] = peak
    if card:
        log_serve(DANUBE_GPTQ, serve, "gptq-int4")
        if serve["profile"]["pageable_copies"]:
            raise AssertionError(f"{DANUBE_GPTQ} serve: pageable memcpys "
                                 "under the profiler (want 0)")
    if kernels:
        serve["gptq_launches_planned"] = check_gptq_serve_launches(
            serve, cfg, GS, options["max_slots"],
            wave_rows=DANUBE_WAVE[0] * DANUBE_WAVE[1])
    tf = teacher_forced(llm, serve_prompts(cfg.vocab_size, DANUBE_LENS),
                        serve["tokens"])
    r["teacher_forced"] = tf
    if not teacher_ok(tf):
        raise AssertionError(f"{DANUBE_GPTQ}: served tokens against teacher "
                             f"forcing (agreement >= {TEACHER_AGREEMENT}, "
                             f"gap <= {TEACHER_GAP}): {tf}")
    llm.close()
    del llm, eng
    if card:
        torch.cuda.empty_cache()
    report.setdefault("sliding", {}).setdefault("serve", {})[
        DANUBE_GPTQ] = serve
    r["seconds"] = time.perf_counter() - t_phase
    log(f"[danube-gptq] {DANUBE_GPTQ}: 0 pageable memcpys; gptq_matmul "
        f"{serve['launches'].get('gptq_matmul')} launches = 7 linears x "
        f"{cfg.num_layers} layers x the runner's steps "
        f"{json.dumps(serve['runner_steps'])}; teacher forcing over all "
        f"{tf['tokens']} tokens: agreement {tf['agreement']:.3f} (by request "
        f"{json.dumps(tf['agreement_by_request'])}, after the wrap "
        f"{tf['agreement_after_wrap']:.3f}), logit gap max "
        f"{tf['max_gap']:.4f} mean {tf['mean_gap']:.5f}; phase 7 (b) took "
        f"{r['seconds']:.1f} s")
    return r


# --------------------------------------------------------------------------
# Phase 8: the hybrid (recurrentgemma-2b: RG-LRU layers + sliding windows)
# --------------------------------------------------------------------------

RGEMMA = "recurrentgemma-2b"
RGEMMA_HEADS = (10, 1, 256)      # its query heads, KV heads and head dim
RGEMMA_WINDOW = 2048
RGEMMA_WAVE = (8, 2048)          # the serve's one wave: 8 x 2040 -> 2048
RGEMMA_LINEARS = {"in/gate/out_rec, wq/wo": (2560, 2560),
                  "wk/wv": (2560, 256), "up": (2560, 7680),
                  "down": (7680, 2560)}
# every int4 linear at decode and at the wave's 16,384 rows
RGEMMA_GPTQ_SHAPES = [(lname, K, N, GS, (8, RGEMMA_WAVE[0] * RGEMMA_WAVE[1]))
                      for lname, (K, N) in RGEMMA_LINEARS.items()]
RGEMMA_RING_BLOCKS = 128         # 128 blocks of 16 tokens: the 2,048 window
# its serve launches the static kernel, the int4 matmul and the RG-LRU's
# time scan (one launch a recurrent layer, wave or decode step)
RGEMMA_KERNELS = (DANUBE_KERNELS[0] | {"linear_scan"},
                  DANUBE_KERNELS[1] - {"linear_scan"})
# serve_prompts' traffic with the 900-token prompt replaced by one of 2,040
# tokens asking for 40 new tokens: it decodes positions 2,040 .. 2,078, so
# its ring wraps after 8 tokens
RGEMMA_LENS = (20, 64 + 40, 64 + 300, 150, 420, 600, 777, 2040)
RGEMMA_MAX_TOKENS = DANUBE_MAX_TOKENS
# the 6-layer full-width model (4 RG-LRU, 2 sliding layers), card vs CPU:
# f32 with dense weights, then bf16 with rtn-int4 weights (the served
# form); rings of 64 slots, a window of 48 inside them, a prompt of 100
HYBRID_MODEL = {"layers": 6, "slots": 3, "mb": 4, "nb": 16, "window": 48,
                "lens": (100, 64, 30), "steps": 16}
HYBRID_TOL = {"float32": RING_LOGIT_TOL, "bfloat16": LOGIT_TOL}
# the static kernel's D = 256 instantiation, as cuobjdump and ptxas name it
D256_KERNEL = "flash_attention_mma_kernelILi256E"


def ptxas_usage(log: str, fn: str) -> dict:
    """Registers and spill bytes that ``nvcc -Xptxas -v`` reported for the
    kernel whose mangled name contains ``fn``."""
    out, cur = {}, False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = fn in line
        elif cur and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            out.update(stack_bytes=nums[0], spill_store_bytes=nums[1],
                       spill_load_bytes=nums[2])
        elif cur and "Used" in line and "registers" in line:
            out["registers"] = int(line.split("Used")[1].split()[0])
    return out


def check_flash_attention_d256(gen):
    """The static kernel at recurrentgemma-2b's heads (10 over 1, head dim
    256, tiles of 64 keys): the serve's wave [8, 2048] causal inside the
    2048 window, a band case where Sk 2560 > window 2048, a ragged 333
    (not a multiple of the 128 query and 64 key tiles) and a window at a
    q_offset; each against the plain version one (sequence, KV head)
    group at a time."""
    h, kv, d = RGEMMA_HEADS
    b, S = RGEMMA_WAVE
    win = RGEMMA_WINDOW
    cases = [(f"rgemma wave [{b},{S}] causal, window {win}",
              _qkv(gen, b, S, S, h, kv, d), {"sliding_window": win}),
             (f"band Sq = Sk = 2560 > window {win}",
              _qkv(gen, 1, 2560, 2560, h, kv, d), {"sliding_window": win}),
             ("ragged Sq = Sk = 333, causal",
              _qkv(gen, 2, 333, 333, h, kv, d), {}),
             ("q_offset 64, window 100, Sq 200 < Sk 333",
              _qkv(gen, 2, 200, 333, h, kv, d),
              {"q_offset": 64, "sliding_window": 100})]
    return _flash_wave_record(cases, "flash_attention[D=256]",
                              f"causal, window {win}")


def phase_hybrid_model(dev: str = "cuda", ref_dev: str = "cpu",
                       reduced: bool = False) -> dict:
    """recurrentgemma-2b at full width cut to HYBRID_MODEL's 6 layers (4
    RG-LRU, 2 sliding), in f32 with dense weights and in bf16 with
    rtn-int4 weights: the same params, tables and tokens through
    ``T.prefill`` (a prompt of 100 wraps its 64-slot ring) and
    teacher-forced ``T.decode_step``s on ``dev`` and on ``ref_dev``; every
    step's logits, ``lru_h`` after the wave and at the end, and the final
    pools within HYBRID_TOL of the dtype."""
    import numpy as np
    import torch
    from repro_torch.bridge import tree_to
    from repro_torch.configs.registry import get_config, get_reduced
    from repro_torch.models import transformer as T
    from repro_torch.models.quantize import quantize_params_rtn
    hm = HYBRID_MODEL
    base = get_reduced(RGEMMA) if reduced else get_config(RGEMMA)
    rng = np.random.default_rng(0)
    B, lens, n = hm["slots"], np.array(hm["lens"], np.int32), hm["steps"]
    S = int(lens.max())
    toks = rng.integers(0, base.vocab_size, (B, S + n)).astype(np.int32)
    bt = rng.permutation(hm["nb"])[:B * hm["mb"]].reshape(B, hm["mb"]) \
        .astype(np.int32)
    out = {}
    for dtype, quant in (("float32", None), ("bfloat16", "rtn-int4")):
        t0 = time.perf_counter()
        cfg = base.replace(num_layers=hm["layers"], dtype=dtype,
                           sliding_window=hm["window"])
        params = T.init_params(cfg, 1, ref_dev)
        if quant:
            params = quantize_params_rtn(params, cfg, GS)
        res = {}
        with torch.no_grad():
            for d in (ref_dev, dev):
                # the CPU multiplies by the plain int4 product's own
                # weights, dequantized once (``dequantized``)
                p = T.split_layers(T.cast_params(tree_to(
                    dequantized(params, T.act_dtype(cfg)) if d == ref_dev
                    else params, d), T.act_dtype(cfg)))
                st = T.make_decode_state(cfg, B, hm["nb"], hm["mb"],
                                         device=d)
                st["block_table"] = torch.from_numpy(bt).to(d)
                logits, st = T.prefill(cfg, p, st, {
                    "tokens": torch.from_numpy(toks[:, :S]).to(d),
                    "ctx_lens": torch.from_numpy(lens).to(d)})
                steps, h_wave = [logits.float().cpu()], st["lru_h"].cpu()
                for t in range(n):
                    pos = lens + t
                    st["seq_lens"] = torch.from_numpy(pos + 1).to(d)
                    logits, st = T.decode_step(
                        cfg, p, st,
                        torch.from_numpy(toks[np.arange(B), pos]).to(d))
                    steps.append(logits.float().cpu())
                res[d] = (torch.stack(steps), h_wave, st["lru_h"].cpu(),
                          st["k_pool"].float().cpu(),
                          st["v_pool"].float().cpu())
        del params
        (l0, hw0, h0, k0, v0), (l1, hw1, h1, k1, v1) = res[ref_dev], res[dev]
        tol = HYBRID_TOL[dtype]
        r = {"quant": quant, "logit_max_abs_err": (l1 - l0).abs().max().item(),
             "max_abs_logit": l0.abs().max().item(),
             "lru_h_wave_max_abs_err": (hw1 - hw0).abs().max().item(),
             "lru_h_max_abs_err": (h1 - h0).abs().max().item(),
             "max_abs_lru_h": h0.abs().max().item(),
             "pool_max_abs_err": max((k1 - k0).abs().max().item(),
                                     (v1 - v0).abs().max().item()),
             "greedy_agreement": float((l1.argmax(-1) == l0.argmax(-1))
                                       .float().mean()),
             "tolerance": tol, "seconds": time.perf_counter() - t0}
        out[dtype] = r
        errs = [r[k] for k in ("logit_max_abs_err", "lru_h_wave_max_abs_err",
                               "lru_h_max_abs_err", "pool_max_abs_err")]
        if not (max(errs) <= tol and bool(torch.isfinite(l1).all())):
            raise AssertionError(f"hybrid model {dtype}: card vs CPU {r}")
    out.update(config=base.name, layers=hm["layers"], window=hm["window"],
               ring_slots=hm["mb"] * 16, prompt_lens=list(hm["lens"]),
               decode_steps=n)
    return out


def wave_split(llm, wave=RGEMMA_WAVE, iters: int = 2) -> dict:
    """One wave ``wave`` = (rows, width) of the served model (``T.prefill``
    on the runner's params and pools, random tokens; its recurrent rows
    are not kept): its time between events (host launch gaps included),
    then the same wave profiled, its device time split between
    ``gptq_matmul``, the static attention kernel, the time scans
    (``selective_scan`` / ``linear_scan``; a torch ``addcmul`` a step in
    trees before the scan kernel) and everything else (the gates and
    projections, conv, norms, RoPE, the ring writes, the dense products).
    Writes the pools, so it runs after the serves."""
    import torch
    from repro_torch.models import transformer as T
    cfg, runner = llm.cfg, llm.engine.runner
    B, S = wave
    st = dict(runner.state)
    if "block_table" in st:
        st["block_table"] = torch.arange(B * runner.mb, dtype=torch.int32,
                                         device="cuda").reshape(B, runner.mb)
    gen = torch.Generator(device="cuda").manual_seed(7)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen, device="cuda",
                                     dtype=torch.int32),
             "ctx_lens": torch.full((B,), S, dtype=torch.int32,
                                    device="cuda")}

    out = device_split(lambda: T.prefill(cfg, runner.params, st, batch),
                       iters)
    return {"wave": [B, S], **out}


def device_split(run, iters: int = 2) -> dict:
    """``run``'s time between events (``time_ms``: host launch gaps
    included), then ``run`` once under the profiler, its device time
    split between ``gptq_matmul``, the static attention kernel, the time
    scans (``selective_scan`` / ``linear_scan``; a torch ``addcmul`` a step
    in trees before the scan kernel) and everything else."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        ms = time_ms(run, iters=iters)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    split = dict.fromkeys(("gptq_matmul", "flash_attention", "time_scan",
                           "other"), 0.0)
    launches = dict.fromkeys(split, 0)
    for name, on_device, dev_ms in _events(prof):
        if not on_device or "Memcpy" in name or "Memset" in name:
            continue
        ours = ours_name(name)
        key = ("time_scan" if ours in SCAN_KERNELS or "addcmul" in name
               else ours or "other")
        split[key] += dev_ms
        launches[key] += 1
    busy = sum(split.values())
    return {"ms": ms, "device_busy_ms": busy,
            "device_ms": split, "device_share": {k: v / busy for k, v in
                                                 split.items()},
            "device_launches": launches}


def phase_hybrid(report: dict, gen, kernels) -> list:
    """Phase 8 on the card: the static kernel at head dim 256 (its
    registers and spills from ptxas, its wgmma SASS), ``gptq_matmul``
    at recurrentgemma's linears (decode and the wave's rows), the 6-layer
    full-width model card vs CPU (f32 and bf16 int4), then full-depth
    recurrentgemma-2b with ``rtn-int4`` weights served on the engine's
    defaults over private rings of 128 blocks, graphs on and off,
    profiled: 0 pageable copies, the wrapping request past position
    2,048, every served token held to teacher forcing, 8 static-kernel
    launches a wave; one wave's time split.  Returns the kernel checks."""
    import torch
    from repro_torch.kernels import build
    r = report["hybrid"] = {}
    t_phase = time.perf_counter()
    sass = {n: c["HGMMA"] for n, c in report["tensor_core_sass"].items()
            if D256_KERNEL in n}
    if not sass or not all(sass.values()):
        raise AssertionError(f"{D256_KERNEL}: no HGMMA in its SASS: {sass}")
    usage = ptxas_usage(build.LOGS.get("flash_attention", ""), D256_KERNEL)
    r["d256_sass_hgmma"], r["d256_ptxas"] = sum(sass.values()), usage
    log(f"[hybrid] flash_attention_mma_kernel<256>: "
        f"{r['d256_sass_hgmma']} HGMMA in its SASS; ptxas "
        + (json.dumps(usage) if usage else "not measured (cached build)"))
    checks = [check_flash_attention_d256(gen)]
    g = check_gptq_matmul(
        gen, shapes=RGEMMA_GPTQ_SHAPES, main_shape=("up", 8),
        shape="x[8,2560] @ int4[2560,7680] gs 32 (up, decode)",
        library_max_m=8192)
    g["label"] = "gptq_matmul[rgemma]"
    checks.append(g)
    for k in checks:
        lib = "null" if k["library_ms"] is None else f"{k['library_ms']:.4f}"
        log(f"[kernel] {k['label']}: kernel_ms={k['ms']:.4f} "
            f"plain_ms={k['plain_ms']:.4f} library_ms={lib} "
            f"bound_ms={k['bound'][0]:.5f} ({k['bound'][1]}) "
            f"max_abs_err={k['max_abs_err']:.3e} [{k['shape']}]")
    r["kernels"] = checks
    r["model"] = res = phase_hybrid_model()
    log(f"[model] 6-layer full-width {RGEMMA} card vs CPU: {json.dumps(res)}")

    llm, serve, tf = serve_ring(
        kernels, RGEMMA, "rgemma-defaults", RGEMMA_WAVE[0],
        RGEMMA_RING_BLOCKS, RGEMMA_LENS, RGEMMA_MAX_TOKENS,
        must_never=RGEMMA_KERNELS)
    r["serve"] = {serve["label"]: serve}
    r["teacher_forced"] = tf
    ring = tf["ring_slots"]
    waves = serve["runner_steps"]["wave"]
    if serve["launches"]["flash_attention"] != 8 * waves or waves < 1:
        raise AssertionError(f"rgemma: {serve['launches']['flash_attention']}"
                             f" static-kernel launches over {waves} waves "
                             "(want 8 a wave)")
    check_scan_launches(serve, "linear_scan", 18)
    if serve["profile"]["pageable_copies"]:
        raise AssertionError("rgemma serve: pageable memcpys under the "
                             "profiler (want 0)")
    if not tf["last_position"] >= ring:
        raise AssertionError(f"rgemma: the wrapping request ended at "
                             f"position {tf['last_position']} < {ring}")
    if not teacher_ok(tf):
        raise AssertionError(f"rgemma: served tokens against teacher "
                             f"forcing (agreement >= {TEACHER_AGREEMENT}, "
                             f"gap <= {TEACHER_GAP}): {tf}")
    r["wave_split"] = ws = wave_split(llm, RGEMMA_WAVE)
    r["kv_pool_bytes"] = serve["kv_pool_bytes"]
    r["recurrent_state_bytes"] = sum(
        llm.engine.runner.state[k].numel()
        * llm.engine.runner.state[k].element_size()
        for k in ("lru_h", "rec_conv"))
    llm.close()
    del llm
    torch.cuda.empty_cache()
    log(f"[serve] {serve['label']}: 0 pageable memcpys; KV pool "
        f"{r['kv_pool_bytes']} B, recurrent state "
        f"{r['recurrent_state_bytes']} B; the {RGEMMA_LENS[-1]}-token "
        f"request decoded through position {tf['last_position']} (ring "
        f"{ring} slots); teacher forcing over all {tf['tokens']} tokens: "
        f"agreement {tf['agreement']:.3f} (by request "
        f"{json.dumps(tf['agreement_by_request'])}, after the wrap "
        f"{tf['agreement_after_wrap']:.3f}), logit gap max "
        f"{tf['max_gap']:.4f} mean {tf['mean_gap']:.5f}")
    log(f"[wave] one wave {ws['wave']}: {ws['ms']:.1f} ms between events, "
        f"{ws['device_busy_ms']:.1f} ms of device time: "
        + ", ".join(f"{k} {ws['device_ms'][k]:.1f} ms "
                    f"({ws['device_share'][k]:.3f}, "
                    f"{ws['device_launches'][k]} launches)"
                    for k in ws["device_ms"]))
    r["seconds"] = time.perf_counter() - t_phase
    log(f"[hybrid] phase 8 took {r['seconds']:.1f} s")
    return checks


# --------------------------------------------------------------------------
# Phase 9: the attention-free Mamba-1 stack (falcon-mamba-7b) and the
# time-scan kernel it shares with the RG-LRU
# --------------------------------------------------------------------------

MAMBA = "falcon-mamba-7b"
F32_FLOPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
# the scans in f32: each output's largest error over its own RMS
SCAN_REL_TOL = 1e-4
# the selective scan's check over din 8192 with a state of 16: the
# serve's wave (its prompts padded to MAMBA_WAVE's 960, the kernels
# line's time), a wave of 8 x 1024 with ragged lengths, both masked as
# the model masks them (dt = 0, u = 0), and a decode step from a random
# state
MAMBA_SCAN = (8, 1024, 8192, 16)
MAMBA_SCAN_LENS = (1024, 1000, 931, 777, 600, 420, 150, 20)
# the linear scan's check: recurrentgemma's wave [8, 2048] over width 2560
RGEMMA_SCAN = (8, 2048, 2560)
MAMBA_LINEARS = {"in_proj": (4096, 16384), "out_proj": (8192, 4096)}
# the serve's wave: 8 prompts of up to 900 tokens padded to 960
MAMBA_WAVE = (8, 960)
# every int4 linear at decode and at the wave's 7,680 rows
MAMBA_GPTQ_SHAPES = [(lname, K, N, GS, (8, MAMBA_WAVE[0] * MAMBA_WAVE[1]))
                     for lname, (K, N) in MAMBA_LINEARS.items()]
# the full-width model cut to 2 layers, card vs CPU: f32 with dense
# weights on an init whose state carries and moves the logits
# (MAMBA_MEMORY), then bf16 with rtn-int4 weights on the served init.
# Logits within MAMBA_TOL; ssm_h and ssm_conv each within
# MAMBA_STATE_TOL of their own RMS (largest error over RMS, as the scan
# checks), a limit that a state one decode step stale must exceed
MAMBA_MODEL = {"layers": 2, "slots": 3, "lens": (100, 64, 30), "steps": 8}
MAMBA_MODEL_RUNS = (("float32", None, True), ("bfloat16", "rtn-int4", False))
MAMBA_TOL = {"float32": RING_LOGIT_TOL, "bfloat16": LOGIT_TOL}
# bf16: int4 weights, bf16 activations; set between the sound reading
# (ssm_h 0.094 of its RMS) and the stale controls (6.2 and more)
MAMBA_STATE_TOL = {"float32": SCAN_REL_TOL, "bfloat16": 0.5}
# the init's dt (0.001-0.1) and A (-1..-16) leave a state of ~4e-5 that
# moves no logit; dt ~ 1 (dt_bias = softplus^-1(1)), A = -0.05 (the state
# decays by ~0.95 a step) and out_proj x 4 make the logits depend on it,
# as tests/test_torch_ssm.py's mamba_memory does
MAMBA_MEMORY = {"dt_bias": 0.5413, "A": -0.05, "out_proj_scale": 4.0}
# the served model's next-token logits with its state against a zero
# state must move by more than this: ten times the bf16 model check's
# logit tolerance
STATE_EFFECT_MIN = 10 * LOGIT_TOL
# the serve's final ssm_h / ssm_conv with graphs on against graphs off:
# largest error over the RMS
SERVE_STATE_TOL = SCAN_REL_TOL
# its serve launches the selective scan and the int4 matmul, nothing else
MAMBA_KERNELS = ({"selective_scan", "gptq_matmul"},
                 {"paged_attention", "paged_attention_quant",
                  "flash_attention_chunk", "flash_attention_chunk_int8",
                  "flash_attention", "linear_scan"})


def _scan_bound(nbytes: float, flops: float):
    """The f32 scans' bound: bytes over 3.35 TB/s or flops over the f32
    peak outside the tensor cores, whichever is longer."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / F32_FLOPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def _scan_case(name: str, label: str, kernel, plain, args, nbytes, flops):
    """One scan case: the kernel against its plain version on the same
    inputs (each output within SCAN_REL_TOL of its RMS), called twice and
    bitwise equal, timed beside the plain version and its bound."""
    import torch
    got = kernel(*args)
    again = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    errs, rel = [], 0.0
    for g, a, w in zip(got, again, want):
        if not torch.equal(g, a):
            raise AssertionError(f"{name} {label}: two calls differ")
        err = (g - w).abs().max().item()
        rms = w.float().pow(2).mean().sqrt().item()
        errs.append(err)
        rel = max(rel, err / rms)
        if not (bool(torch.isfinite(g).all()) and err <= SCAN_REL_TOL * rms):
            raise AssertionError(f"{name} {label}: max err {err:.3e} over "
                                 f"RMS {rms:.3e} (limit {SCAN_REL_TOL})")
    bitwise = all(torch.equal(g, w) for g, w in zip(got, want))
    row = {"case": label, "max_abs_err": max(errs), "rel_err": rel,
           "bitwise_equal_to_plain": bitwise,
           "ms": time_ms(lambda: kernel(*args)),
           "plain_ms": time_ms(lambda: plain(*args), iters=2),
           "bound": _scan_bound(nbytes, flops)}
    log(f"{name} {label}: kernel_ms={row['ms']:.4f} "
        f"plain_ms={row['plain_ms']:.4f} bound_ms={row['bound'][0]:.5f} "
        f"({row['bound'][1]}) max_abs_err={row['max_abs_err']:.3e} "
        f"rel_err={rel:.2e} bitwise_equal_to_plain={bitwise}")
    return row


def check_selective_scan(gen) -> dict:
    """The Mamba-1 selective scan at falcon-mamba-7b's widths: the
    serve's wave and a [8, 1024] wave, each from a zero state with ragged
    rows masked (dt = 0, u = 0 past each row's length, as ``_ssm_inner``
    passes them), and one decode step (S = 1) from a random state,
    against ``selective_scan_ref``.  The serve's wave gives the kernels
    line its time."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.time_scan import selective_scan
    b, S, din, N = MAMBA_SCAN
    dev = "cuda"
    A = -torch.arange(1, N + 1, dtype=torch.float32,
                      device=dev).repeat(din, 1)
    rows = []
    wb, ws = MAMBA_WAVE
    for label, s, lens, h0 in (
            (f"serve wave [{wb},{ws}] din {din} N {N}, prompts "
             f"{SERVE_LENS}", ws, SERVE_LENS,
             torch.zeros((wb, din, N), device=dev)),
            (f"wave [{b},{S}] din {din} N {N}, ragged {MAMBA_SCAN_LENS}",
             S, MAMBA_SCAN_LENS,
             torch.zeros((b, din, N), device=dev)),
            (f"decode [{b},1] din {din} N {N} from a random state", 1,
             (1,) * b, torch.randn((b, din, N), generator=gen, device=dev))):
        mask = (torch.arange(s, device=dev)[None] < torch.tensor(
            lens, device=dev)[:, None])[..., None]
        dt = (torch.rand((b, s, din), generator=gen, device=dev) * 0.099
              + 0.001) * mask
        u = torch.randn((b, s, din), generator=gen, device=dev) * mask
        Bm = torch.randn((b, s, N), generator=gen, device=dev)
        Cm = torch.randn((b, s, N), generator=gen, device=dev)
        nbytes = 4 * (3 * b * s * din + 2 * b * s * N + din * N
                      + 2 * b * din * N)
        flops = b * s * din * (7 * N + 1)
        rows.append(_scan_case("selective_scan", label, selective_scan,
                               ref.selective_scan_ref,
                               (dt, u, Bm, Cm, A, h0), nbytes, flops))
        del dt, u, Bm, Cm, mask
    main = rows[0]
    return {"name": "selective_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/time_scan.cu",
            "replaces": "src/repro/models/ssm.py:99 (the lax.scan step of "
                        "_ssm_inner; not a Pallas site)",
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound": main["bound"], "library_ms": None,
            "shape": main["case"] + "; no single torch call computes it",
            "cases": rows}


# the fused entry (``ops.ssm_scan``: softplus, the scan, the D skip and
# the gate in one launch) at falcon-mamba-7b's widths on inputs made by
# the model's own projections from falcon-mamba's init (``ssm_init``:
# its dt_bias, A_log and D draws): (label, rows, width, prompt lengths
# masked as ``ssm_prefill`` masks them or None, activations, from a
# random state, the init (MAMBA_INITS), its y must hold the scan's
# share).  From a zero state the init's state stays ~1e-6 over a wave,
# so the serve wave's y is the D skip times the gate to within bf16's
# resolution and its check cannot see the scan.  A random state carries
# into y through the slow states (dt ~ 0.001, A ~ -1), x_proj's B and C
# columns scaled to a unit B and C carry the inputs into it, and so does
# MAMBA_MEMORY's init (dt ~ 1, A = -0.05) in f32: those cases must show
# the scan's share of y above SCAN_SHARE_MIN limits.  (A long live row
# from a random state cannot be held to SCAN_REL_TOL: dt is nearly
# constant in time, so a rounding of exp(dt A) repeats every step, and
# f32 scans that round it differently part by ~1e-5 of a slow state's
# size over 1,000 steps, more than 1e-4 of the RMS of a state whose
# other elements have decayed.)
MAMBA_FUSED_CASES = (
    ("serve wave", MAMBA_WAVE[0], MAMBA_WAVE[1], SERVE_LENS, "bfloat16",
     False, "served", False),
    ("ragged wave from a random state", MAMBA_SCAN[0], MAMBA_SCAN[1],
     MAMBA_SCAN_LENS, "bfloat16", True, "served", True),
    ("decode", MAMBA_SCAN[0], 1, None, "bfloat16", True, "served", True),
    ("single prompt, B and C scaled", 1, 4096, None, "bfloat16", False,
     "scaled B, C", True),
    ("serve wave f32", MAMBA_WAVE[0], MAMBA_WAVE[1], SERVE_LENS, "float32",
     False, "served", False),
    ("serve wave f32, memory-carrying init", MAMBA_WAVE[0], MAMBA_WAVE[1],
     SERVE_LENS, "float32", False, "memory", True))
# the inits of MAMBA_FUSED_CASES: falcon-mamba's own, MAMBA_MEMORY's dt
# and A, or x_proj's B and C columns times MAMBA_BC_SCALE (a power of two:
# the bf16 weight is the served one scaled exactly), which makes B and C
# of unit size as a trained model's are
MAMBA_INITS = ("served", "memory", "scaled B, C")
MAMBA_BC_SCALE = 256.0
# the fused entry's gated y: in bf16 within this share of the plain
# version's largest |y| (the kernels' bf16 tolerance; a scan that differs
# in the last f32 bits flips a bf16 rounding of y), in f32 within
# SCAN_REL_TOL of its RMS; h_last within SCAN_REL_TOL of its RMS
FUSED_Y_TOL = 2e-2
# the scan's share of the plain version's y (its largest change from the
# y of the D skip and the gate alone, C = 0) in a case that must see the
# scan: at least this many y limits, so that a fault in the scan's part
# of y cannot hide under the limit
SCAN_SHARE_MIN = 10
# the selective-scan kernel's instantiations, as ptxas names them:
# (activations, fused, states a lane, tile steps) -> name fragment
SCAN_INSTANTIATIONS = {
    (act, fused, ns, tt): f"selective_scan_kernelI{mangled}Lb{int(fused)}E"
                          f"Li{ns}ELi{tt}E"
    for act, mangled, fused in (("float32", "f", False),
                                ("float32", "f", True),
                                ("bfloat16", "13__nv_bfloat16", True))
    for ns in (8, 4) for tt in (16, 1)}


def sm_clock_hz() -> float:
    """The card's highest SM clock (``nvidia-smi`` clocks.max.sm)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return float(smi.stdout.strip().splitlines()[0]) * 1e6


def scan_ptxas(build) -> dict:
    """Registers and spill bytes of every selective-scan instantiation
    (``build_all(verbose=True)``'s log; {} after a cached build)."""
    log_ = build.LOGS.get("time_scan", "")
    if not log_:
        return {}
    return {f"{act} fused={fused} NS={ns} TT={tt}": ptxas_usage(log_, fn)
            for (act, fused, ns, tt), fn in SCAN_INSTANTIATIONS.items()}


def unfused_ssm_scan(dt_lin, dt_bias, xc, B, C, z, A_log, D, h0, mask):
    """The Mamba-1 mixer core as ``_ssm_inner`` ran it before the fused
    entry: the torch prologue and tail around ``selective_scan`` (the
    scan alone, f32)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    dt = F.softplus(dt_lin + dt_bias.to(xc.dtype)).float()
    if mask is not None:
        dt = torch.where(mask[..., None], dt, 0.0)
    A = -torch.exp(A_log.float())
    y, h = ops.selective_scan(dt.contiguous(), xc.float().contiguous(),
                              B.float().contiguous(), C.float().contiguous(),
                              A.contiguous(), h0.float().contiguous())
    y = y.to(xc.dtype) + xc * D.to(xc.dtype)
    return y * F.silu(z), h


def mamba_core_inputs(cfg, p, gen, rows: int, width: int, lens, act: str,
                      random_state: bool) -> tuple:
    """``ops.ssm_scan``'s arguments as ``ssm_prefill`` forms them: a random
    [rows, width, d] input through in_proj, the causal conv and SiLU (zero
    past each row's length), x_proj and dt_proj, in ``act``; B, C and z
    the projections' column views."""
    import torch
    from repro_torch.models import ssm
    dt = getattr(torch, act)
    pw = {k: (v.to(dt) if k in ("in_proj", "x_proj", "dt_proj", "conv_w",
                                "conv_b") else v) for k, v in p.items()}
    x = torch.randn((rows, width, cfg.d_model), generator=gen,
                    device="cuda").to(dt)
    mask = None
    xi, z = ssm._in_proj(cfg, pw, x)
    if lens is not None:
        mask = torch.arange(width, device="cuda")[None] < torch.tensor(
            lens, device="cuda")[:, None]
        xi = torch.where(mask[..., None], xi, torch.zeros_like(xi))
    xc = torch.nn.functional.silu(ssm._conv(xi, pw["conv_w"])
                                  + pw["conv_b"])
    if mask is not None:
        xc = torch.where(mask[..., None], xc, torch.zeros_like(xc))
    R, N = ssm.dt_rank(cfg), cfg.ssm_state
    dbc = xc @ pw["x_proj"]
    dt_r, B, C = dbc.split([R, N, N], dim=-1)
    dt_lin = dt_r @ pw["dt_proj"]
    din = xc.shape[-1]
    h0 = (torch.randn((rows, din, N), generator=gen, device="cuda")
          if random_state else torch.zeros((rows, din, N), device="cuda"))
    return (dt_lin, p["dt_bias"], xc, B, C, z, p["A_log"], p["D"], h0,
            mask)


def check_ssm_scan(gen, build=None) -> dict:
    """The fused entry (``selective_scan.fused`` through ``ops.ssm_scan``)
    in MAMBA_FUSED_CASES against its plain version (``ssm_scan_ref``, the
    torch composition ``_ssm_inner`` ran) on the card: y within
    FUSED_Y_TOL of its largest |y| in bf16 and SCAN_REL_TOL of its RMS in
    f32, h_last within SCAN_REL_TOL of its RMS, two calls bitwise equal;
    where a case must see the scan, the scan's share of the plain y at
    least SCAN_SHARE_MIN y limits.  Every case is held; the failures are
    raised together, one "ssm_scan <label>: ..." each.  Each passing case
    is timed beside the unfused path (``unfused_ssm_scan``), the plain
    version, its byte bound and its exponentials' MUFU time (one ex2 a
    state element, 16 a clock an SM at the card's highest clock);
    ptxas's registers and spills of each instantiation."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.time_scan import selective_scan
    from repro_torch.models import ssm
    cfg = get_config(MAMBA)
    p = ssm.ssm_init(gen, cfg, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = sm_clock_hz()
    din, N = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    R = ssm.dt_rank(cfg)
    x_bc = p["x_proj"].clone()
    x_bc[:, R:] *= MAMBA_BC_SCALE
    inits = dict(zip(MAMBA_INITS, (
        p,
        dict(p, dt_bias=torch.full((din,), MAMBA_MEMORY["dt_bias"],
                                   device="cuda"),
             A_log=torch.full((din, N), math.log(-MAMBA_MEMORY["A"]),
                              device="cuda")),
        dict(p, x_proj=x_bc))))
    rows_out, fails = [], []
    for label, rows, width, lens, act, random_state, init, sees_scan in \
            MAMBA_FUSED_CASES:
        held = len(fails)
        args = mamba_core_inputs(cfg, inits[init], gen, rows, width, lens,
                                 act, random_state)
        dt_lin, _, xc, B, C, z, _, D, h0, mask = args
        kernel = lambda: selective_scan.fused(*args)
        got, again = kernel(), kernel()
        want = ref.ssm_scan_ref(*args)
        skip_only = xc * D.to(xc.dtype) * torch.nn.functional.silu(z)
        torch.cuda.synchronize()
        y_err = (got[0].float() - want[0].float()).abs().max().item()
        y_max = want[0].float().abs().max().item()
        y_rms = want[0].float().pow(2).mean().sqrt().item()
        y_lim = (FUSED_Y_TOL * y_max if act == "bfloat16"
                 else SCAN_REL_TOL * y_rms)
        share = (want[0].float() - skip_only.float()).abs().max().item()
        h_err = (got[1] - want[1]).abs().max().item()
        h_rms = want[1].pow(2).mean().sqrt().item()
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        del skip_only
        log(f"ssm_scan {label}: y_err={y_err:.3e} (limit {y_lim:.3e}) "
            f"scan_share={share / y_lim:.1f} limits"
            + (f" (must be >= {SCAN_SHARE_MIN})" if sees_scan else "")
            + f" h_last_rel_err={h_err / h_rms:.2e}")
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            fails.append(f"ssm_scan {label}: two calls differ")
        elif sees_scan and not share >= SCAN_SHARE_MIN * y_lim:
            fails.append(f"ssm_scan {label}: the scan's share of y "
                         f"{share:.3e} is under {SCAN_SHARE_MIN} limits "
                         f"({y_lim:.3e}): the check cannot see the scan")
        elif not (finite and y_err <= y_lim
                  and h_err <= SCAN_REL_TOL * h_rms):
            fails.append(
                f"ssm_scan {label}: y max err {y_err:.3e} (limit "
                f"{y_lim:.3e}), h_last max err {h_err:.3e} over RMS "
                f"{h_rms:.3e} (limit {SCAN_REL_TOL}), finite {finite}")
        if len(fails) > held:
            # a failed case is not timed; the other cases are still held
            del args, got, again, want, dt_lin, xc, B, C, z, D, h0, mask
            torch.cuda.empty_cache()
            continue
        Bt, S, din = xc.shape
        N = cfg.ssm_state
        es = xc.element_size()
        nbytes = (4 * es * Bt * S * din + 2 * N * es * Bt * S
                  + 4 * (din * N + 2 * din + 2 * Bt * din * N) + Bt * S)
        flops = Bt * S * din * (7 * N + 11)
        row = {"case": f"{label} [{Bt},{S}] din {din} N {N} {act}"
                       + (f", prompts {tuple(lens)}" if lens else ""),
               "max_abs_err": max(y_err, h_err), "y_max_abs_err": y_err,
               "y_limit": y_lim, "scan_share_limits": share / y_lim,
               "h_last_rel_err": h_err / h_rms,
               "bitwise_equal_to_plain": all(
                   torch.equal(g, w) for g, w in zip(got, want)),
               "ms": time_ms(kernel),
               "unfused_ms": time_ms(lambda: unfused_ssm_scan(*args)),
               "plain_ms": time_ms(lambda: ref.ssm_scan_ref(*args), iters=2),
               "bound": _scan_bound(nbytes, flops),
               "mufu_ms": Bt * S * din * N / (16 * sms * clock) * 1e3}
        row["share_of_bound"] = row["bound"][0] / row["ms"]
        log(f"ssm_scan {row['case']}: kernel_ms={row['ms']:.4f} "
            f"unfused_ms={row['unfused_ms']:.4f} plain_ms="
            f"{row['plain_ms']:.4f} bound_ms={row['bound'][0]:.5f} "
            f"({row['bound'][1]}; share {row['share_of_bound']:.3f}) "
            f"mufu_ms={row['mufu_ms']:.5f} y_err={y_err:.3e} (limit "
            f"{y_lim:.3e}) h_last_rel_err={row['h_last_rel_err']:.2e}")
        rows_out.append(row)
        del args, got, again, want, dt_lin, xc, B, C, z, D, h0, mask
        torch.cuda.empty_cache()
    if fails:
        raise AssertionError("; ".join(fails))
    usage = scan_ptxas(build) if build is not None else {}
    log("[build] ptxas, selective_scan_kernel<act, fused, NS, TT>: "
        + (json.dumps(usage) if usage else "not measured (cached build)"))
    main = rows_out[0]
    return {"name": "selective_scan", "label": "selective_scan[fused]",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/time_scan.cu",
            "replaces": "src/repro/models/ssm.py:99 (the lax.scan step of "
                        "_ssm_inner with its softplus, D skip and gate; "
                        "not a Pallas site)",
            "max_abs_err": max(r["max_abs_err"] for r in rows_out),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "unfused_ms": main["unfused_ms"], "bound": main["bound"],
            "library_ms": None, "ptxas": usage,
            "shape": main["case"] + "; no single torch call computes it",
            "cases": rows_out}


def check_linear_scan(gen) -> dict:
    """The RG-LRU's recurrence at recurrentgemma-2b's wave [8, 2048] x
    2560, ragged rows state-transparent (a = 1, g = 0), from a random
    state, against ``linear_scan_ref`` (one ``addcmul`` a step, the path
    it replaces on the card): whether the kernel's fmaf gives the
    addcmul's bits is recorded."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.time_scan import linear_scan
    b, S, w = RGEMMA_SCAN
    dev = "cuda"
    lens = torch.tensor(RGEMMA_LENS, device=dev)
    mask = (torch.arange(S, device=dev)[None] < lens[:, None])[..., None]
    a = torch.where(mask, torch.rand((b, S, w), generator=gen, device=dev)
                    * 0.5 + 0.5, 1.0)
    g = torch.randn((b, S, w), generator=gen, device=dev) * mask
    h0 = torch.randn((b, w), generator=gen, device=dev)
    row = _scan_case("linear_scan", f"rgemma wave [{b},{S}] w {w}, ragged "
                     f"{tuple(lens.tolist())}", linear_scan,
                     ref.linear_scan_ref, (a, g, h0),
                     4 * (3 * b * S * w + 2 * b * w), 2 * b * S * w)
    return {"name": "linear_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/time_scan.cu",
            "replaces": "src/repro/models/ssm.py:215 (the lax.scan step of "
                        "_rglru_scan; not a Pallas site)",
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound": row["bound"],
            "library_ms": None,
            "bitwise_equal_to_addcmul": row["bitwise_equal_to_plain"],
            "shape": row["case"] + "; no single torch call computes it",
            "cases": [row]}


def check_scan_launches(serve: dict, name: str, layers: int) -> None:
    """A scan kernel launched once a recurrent layer for every wave and
    decode step the runner ran, in the serve and in its graphs-off
    twin."""
    for rec in (serve, serve.get("off")):
        if rec is None:
            continue
        steps = rec["runner_steps"]
        want = layers * (steps["wave"] + steps["decode"])
        if rec["launches"][name] != want or not want:
            raise AssertionError(
                f"serve {rec['label']}: {rec['launches'][name]} {name} "
                f"launches, want {layers} x the runner's waves and decode "
                f"steps {steps} = {want}")


def mamba_memory(params) -> None:
    """Set a falcon-mamba tree (stacked layers, before quantizing) to
    MAMBA_MEMORY in place: its state then carries and moves the
    logits."""
    import math
    ssm = params["layers"]["ssm"]
    ssm["dt_bias"].fill_(MAMBA_MEMORY["dt_bias"])
    ssm["A_log"].fill_(math.log(-MAMBA_MEMORY["A"]))
    ssm["out_proj"].mul_(MAMBA_MEMORY["out_proj_scale"])


def _rel(got, want) -> float:
    """Largest error over the reference's RMS."""
    rms = want.pow(2).mean().sqrt().item()
    return (got - want).abs().max().item() / rms if rms else float("inf")


def phase_ssm_model(dev: str = "cuda", ref_dev: str = "cpu",
                    reduced: bool = False) -> dict:
    """falcon-mamba-7b at full width cut to MAMBA_MODEL's layers, in f32
    with dense weights on MAMBA_MEMORY's init and in bf16 with rtn-int4
    weights on the served init: the same params and tokens through
    ``T.prefill``
    and teacher-forced ``T.decode_step``s on ``dev`` and on ``ref_dev``.
    Every step's logits within MAMBA_TOL of the dtype; ``ssm_h`` and
    ``ssm_conv`` after the wave and at the end within MAMBA_STATE_TOL of
    their RMS.  Two controls on ``ref_dev`` show that the checks can
    fail: the state one decode step stale must miss MAMBA_STATE_TOL, and
    the last step's logits from a zero state must miss MAMBA_TOL."""
    import numpy as np
    import torch
    from repro_torch.bridge import tree_to
    from repro_torch.configs.registry import get_config, get_reduced
    from repro_torch.models import transformer as T
    from repro_torch.models.quantize import quantize_params_rtn
    mm = MAMBA_MODEL
    base = get_reduced(MAMBA) if reduced else get_config(MAMBA)
    rng = np.random.default_rng(0)
    B, lens, n = mm["slots"], np.array(mm["lens"], np.int32), mm["steps"]
    S = int(lens.max())
    toks = rng.integers(0, base.vocab_size, (B, S + n)).astype(np.int32)
    out = {}
    for dtype, quant, memory in MAMBA_MODEL_RUNS:
        t0 = time.perf_counter()
        cfg = base.replace(num_layers=mm["layers"], dtype=dtype)
        params = T.init_params(cfg, 1, ref_dev)
        if memory:
            mamba_memory(params)
        if quant:
            params = quantize_params_rtn(params, cfg, GS)
        res = {}
        with torch.no_grad():
            for d in (ref_dev, dev):
                # the CPU multiplies by the plain int4 product's own
                # weights, dequantized once (``dequantized``)
                p = T.split_layers(T.cast_params(tree_to(
                    dequantized(params, T.act_dtype(cfg)) if d == ref_dev
                    else params, d), T.act_dtype(cfg)))
                st = T.make_decode_state(cfg, B, 8, 2, device=d)
                logits, st = T.prefill(cfg, p, st, {
                    "tokens": torch.from_numpy(toks[:, :S]).to(d),
                    "ctx_lens": torch.from_numpy(lens).to(d)})
                steps = [logits.float().cpu()]
                wave = (st["ssm_h"].cpu(), st["ssm_conv"].float().cpu())
                for t in range(n):
                    pos = lens + t
                    st["seq_lens"] = torch.from_numpy(pos + 1).to(d)
                    last = torch.from_numpy(toks[np.arange(B), pos]).to(d)
                    prev = st
                    logits, st = T.decode_step(cfg, p, dict(prev), last)
                    steps.append(logits.float().cpu())
                res[d] = (torch.stack(steps), *wave, st["ssm_h"].cpu(),
                          st["ssm_conv"].float().cpu())
                if d == ref_dev:
                    stale = (prev["ssm_h"].cpu(),
                             prev["ssm_conv"].float().cpu())
                    zeroed, _ = T.decode_step(cfg, p, dict(
                        prev, ssm_h=torch.zeros_like(prev["ssm_h"]),
                        ssm_conv=torch.zeros_like(prev["ssm_conv"])), last)
                    zeroed = zeroed.float().cpu()
                del p, st, prev
        del params
        (l0, hw0, cw0, h0, c0), (l1, hw1, cw1, h1, c1) = res[ref_dev], \
            res[dev]
        tol, stol = MAMBA_TOL[dtype], MAMBA_STATE_TOL[dtype]
        r = {"quant": quant, "memory_init": memory,
             "logit_max_abs_err": (l1 - l0).abs().max().item(),
             "max_abs_logit": l0.abs().max().item(),
             "ssm_h_rel_err": max(_rel(hw1, hw0), _rel(h1, h0)),
             "ssm_conv_rel_err": max(_rel(cw1, cw0), _rel(c1, c0)),
             "ssm_h_max_abs_err": max((hw1 - hw0).abs().max().item(),
                                      (h1 - h0).abs().max().item()),
             "max_abs_ssm_h": h0.abs().max().item(),
             "ssm_conv_max_abs_err": max((cw1 - cw0).abs().max().item(),
                                         (c1 - c0).abs().max().item()),
             "greedy_agreement": float((l1.argmax(-1) == l0.argmax(-1))
                                       .float().mean()),
             "control_stale_ssm_h_rel": _rel(stale[0], h0),
             "control_stale_ssm_conv_rel": _rel(stale[1], c0),
             "control_zero_state_logit_change":
                 (zeroed - l0[-1]).abs().max().item(),
             "tolerance": tol, "state_tolerance": stol,
             "seconds": time.perf_counter() - t0}
        out[dtype] = r
        sound = (r["logit_max_abs_err"] <= tol
                 and r["ssm_h_rel_err"] <= stol
                 and r["ssm_conv_rel_err"] <= stol
                 and bool(torch.isfinite(l1).all()))
        seen = (r["control_stale_ssm_h_rel"] > stol
                and r["control_stale_ssm_conv_rel"] > stol
                and r["control_zero_state_logit_change"] > tol)
        if not (sound and seen):
            raise AssertionError(f"mamba model {dtype}: card vs CPU within "
                                 f"the limits {sound}, controls past them "
                                 f"{seen}: {r}")
    out.update(config=base.name, layers=mm["layers"],
               prompt_lens=list(mm["lens"]), decode_steps=n,
               memory=MAMBA_MEMORY)
    return out


def serve_ssm(kernels, dev: str = "cuda", reduced: bool = False) -> tuple:
    """Full-depth falcon-mamba-7b, ``LLM.load`` with ``rtn-int4`` on the
    engine's defaults (a Mamba stack cannot chunk: whole-prompt waves on
    the synchronous engine, no block table on the device), serving
    ``serve_prompts``' traffic unchanged, graphs on and off, profiled on
    the card; ``selective_scan`` once a layer for every wave and decode
    step; every served token held to teacher forcing.  Returns (the LLM,
    the serve's record, the teacher-forced record); the caller closes the
    LLM."""
    import torch
    from repro_torch.serving import LLM
    card = dev != "cpu"
    if card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    llm = LLM.load(MAMBA, quant="rtn-int4", seed=0, device=dev,
                   reduced=reduced)
    if card:
        torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    load_peak = torch.cuda.max_memory_allocated() if card else None
    eng = llm.engine
    log(f"[serve] {MAMBA} rtn-int4 loaded in {load_s:.2f} s (init and RTN "
        f"a layer at a time {llm.load_s.get('init', 0.0):.2f} s), peak "
        f"{load_peak} B; engine chunked={eng.chunked} "
        f"async_step={eng.async_step} ring_only={eng.scheduler.ring_only}")
    if eng.chunked or eng.async_step or eng.scheduler.ring_only \
            or "block_table" in eng.runner.state:
        raise AssertionError(f"{MAMBA}: a Mamba stack must run whole-prompt "
                             "waves, synchronous, without a device block "
                             f"table (chunked={eng.chunked}, async_step="
                             f"{eng.async_step}, state "
                             f"{sorted(eng.runner.state)})")
    # on the CPU the plain versions run and no counter moves
    must, never = MAMBA_KERNELS if card else ((), ())
    serve = phase_serve(dev, config=MAMBA, kernels=kernels,
                        label="mamba-defaults", options={}, must=must,
                        never=never, profile=card, llm=llm, graphs_off=True,
                        state_keys=("ssm_h", "ssm_conv"))
    serve["load_s"], serve["load_max_memory_allocated"] = load_s, load_peak
    if card:
        check_scan_launches(serve, "selective_scan", llm.cfg.num_layers)
    tf = teacher_forced(llm, serve_prompts(llm.cfg.vocab_size),
                        serve["tokens"], ring_blocks=None)
    return llm, serve, tf


def state_effect(llm) -> dict:
    """How far the served model's next-token logits move with its
    recurrent state: a wave of serve_prompts' first two prompts, then one
    decode step from the wave's ``ssm_h`` / ``ssm_conv`` and the same
    step from zeros; the largest logit change beside the logits' scale,
    and the share of rows whose greedy token moved: the served tokens see
    a state fault only where it moves a token (the serve's state itself
    is held graphs on against off)."""
    import torch
    from repro_torch.models import transformer as T
    cfg, runner = llm.cfg, llm.engine.runner
    dev = runner.device
    prompts = serve_prompts(cfg.vocab_size)[:2]
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                        device=dev)
    toks = torch.zeros((len(prompts), int(lens.max())), dtype=torch.int32,
                       device=dev)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p, dtype=torch.int32)
    with torch.no_grad():
        st = T.make_decode_state(cfg, len(prompts), 8, 2, device=dev)
        logits, st = T.prefill(cfg, runner.params, st,
                               {"tokens": toks, "ctx_lens": lens})
        nxt = logits.argmax(-1).int()
        st["seq_lens"] = lens + 1
        kept, _ = T.decode_step(cfg, runner.params, dict(st), nxt)
        zeroed, _ = T.decode_step(cfg, runner.params, dict(
            st, ssm_h=torch.zeros_like(st["ssm_h"]),
            ssm_conv=torch.zeros_like(st["ssm_conv"])), nxt)
    return {"max_abs_logit_change": (kept - zeroed).abs().max().item(),
            "max_abs_logit": kept.abs().max().item(),
            "argmax_moved_share": (kept.argmax(-1) != zeroed.argmax(-1))
            .float().mean().item(),
            "next_token_is_last_input": (nxt == toks[torch.arange(
                len(prompts)), lens.long() - 1]).float().mean().item()}


def phase_ssm(report: dict, gen, kernels) -> list:
    """Phase 9 on the card: the time-scan kernel's two entry points
    (``selective_scan`` at falcon-mamba's wave and decode, ``linear_scan``
    at recurrentgemma's wave), ``gptq_matmul`` at falcon-mamba's
    in_proj / out_proj (decode and the wave's rows), the 2-layer
    full-width model card vs CPU (f32 and bf16 int4), then full-depth
    falcon-mamba-7b with ``rtn-int4`` served on the engine's defaults,
    graphs on and off, profiled: 0 pageable copies, no attention kernel,
    ``selective_scan`` 64 times a wave and a decode step, the state after
    the serve equal on and off, every served token held to teacher
    forcing, a zero state moving the logits past STATE_EFFECT_MIN; one
    wave's time split.  Returns the kernel checks."""
    import torch
    r = report["ssm"] = {}
    t_phase = time.perf_counter()
    from repro_torch.kernels import build
    checks = [check_selective_scan(gen), check_ssm_scan(gen, build),
              check_linear_scan(gen)]
    g = check_gptq_matmul(
        gen, shapes=MAMBA_GPTQ_SHAPES, main_shape=("in_proj", 8),
        shape="x[8,4096] @ int4[4096,16384] gs 32 (in_proj, decode)",
        library_max_m=8192)
    g["label"] = "gptq_matmul[mamba]"
    checks.append(g)
    for k in checks:
        lib = "null" if k["library_ms"] is None else f"{k['library_ms']:.4f}"
        log(f"[kernel] {k.get('label', k['name'])}: kernel_ms={k['ms']:.4f} "
            f"plain_ms={k['plain_ms']:.4f} library_ms={lib} "
            f"bound_ms={k['bound'][0]:.5f} ({k['bound'][1]}) "
            f"max_abs_err={k['max_abs_err']:.3e} [{k['shape']}]")
    log(f"[kernel] linear_scan bitwise equal to one addcmul a step: "
        f"{checks[2]['bitwise_equal_to_addcmul']}")
    r["kernels"] = checks
    r["model"] = res = phase_ssm_model()
    log(f"[model] {MAMBA_MODEL['layers']}-layer full-width {MAMBA} card vs "
        f"CPU: {json.dumps(res)}")
    log_time("ssm model")

    llm, serve, tf = serve_ssm(kernels)
    r["serve"] = {serve["label"]: serve}
    r["teacher_forced"] = tf
    log_serve(serve["label"], serve, "rtn-int4")
    if serve["profile"]["pageable_copies"]:
        raise AssertionError("mamba serve: pageable memcpys under the "
                             "profiler (want 0)")
    if not teacher_ok(tf):
        raise AssertionError(f"mamba: served tokens against teacher forcing "
                             f"(agreement >= {TEACHER_AGREEMENT}, gap <= "
                             f"{TEACHER_GAP}): {tf}")
    r["state_effect"] = se = state_effect(llm)
    log(f"[ssm] the served model's logits with its state against a zero "
        f"state: {json.dumps(se)}; the state after the serve with graphs "
        f"on against off: {json.dumps(serve['state_on_off'])}")
    if not se["max_abs_logit_change"] > STATE_EFFECT_MIN:
        raise AssertionError(f"mamba: a zero state moves the served model's "
                             f"logits by {se['max_abs_logit_change']} (want "
                             f"> {STATE_EFFECT_MIN}): the decode step does "
                             "not read its state")
    r["wave_split"] = ws = wave_split(llm, MAMBA_WAVE)
    state = llm.engine.runner.state
    r["state_bytes"] = {k: state[k].numel() * state[k].element_size()
                        for k in ("ssm_h", "ssm_conv")}
    llm.close()
    del llm
    torch.cuda.empty_cache()
    log(f"[serve] {serve['label']}: 0 pageable memcpys; no KV pool; state "
        f"{json.dumps(r['state_bytes'])} B; selective_scan "
        f"{serve['launches']['selective_scan']} launches over runner steps "
        f"{json.dumps(serve['runner_steps'])}; teacher forcing over all "
        f"{tf['tokens']} tokens: agreement {tf['agreement']:.3f} (by "
        f"request {json.dumps(tf['agreement_by_request'])}), logit gap max "
        f"{tf['max_gap']:.4f} mean {tf['mean_gap']:.5f}")
    log(f"[wave] one wave {ws['wave']}: {ws['ms']:.1f} ms between events, "
        f"{ws['device_busy_ms']:.1f} ms of device time: "
        + ", ".join(f"{k} {ws['device_ms'][k]:.1f} ms "
                    f"({ws['device_share'][k]:.3f}, "
                    f"{ws['device_launches'][k]} launches)"
                    for k in ws["device_ms"]))
    r["seconds"] = time.perf_counter() - t_phase
    log(f"[ssm] phase 9 took {r['seconds']:.1f} s")
    return checks


# --------------------------------------------------------------------------
# Phase 10: the vision-prefixed decoder (llava-next-mistral-7b: 2,880
# patch embeddings before the text, over the paged pool)
# --------------------------------------------------------------------------

LLAVA = "llava-next-mistral-7b"
LLAVA_HEADS = (32, 8)            # its query heads over KV heads: G = 4
LLAVA_LINEARS = {"wq/wo": (4096, 4096), "wk/wv": (4096, 1024),
                 "gate/up": (4096, 14336), "down": (14336, 4096)}
# the vision wave: four requests, each 2,880 patches and 20 to 200 text
# tokens (right-padded to 200), then VISION_STEPS greedy decode steps
VISION_TEXT = (20, 77, 150, 200)
VISION_STEPS = 16
VISION_ROWS = len(VISION_TEXT) * (2880 + max(VISION_TEXT))     # 12,320
# every int4 linear at decode (8 rows) and at the vision wave's rows
LLAVA_GPTQ_SHAPES = [(lname, K, N, GS, (8, VISION_ROWS))
                     for lname, (K, N) in LLAVA_LINEARS.items()]
# the full-width model cut to 1 layer (at 2 its CPU side took ~90 s of
# the script's 1,200 s limit on the card's host: ROADMAP C16;
# multi-layer pool indexing is held by qwen2-1.5b's 2-layer phase_model),
# card vs CPU: requests of 20 and 200 text tokens behind the prefix, then
# 3 teacher-forced decode steps; f32 with dense weights on both requests,
# then bf16 with rtn-int4 weights (the served form) on the 200-token one
# alone (the CPU's bf16 products and its per-call int4 dequantization
# took 88 s for the pair at 2 layers on the card's host, 2.1x f32's 29 s)
VLM_MODEL = {"layers": 1, "text": (20, 200), "steps": 3,
             "rows": {"float32": (0, 1), "bfloat16": (1,)}}
VLM_TOL = {"float32": MOE_LOGIT_TOL, "bfloat16": LOGIT_TOL}
# greedy tokens of the card against the CPU's (the logits within the
# tolerance above may still flip a near-tie)
MODEL_AGREEMENT = 0.95


def check_flash_attention_vision(gen):
    """The static kernel at llava's vision wave: four sequences of 2,880
    patches plus the longest text (3,080 tokens), 32 query heads over 8,
    head dim 128, causal; against the plain version one (sequence, KV
    head) at a time."""
    h, kv = LLAVA_HEADS
    b, S = len(VISION_TEXT), 2880 + max(VISION_TEXT)
    return _flash_wave_record(
        [(f"vision wave [{b},{S}] causal, G = 4",
          _qkv(gen, b, S, S, h, kv, D), {})],
        "flash_attention[vision]", "causal")


def check_paged_vision(gen) -> dict:
    """The bf16 decode kernel at the vision decode's shape: llava's 32
    query heads over 8 KV heads, four sequences of 2,880 patches plus
    VISION_TEXT's text over a table of ceil((2,880 + 200 + VISION_STEPS) /
    16) = 194 blocks a sequence, as ``vision_wave`` builds it, so that
    ``plan`` takes the same 25 splits and combines them in one launch.
    seq_lens of the first and of the last decode step (2,901..3,096
    keys): live rows within TOL of the plain version and every row within
    FLASH_REL_TOL of its own RMS (``row_rel_err``; an output over ~3,000
    keys is ~0.03 in size, so TOL alone is no check there), two calls
    bitwise equal.  Two controls hold the same kernel output to the plain
    version with one page, and with one split's 8 pages, of every
    sequence dropped (the table closed up, seq_lens 16 or 128 shorter:
    exactly those keys gone); both must miss FLASH_REL_TOL.  The last
    step is timed beside its plain version and its bound."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention, plan
    dev = "cuda"
    H, KV = LLAVA_HEADS
    b, n = len(VISION_TEXT), VISION_STEPS
    mb = -(-(2880 + max(VISION_TEXT) + n) // BS)
    walk = plan(b, KV, H // KV, D, mb, BS)
    nb = 1024
    q = torch.randn((b, H, D), generator=gen, device=dev).bfloat16()
    pools = tuple(torch.randn((nb, BS, KV, D), generator=gen,
                              device=dev).bfloat16() for _ in range(2))
    bt = torch.randperm(nb, generator=gen, device=dev)[:b * mb] \
        .reshape(b, mb).int()
    first = tuple(2880 + t + 1 for t in VISION_TEXT)
    last = tuple(2880 + t + n for t in VISION_TEXT)
    rows = []
    for label, lens in (("vision decode step 1", first),
                        (f"vision decode step {n}", last)):
        sl = torch.tensor(lens, dtype=torch.int32, device=dev)

        def call():
            return paged_attention(q, *pools, bt, sl)
        out = call()
        want = ref.paged_attention_ref(q, *pools, bt, sl)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        rel = row_rel_err(out, want)
        if not (err <= TOL and rel <= FLASH_REL_TOL):
            raise AssertionError(
                f"paged_attention {label}: max err {err} (tol {TOL}), row "
                f"err over RMS {rel} (limit {FLASH_REL_TOL})")
        _repeat_equal("paged_attention", label, call, out)
        toks, pages = sum(lens), sum(-(-x // BS) for x in lens)
        nbytes = 2 * (2 * b * H * D) + toks * KV * D * 2 * 2 \
            + 4 * (b + pages)
        rows.append({"case": label, "seq_lens": list(lens),
                     "max_abs_err": err, "row_rel_err": rel,
                     "ms": time_ms(call),
                     "bound": bound_ms(nbytes, 4 * H * D * toks)})
        log(f"paged_attention[vision] {label}: kernel_ms={rows[-1]['ms']:.4f}"
            f" bound_ms={rows[-1]['bound'][0]:.5f} max_abs_err={err:.3e} "
            f"row_rel_err={rel:.3e}")
    # controls on the last step: drop page 40 (keys 640..655), or the
    # split of pages 40..47, of every sequence
    controls = {}
    for label, p0, k in (("one page dropped", 40, 1),
                         ("one split dropped", 40, walk.pps)):
        cut = torch.cat([bt[:, :p0], bt[:, p0 + k:], bt[:, :k]], 1)
        sl = torch.tensor([x - k * BS for x in last], dtype=torch.int32,
                          device=dev)
        want = ref.paged_attention_ref(q, *pools, cut, sl)
        controls[label] = {
            "max_abs_err": (out.float() - want.float()).abs().max().item(),
            "row_rel_err": row_rel_err(out, want)}
        if not controls[label]["row_rel_err"] > FLASH_REL_TOL:
            raise AssertionError(f"paged_attention[vision] control {label}:"
                                 f" {controls[label]} within the limit "
                                 f"{FLASH_REL_TOL}: the check is blind")
    log(f"paged_attention[vision] controls (must miss {FLASH_REL_TOL}): "
        f"{json.dumps(controls)}")
    sl = torch.tensor(last, dtype=torch.int32, device=dev)
    main = rows[-1]
    return {"name": "paged_attention", "label": "paged_attention[vision]",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:131",
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "row_rel_err": max(r["row_rel_err"] for r in rows),
            "ms": main["ms"],
            "plain_ms": time_ms(lambda: ref.paged_attention_ref(
                q, *pools, bt, sl), iters=3),
            "bound": main["bound"], "library_ms": None, "heads": [H, KV],
            "splits": walk.splits, "controls": controls,
            "serves": ("vision-wave",),
            "shape": f"q[{b},{H},{D}] pool[{nb},{BS},{KV},{D}] table "
                     f"[{b},{mb}] ({walk.splits} splits) seq_lens "
                     f"{list(last)}; checked also {list(first)}",
            "per_case": rows}


def _vision_embeds(cfg, rows: int, seed: int):
    """Patch embeddings [rows, num_prefix_embeds, d] f32 at the reference
    data pipeline's scale (x 0.1), from a seeded numpy generator."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, cfg.num_prefix_embeds, cfg.d_model),
                                dtype=np.float32) * 0.1)


def _gptq_launches(cfg, M: int, layers: int, gs: int = GS) -> int:
    """``gptq_matmul``'s launches for ``layers`` layers of ``cfg``'s int4
    linears at M rows in bf16, as their plans give (one a call: the last
    split of a tile sums the partials in the same launch)."""
    import torch
    from repro_torch.kernels.gptq_matmul import plan
    d, hd = cfg.d_model, cfg.num_heads * cfg.resolved_head_dim
    kvd = cfg.num_kv_heads * cfg.resolved_head_dim
    f = cfg.d_ff
    shapes = [(d, hd), (d, kvd), (d, kvd), (hd, d), (d, f), (f, d)]
    if cfg.act in ("silu", "swiglu"):
        shapes.append((d, f))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return layers * sum(plan(M, K, N, gs, sms).launches for K, N in shapes)


def _rope_tables(cfg, dev: str, ref_dev: str, positions: int) -> dict:
    """RoPE's frequency table ``theta ** (-i / (D / 2))`` as each device's
    ``pow`` computes it: the elements that differ, and the largest angle
    difference they make at the last of ``positions``."""
    import torch
    d2 = cfg.resolved_head_dim // 2
    a, b = ((cfg.rope_theta ** (-torch.arange(0, d2, dtype=torch.float32,
                                              device=d) / d2)).cpu()
            for d in (dev, ref_dev))
    last = torch.tensor(float(positions - 1))
    return {"freqs_differing": int((a != b).sum()), "freqs": d2,
            "angle_max_abs_diff": (last * a - last * b).abs().max().item()}


def _rope_on(ref_dev: str, call):
    """``call()`` with every RoPE rotation computed on ``ref_dev`` (its
    ``pow``, ``cos`` and ``sin``) and moved back: a forward on the card
    that differs from the CPU's in everything but RoPE."""
    from repro_torch.models import attention
    rope = attention.rope
    attention.rope = lambda x, pos, theta: rope(
        x.to(ref_dev), pos.to(ref_dev), theta).to(x.device)
    try:
        return call()
    finally:
        attention.rope = rope


def phase_vlm_model(dev: str = "cuda", ref_dev: str = "cpu",
                    reduced: bool = False) -> dict:
    """llava-next-mistral-7b at full width cut to VLM_MODEL's 1 layer, in
    f32 with dense weights and in bf16 with rtn-int4 weights: the same
    params, 2,880 patch embeddings, tables and tokens through ``T.prefill``
    (the prefix counts as context: ``seq_lens`` must read prefix + text)
    and 3 teacher-forced ``T.decode_step``s on ``dev`` and on ``ref_dev``
    (VLM_MODEL's rows of the dtype); every step's logits within VLM_TOL
    of the dtype; ``T.forward`` over
    the longer request's prefix and text on both, its greedy tokens at
    every one of its 3,080 positions agreeing on at least MODEL_AGREEMENT
    (a share of 8 served logits rows would be all or nothing: one bf16
    near-tie flips an eighth); and on ``dev`` the same prefill with other
    patch embeddings, whose logits must move past the tolerance (the
    prefix is attended).  In f32, with ``dev`` not ``ref_dev``, it also
    records, and does not hold, RoPE's part in the error: the two devices'
    frequency tables (``_rope_tables``) and the forward on ``dev`` again
    with RoPE computed on ``ref_dev`` (``_rope_on``)."""
    import numpy as np
    import torch
    from repro_torch.bridge import tree_to
    from repro_torch.configs.registry import get_config, get_reduced
    from repro_torch.models import transformer as T
    from repro_torch.models.quantize import quantize_params_rtn
    vm = VLM_MODEL
    base = get_reduced(LLAVA) if reduced else get_config(LLAVA)
    P = base.num_prefix_embeds
    rng = np.random.default_rng(0)
    every, n = np.array(vm["text"], np.int32), vm["steps"]
    S = int(every.max())
    all_toks = rng.integers(0, base.vocab_size,
                            (len(every), S + n)).astype(np.int32)
    all_ve = _vision_embeds(base, len(every), 1)
    all_other = _vision_embeds(base, len(every), 2)
    mb = -(-(P + S + n) // base.paging.block_size)
    out = {}
    for dtype, quant in (("float32", None), ("bfloat16", "rtn-int4")):
        t0 = time.perf_counter()
        sel = list(vm["rows"][dtype])
        B, lens, toks = len(sel), every[sel], all_toks[sel]
        ve, other = all_ve[sel], all_other[sel]
        table = np.arange(B * mb, dtype=np.int32).reshape(B, mb)
        cfg = base.replace(num_layers=vm["layers"], dtype=dtype)
        params = T.init_params(cfg, 1, ref_dev)
        if quant:
            params = quantize_params_rtn(params, cfg, GS)
        res = {}
        with torch.no_grad():
            for d in (ref_dev, dev):
                # the CPU multiplies by the plain int4 product's own
                # weights, dequantized once (``dequantized``)
                p = T.split_layers(T.cast_params(tree_to(
                    dequantized(params, T.act_dtype(cfg)) if d == ref_dev
                    else params, d), T.act_dtype(cfg)))

                def wave(embeds):
                    st = T.make_decode_state(cfg, B, B * mb, mb, device=d)
                    st["block_table"] = torch.from_numpy(table).to(d)
                    return T.prefill(cfg, p, st, {
                        "tokens": torch.from_numpy(toks[:, :S]).to(d),
                        "ctx_lens": torch.from_numpy(lens).to(d),
                        "vision_embeds": torch.from_numpy(embeds).to(d)})
                logits, st = wave(ve)
                seq_lens = st["seq_lens"].cpu().tolist()
                steps = [logits.float().cpu()]
                for t in range(n):
                    pos = lens + t
                    st["seq_lens"] = torch.from_numpy(P + pos + 1).to(d)
                    logits, st = T.decode_step(
                        cfg, p, st,
                        torch.from_numpy(toks[np.arange(B), pos]).to(d))
                    steps.append(logits.float().cpu())
                moved = None
                if d == dev:
                    moved = (wave(other)[0].float().cpu()
                             - steps[0]).abs().max().item()
                del st
                # the longer request alone: 3,080 positions, half the
                # CPU's time of both
                one = {"tokens": torch.from_numpy(toks[-1:, :S]).to(d),
                       "vision_embeds": torch.from_numpy(ve[-1:]).to(d)}
                fwd = T.forward(cfg, p, one)
                if d == dev and quant is None and dev != ref_dev:
                    rope_probe = _rope_on(ref_dev, lambda: T.forward(
                        cfg, p, one)).float().cpu()
                res[d] = (torch.stack(steps), seq_lens, moved,
                          fwd.float().cpu())
                del p, fwd
        del params
        (l0, sl0, _, f0), (l1, sl1, moved, f1) = res[ref_dev], res[dev]
        tol = VLM_TOL[dtype]
        r = {"quant": quant, "logit_max_abs_err": (l1 - l0).abs().max().item(),
             "max_abs_logit": l0.abs().max().item(),
             "served_rows_greedy_agreement": float(
                 (l1.argmax(-1) == l0.argmax(-1)).float().mean()),
             "greedy_agreement": float((f1.argmax(-1) == f0.argmax(-1))
                                       .float().mean()),
             "forward_positions": f0.shape[0] * f0.shape[1],
             "forward_logit_max_abs_err": (f1 - f0).abs().max().item(),
             "other_prefix_max_abs_logit_change": moved,
             "text_lens": lens.tolist(),
             "seq_lens_after_prefill": sl1, "tolerance": tol,
             "seconds": time.perf_counter() - t0}
        if quant is None and dev != ref_dev:
            r["rope"] = _rope_tables(cfg, dev, ref_dev, P + S)
            r["rope"]["forward_logit_max_abs_err_rope_on_ref"] = \
                (rope_probe - f0).abs().max().item()
        out[dtype] = r
        want_lens = (P + lens).tolist()
        if not (r["logit_max_abs_err"] <= tol
                and r["greedy_agreement"] >= MODEL_AGREEMENT
                and bool(torch.isfinite(l1).all())
                and sl0 == sl1 == want_lens and moved > tol):
            raise AssertionError(f"vlm model {dtype}: card vs CPU {r} "
                                 f"(seq_lens want {want_lens}, the other "
                                 f"prefix must move the logits past {tol})")
    out.update(config=base.name, layers=vm["layers"], prefix=P,
               text_lens=list(vm["text"]), decode_steps=n)
    return out


def vision_wave(llm, kernels, dev: str = "cuda") -> dict:
    """The served model (the runner's rtn-int4 params) at full depth on
    the vision path the reference takes (``transformer.prefill`` /
    ``decode_step`` with ``batch["vision_embeds"]``; its engine passes no
    image): four requests, each 2,880 patch embeddings and VISION_TEXT's
    text tokens, in one ``T.prefill`` over a private table of ceil((2,880
    + 200 + VISION_STEPS) / 16) blocks a request, then VISION_STEPS greedy
    ``T.decode_step``s over the paged pool.  Every served token (the
    wave's and each step's) is held to teacher forcing: ``T.forward`` over
    [prefix + text + the served tokens before it], on the card.  Launches
    are counted from zero for the wave and for each step: the static
    kernel once a layer in the wave, the decode kernel once a layer a
    step, ``gptq_matmul`` as its plans give for each linear.  On the card
    the wave's device time is split (``device_split``).  Returns the
    record, with the launches of the wave and every step
    (``"launches"``)."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as T
    cfg, params = llm.cfg, llm.engine.runner.params
    card = dev != "cpu"
    P, B = cfg.num_prefix_embeds, len(VISION_TEXT)
    lens = np.array(VISION_TEXT, np.int32)
    if cfg.d_model < 4096:                 # a reduced config's rehearsal
        lens = np.minimum(lens, 40)
    S, n = int(lens.max()), VISION_STEPS
    rng = np.random.default_rng(3)
    text = rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
    ve = torch.from_numpy(_vision_embeds(cfg, B, 4)).to(dev)
    mb = -(-(P + S + n) // cfg.paging.block_size)
    st = T.make_decode_state(cfg, B, B * mb, mb, device=dev)
    st["block_table"] = torch.arange(B * mb, dtype=torch.int32,
                                     device=dev).reshape(B, mb)
    batch = {"tokens": torch.from_numpy(text).to(dev),
             "ctx_lens": torch.from_numpy(lens).to(dev), "vision_embeds": ve}
    for k in kernels:
        k.launches = 0
    if card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, st = T.prefill(cfg, params, dict(st), batch)
        if card:
            torch.cuda.synchronize()
        wave_s = time.perf_counter() - t0
        wave_launches = {k.name: k.launches for k in kernels}
        served, step_logits = [logits.argmax(-1).int()], [logits.float()]
        step_launches = []
        for t in range(n):
            for k in kernels:
                k.launches = 0
            st["seq_lens"] = torch.from_numpy(P + lens + t + 1).to(dev)
            logits, st = T.decode_step(cfg, params, st, served[-1])
            step_launches.append({k.name: k.launches for k in kernels})
            served.append(logits.argmax(-1).int())
            step_logits.append(logits.float())
        if card:
            torch.cuda.synchronize()
        steps_s = time.perf_counter() - t0 - wave_s
        peak = torch.cuda.max_memory_allocated() if card else None
        served = torch.stack(served, 1).cpu()            # [B, n + 1]
        step_logits = torch.stack(step_logits, 1)        # [B, n + 1, V]
        # teacher forcing: the forward over prefix, text and the served
        # tokens before each one
        same, gaps, rel = [], [], 0.0
        for b in range(B):
            seq = torch.cat([torch.from_numpy(text[b, :lens[b]]),
                             served[b, :-1].long()]).to(dev)
            lg = T.forward(cfg, params, {"tokens": seq[None],
                                         "vision_embeds": ve[b:b + 1]})[
                0, P + int(lens[b]) - 1:].float()
            got = served[b].to(dev).long()
            gaps += (lg.max(-1).values - lg.gather(-1, got[:, None])[:, 0]) \
                .cpu().tolist()
            same += (lg.argmax(-1) == got).cpu().tolist()
            rel = max(rel, ((step_logits[b] - lg).abs().max()
                            / lg.abs().max()).item())
    total = {k: wave_launches[k] + sum(s[k] for s in step_launches)
             for k in wave_launches}
    out = {"requests": B, "prefix": P, "text_lens": lens.tolist(),
           "wave_rows": [B, P + S], "decode_steps": n,
           "blocks_per_request": mb, "wave_s": wave_s, "steps_s": steps_s,
           "max_memory_allocated": peak, "launches": total,
           "wave_launches": wave_launches, "step_launches": step_launches[0],
           "teacher_forced": {
               "agreement": sum(same) / len(same), "tokens": len(same),
               "max_gap": max(gaps), "mean_gap": sum(gaps) / len(gaps),
               "max_rel_logit_err": rel}}
    if card:
        L = cfg.num_layers
        want_wave = {"flash_attention": L,
                     "gptq_matmul": _gptq_launches(cfg, B * (P + S), L),
                     "paged_attention": 0, "flash_attention_chunk": 0}
        want_step = {"flash_attention": 0, "paged_attention": L,
                     "gptq_matmul": _gptq_launches(cfg, B, L),
                     "flash_attention_chunk": 0}
        got_wave = {k: wave_launches.get(k, 0) for k in want_wave}
        bad = [s for s in step_launches
               if {k: s.get(k, 0) for k in want_step} != want_step]
        if got_wave != want_wave or bad:
            raise AssertionError(f"vision wave: launches {got_wave} (want "
                                 f"{want_wave}), decode steps off "
                                 f"{want_step}: {bad[:2]}")
        out["wave_split"] = device_split(
            lambda: T.prefill(cfg, params, dict(st), batch))
        out["wave_split"]["wave"] = out["wave_rows"]
    return out


def phase_vlm(report: dict, gen, kernels) -> list:
    """Phase 10 on the card: the decode and chunk kernels at llava's G = 4
    (32 query heads over 8 KV heads), the decode kernel again at the
    vision decode's 194-block tables and ~3,000 keys (``check_paged_vision``:
    25 splits, rows held to their RMS), the static kernel at the vision
    wave's shape (causal, G = 4), ``gptq_matmul`` at its linears at decode
    and at the wave's 12,320 rows (K 14,336 for w_down); the 2-layer
    full-width model card vs CPU with the 2,880-patch prefix (f32 and bf16
    int4, and the other-prefix control); full-depth llava-next-mistral-7b
    with ``rtn-int4`` weights served on the engine's defaults
    (``llava-defaults``: text prompts, chunked, async, graphs on and off,
    profiled, 0 pageable copies), then the vision wave (``vision_wave``:
    four requests of 2,880 patches plus text, one prefill and 16 decode
    steps, every token held to teacher forcing) and its time split.
    Returns the kernel checks."""
    import torch
    from repro_torch.serving import LLM
    r = report["vlm"] = {}
    t_phase = time.perf_counter()
    checks = []
    for check, label in ((check_paged_attention, "paged_attention[G=4]"),
                         (check_flash_attention_chunk,
                          "flash_attention_chunk[G=4]")):
        k = check(gen, heads=LLAVA_HEADS)
        k["label"], k["serves"] = label, ("llava-defaults",)
        checks.append(k)
    checks.append(check_paged_vision(gen))
    checks.append(check_flash_attention_vision(gen))
    g = check_gptq_matmul(
        gen, shapes=LLAVA_GPTQ_SHAPES, main_shape=("gate/up", 8),
        shape="x[8,4096] @ int4[4096,14336] gs 32 (w_up, decode)",
        library_max_m=8192)
    g["label"] = "gptq_matmul[llava]"
    checks.append(g)
    for k in checks:
        lib = "null" if k["library_ms"] is None else f"{k['library_ms']:.4f}"
        log(f"[kernel] {k['label']}: kernel_ms={k['ms']:.4f} "
            f"plain_ms={k['plain_ms']:.4f} library_ms={lib} "
            f"bound_ms={k['bound'][0]:.5f} ({k['bound'][1]}) "
            f"max_abs_err={k['max_abs_err']:.3e} [{k['shape']}]")
    r["kernels"] = checks
    log_time("vlm kernels")
    r["model"] = res = phase_vlm_model()
    log(f"[model] {VLM_MODEL['layers']}-layer full-width {LLAVA} with a "
        f"2,880-patch prefix, card vs CPU: {json.dumps(res)}")
    log_time("vlm model")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    llm = LLM.load(LLAVA, quant="rtn-int4", seed=0)
    torch.cuda.synchronize()
    load_s, load_peak = time.perf_counter() - t0, \
        torch.cuda.max_memory_allocated()
    eng = llm.engine
    log(f"[serve] {LLAVA} rtn-int4 loaded in {load_s:.2f} s, peak "
        f"{load_peak} B; engine chunked={eng.chunked} "
        f"async_step={eng.async_step}")
    if not (eng.chunked and eng.async_step):
        raise AssertionError(f"{LLAVA}: its defaults must be chunked and "
                             "async, as any full-attention decoder's")
    serve = phase_serve("cuda", config=LLAVA, kernels=kernels,
                        label="llava-defaults", options={},
                        must=BF16_CHUNKED_KERNELS[0],
                        never=BF16_CHUNKED_KERNELS[1],
                        profile=True, llm=llm, graphs_off=True)
    serve["load_s"], serve["load_max_memory_allocated"] = load_s, load_peak
    log_serve("llava-defaults", serve, "rtn-int4")
    if serve["profile"]["pageable_copies"]:
        raise AssertionError("llava serve: pageable memcpys under the "
                             "profiler (want 0)")
    log_time("vlm serve")
    wave = vision_wave(llm, kernels)
    ws, tf = wave.pop("wave_split"), wave["teacher_forced"]
    log(f"[vision] {json.dumps(wave)}")
    if not (tf["agreement"] >= TEACHER_AGREEMENT
            and tf["max_gap"] <= TEACHER_GAP):
        raise AssertionError(f"vision wave: served tokens against teacher "
                             f"forcing (agreement >= {TEACHER_AGREEMENT}, "
                             f"gap <= {TEACHER_GAP}): {tf}")
    wave["wave_split"] = ws
    log(f"[wave] one vision wave {ws['wave']}: {ws['ms']:.1f} ms between "
        f"events, {ws['device_busy_ms']:.1f} ms of device time: "
        + ", ".join(f"{k} {ws['device_ms'][k]:.1f} ms "
                    f"({ws['device_share'][k]:.3f}, "
                    f"{ws['device_launches'][k]} launches)"
                    for k in ws["device_ms"]))
    r["serve"] = {"llava-defaults": serve,
                  "vision-wave": {"launches": wave["launches"]}}
    r["vision"] = wave
    llm.close()
    del llm
    torch.cuda.empty_cache()
    r["seconds"] = time.perf_counter() - t_phase
    log(f"[vlm] phase 10 took {r['seconds']:.1f} s")
    return checks


# --------------------------------------------------------------------------
# Phase 11: the audio encoder (hubert-xlarge: layernorm, non-causal ALiBi,
# head dim 80 on the static kernel)
# --------------------------------------------------------------------------

HUBERT = "hubert-xlarge"
HUBERT_HEADS = (16, 16, 80)      # its query heads, KV heads and head dim
HUBERT_FRAMES = (8, 1500)        # 30 s of audio at 20 ms a frame, 8 clips
HUBERT_LINEARS = {"wq/wk/wv/wo": (1280, 1280), "up": (1280, 5120),
                  "down": (5120, 1280)}
HUBERT_GPTQ_SHAPES = [(lname, K, N, GS, (HUBERT_FRAMES[0] * HUBERT_FRAMES[1],))
                      for lname, (K, N) in HUBERT_LINEARS.items()]
# the static kernel's D = 80 instantiation, as cuobjdump and ptxas name it
D80_KERNEL = "flash_attention_mma_kernelILi80E"
# the 2-layer full-width encoder on frames [2, 1500], card vs CPU
AUDIO_MODEL = {"layers": 2, "frames": (2, 1500)}
AUDIO_TOL = {"float32": MOE_LOGIT_TOL, "bfloat16": LOGIT_TOL}
# the full-depth bf16 forward against the f32 forward of the same int4
# weights on the card: the RMS of the logits' difference over the f32
# logits' RMS, and the share of frames whose argmax label agrees
HUBERT_DEPTH_RMS_REL = 0.05
HUBERT_DEPTH_AGREEMENT = 0.9


def check_flash_attention_d80(gen):
    """The static kernel at hubert-xlarge's heads (16 over 16, head dim
    80, Q K^T in five k-steps of 16, P V at N = 80) on its frames
    [8, 1500]: not causal
    with ALiBi by |q_pos - k_pos| (the encoder's case), causal, and not
    causal without ALiBi; each against the plain version one (sequence,
    KV head) at a time, timed beside SDPA with the same additive bias."""
    from repro_torch.core.alibi import alibi_slopes
    h, kv, d = HUBERT_HEADS
    b, S = HUBERT_FRAMES
    slopes = alibi_slopes(h, "cuda")
    cases = [(f"hubert [{b},{S}] not causal, ALiBi",
              _qkv(gen, b, S, S, h, kv, d),
              {"causal": False, "alibi_slopes": slopes}),
             (f"[{b},{S}] causal", _qkv(gen, b, S, S, h, kv, d), {}),
             (f"[{b},{S}] not causal, no ALiBi",
              _qkv(gen, b, S, S, h, kv, d), {"causal": False})]
    return _flash_wave_record(cases, "flash_attention[D=80]",
                              "not causal, ALiBi |q - k|")


def phase_audio_model(dev: str = "cuda", ref_dev: str = "cpu",
                      reduced: bool = False) -> dict:
    """hubert-xlarge at full width cut to AUDIO_MODEL's 2 layers, in f32
    with dense weights and in bf16 with rtn-int4 weights: the same params
    and frames [2, 1500, 1280] through ``T.forward`` on ``dev`` and on
    ``ref_dev``; logits within AUDIO_TOL of the dtype, argmax labels
    agreeing on at least MODEL_AGREEMENT of the frames."""
    import numpy as np
    import torch
    from repro_torch.bridge import tree_to
    from repro_torch.configs.registry import get_config, get_reduced
    from repro_torch.models import transformer as T
    from repro_torch.models.quantize import quantize_params_rtn
    base = get_reduced(HUBERT) if reduced else get_config(HUBERT)
    rng = np.random.default_rng(0)
    frames = (rng.standard_normal((*AUDIO_MODEL["frames"], base.d_model),
                                  dtype=np.float32) * 0.1)
    out = {}
    for dtype, quant in (("float32", None), ("bfloat16", "rtn-int4")):
        t0 = time.perf_counter()
        cfg = base.replace(num_layers=AUDIO_MODEL["layers"], dtype=dtype)
        params = T.init_params(cfg, 1, ref_dev)
        if quant:
            params = quantize_params_rtn(params, cfg, GS)
        res = {}
        with torch.no_grad():
            for d in (ref_dev, dev):
                p = T.split_layers(T.cast_params(tree_to(params, d),
                                                 T.act_dtype(cfg)))
                res[d] = T.forward(cfg, p, {"frames": torch.from_numpy(
                    frames).to(d)}).float().cpu()
                del p
        del params
        l0, l1 = res[ref_dev], res[dev]
        tol = AUDIO_TOL[dtype]
        r = {"quant": quant, "logit_max_abs_err": (l1 - l0).abs().max().item(),
             "max_abs_logit": l0.abs().max().item(),
             "logit_rms": l0.pow(2).mean().sqrt().item(),
             "label_agreement": float((l1.argmax(-1) == l0.argmax(-1))
                                      .float().mean()),
             "tolerance": tol, "seconds": time.perf_counter() - t0}
        out[dtype] = r
        if not (r["logit_max_abs_err"] <= tol
                and r["label_agreement"] >= MODEL_AGREEMENT
                and bool(torch.isfinite(l1).all())):
            raise AssertionError(f"audio model {dtype}: card vs CPU {r}")
    out.update(config=base.name, layers=AUDIO_MODEL["layers"],
               frames=list(AUDIO_MODEL["frames"]))
    return out


def hubert_depth(kernels, dev: str = "cuda", reduced: bool = False) -> dict:
    """Full-depth hubert-xlarge (48 layers) with rtn-int4 weights drawn a
    layer at a time from seed 0: ``T.forward`` on HUBERT_FRAMES' frames
    [8, 1500, 1280] in bf16, counted from zero (the static kernel 48
    times, every launch not causal with ALiBi at head dim 80;
    ``gptq_matmul`` as its plans give for 48 x 6 linears), finite logits
    [8, 1500, 504], its device ms (``time_ms``), frames per second and
    peak memory, and its device time split (``device_split``); then the
    f32 forward of the same int4 weights on the
    card, against which the bf16 logits are held: RMS of the difference
    over RMS within HUBERT_DEPTH_RMS_REL, argmax labels agreeing on at
    least HUBERT_DEPTH_AGREEMENT of the frames."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config, get_reduced
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import transformer as T
    from repro_torch.models.quantize import quantize_params_rtn
    card = dev != "cpu"
    cfg = get_reduced(HUBERT) if reduced else get_config(HUBERT)
    t0 = time.perf_counter()
    params = T.init_params(cfg, 0, dev, layer_fn=lambda layer:
                           quantize_params_rtn(layer, cfg, GS))
    load_s = time.perf_counter() - t0
    b, S = HUBERT_FRAMES if not reduced else (2, 64)
    rng = np.random.default_rng(5)
    frames = torch.from_numpy(rng.standard_normal(
        (b, S, cfg.d_model), dtype=np.float32) * 0.1).to(dev)
    bf16 = T.split_layers(T.cast_params(params, torch.bfloat16))
    if card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    # each static-kernel launch's (head dim, causal, ALiBi), as the wrapper
    # records them where it launches
    flash_attention.launch_kinds.clear()
    with torch.no_grad():
        logits = T.forward(cfg, bf16, {"frames": frames})
        if card:
            torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    kinds = dict(flash_attention.launch_kinds)
    peak = torch.cuda.max_memory_allocated() if card else None
    out = {"config": cfg.name, "layers": cfg.num_layers, "frames": [b, S],
           "init_s": load_s, "launches": launches,
           "flash_calls": sorted((str(k), n) for k, n in kinds.items()),
           "logits": list(logits.shape),
           "finite": bool(torch.isfinite(logits).all()),
           "max_memory_allocated": peak}
    if card:
        out["split"] = split = device_split(lambda: T.forward(
            cfg, bf16, {"frames": frames}))
        out["ms"] = split["ms"]
        out["frames_per_s"] = b * S / (split["ms"] / 1e3)
    with torch.no_grad():
        f32 = T.split_layers(params)
        want = T.forward(cfg.replace(dtype="float32"), f32,
                         {"frames": frames}).float()
    got = logits.float()
    out["vs_f32"] = cmp = {
        "rms_rel_err": ((got - want).pow(2).mean().sqrt()
                        / want.pow(2).mean().sqrt()).item(),
        "max_abs_err": (got - want).abs().max().item(),
        "max_abs_logit": want.abs().max().item(),
        "label_agreement": (got.argmax(-1) == want.argmax(-1)).float()
        .mean().item(),
        "rms_rel_limit": HUBERT_DEPTH_RMS_REL,
        "agreement_limit": HUBERT_DEPTH_AGREEMENT}
    if not (out["finite"] and out["logits"] == [b, S, cfg.vocab_size]
            and cmp["rms_rel_err"] <= HUBERT_DEPTH_RMS_REL
            and cmp["label_agreement"] >= HUBERT_DEPTH_AGREEMENT):
        raise AssertionError(f"hubert full depth: {out}")
    if card:
        L, d = cfg.num_layers, cfg.resolved_head_dim
        want_gptq = _gptq_launches(cfg, b * S, L)
        if kinds != {(d, False, True): L} \
                or launches["flash_attention"] != L \
                or launches["gptq_matmul"] != want_gptq:
            raise AssertionError(
                f"hubert full depth: static-kernel launches {kinds} (want "
                f"{L} x (head dim {d}, not causal, ALiBi)), counters "
                f"{launches} (gptq_matmul want {want_gptq})")
    return out


def phase_audio(report: dict, gen, kernels) -> list:
    """Phase 11 on the card: the static kernel's D = 80 instantiation (HGMMA
    in its SASS, ptxas's registers and spills) at hubert's frames, not
    causal with ALiBi, causal, and not causal without ALiBi;
    ``gptq_matmul`` at its linears at the frames' 12,000 rows; the
    2-layer full-width encoder card vs CPU (f32 and bf16 int4); the
    full-depth rtn-int4 forward (``hubert_depth``) with its time split.
    Returns the kernel checks."""
    import torch
    from repro_torch.kernels import build
    r = report["audio"] = {}
    t_phase = time.perf_counter()
    sass = {n: c["HGMMA"] for n, c in report["tensor_core_sass"].items()
            if D80_KERNEL in n}
    if not sass or not all(sass.values()):
        raise AssertionError(f"{D80_KERNEL}: no HGMMA in its SASS: {sass}")
    usage = ptxas_usage(build.LOGS.get("flash_attention", ""), D80_KERNEL)
    r["d80_sass_hgmma"], r["d80_ptxas"] = sum(sass.values()), usage
    log(f"[audio] flash_attention_mma_kernel<80>: {r['d80_sass_hgmma']} HGMMA "
        "in its SASS; ptxas "
        + (json.dumps(usage) if usage else "not measured (cached build)"))
    checks = [check_flash_attention_d80(gen)]
    g = check_gptq_matmul(
        gen, shapes=HUBERT_GPTQ_SHAPES, main_shape=("up", 12000),
        shape="x[12000,1280] @ int4[1280,5120] gs 32 (w_up, the frames)",
        library_max_m=16384)
    g["label"] = "gptq_matmul[hubert]"
    checks.append(g)
    for k in checks:
        lib = "null" if k["library_ms"] is None else f"{k['library_ms']:.4f}"
        log(f"[kernel] {k['label']}: kernel_ms={k['ms']:.4f} "
            f"plain_ms={k['plain_ms']:.4f} library_ms={lib} "
            f"bound_ms={k['bound'][0]:.5f} ({k['bound'][1]}) "
            f"max_abs_err={k['max_abs_err']:.3e} [{k['shape']}]")
    r["kernels"] = checks
    r["model"] = res = phase_audio_model()
    log(f"[model] {AUDIO_MODEL['layers']}-layer full-width {HUBERT} card vs "
        f"CPU: {json.dumps(res)}")
    log_time("audio model")
    r["depth"] = dp = hubert_depth(kernels)
    log(f"[audio] full-depth {HUBERT} rtn-int4 bf16 forward: "
        f"{json.dumps(dp)}")
    r["serve"] = {"hubert-forward": {"launches": dp["launches"]}}
    torch.cuda.empty_cache()
    r["seconds"] = time.perf_counter() - t_phase
    log(f"[audio] phase 11 took {r['seconds']:.1f} s")
    return checks


# --------------------------------------------------------------------------
# Phase 12: command-r-plus-104b at full width and depth (rtn-int4 at group
# 128, layernorm, G = 12 on the paged kernels)
# --------------------------------------------------------------------------

CMDR = "command-r-plus-104b"
CMDR_HEADS = (96, 8)             # its query heads over KV heads: G = 12
# int4 group size: at 32 the served tree is 81.8 GB (scales and zeros
# 25.2 GB of it) and fills the card; at 128 it is 62.9 GB
CMDR_GS = 128
CMDR_LINEARS = {"wq/wo": (12288, 12288), "wk/wv": (12288, 1024),
                "gate/up": (12288, 33792), "down": (33792, 12288)}
# every int4 linear at decode (8 rows) and at a chunk's 256
CMDR_GPTQ_SHAPES = [(lname, K, N, CMDR_GS, (B, W))
                    for lname, (K, N) in CMDR_LINEARS.items()]
# the 2-layer full-width model, card vs CPU, also through T.forward over
# [rows, positions] tokens: greedy agreement at every position
CMDR_FORWARD = (2, 64)
# its bf16 logits card vs CPU, over their largest magnitude.  LOGIT_TOL
# (0.1 absolute) was set where the largest logit is ~4 (qwen2-1.5b's check
# reads 0.043 at 3.81, llava's 0.047 at 4.34: 0.011 of it); command-r's
# tied embedding at d 12,288 makes logits ~3x larger, and the same bf16
# noise 3x larger in absolute terms
CMDR_LOGIT_REL_TOL = 0.02
# greedy agreement of those logits over CMDR_FORWARD's positions.  Over
# 256,000 random-weight logits of ~2.5 spread the top two lie ~0.5 apart,
# and the card's and the CPU's bf16 roundings (0.125 apart at most) flip
# ~5% of positions (an H100 80GB HBM3 at 700 W read 0.945 of 128, where
# llava's 32,000 logits flipped 1.8%): MODEL_AGREEMENT (0.95) would fail
# about every other run on near-ties alone, so this check is held at
# TEACHER_AGREEMENT, the bf16 paths' token limit against an oracle
CMDR_AGREEMENT = TEACHER_AGREEMENT
# the model checks' depth: 1 layer (2 once), whose CPU side
# (bf16 products, the int4 dequantized at every call) took ~100 s of the
# script's 1,200 s limit on the card's host (ROADMAP C16); multi-layer
# pool indexing is held by qwen2-1.5b's 2-layer phase_model
CMDR_MODEL_LAYERS = 1


def cmdr_forward(dev: str = "cuda", ref_dev: str = "cpu", layers: int = 2,
                 shape=CMDR_FORWARD) -> dict:
    """command-r at full width cut to ``layers``, rtn-int4 at CMDR_GS in
    bf16 with drawn norms (``random_norms``), the same params and tokens
    through ``T.forward`` on ``dev`` and ``ref_dev``: the logits at every
    position within CMDR_LOGIT_REL_TOL of their largest magnitude, and
    their greedy tokens agreeing on at least CMDR_AGREEMENT (a share of
    a few served rows would be all or nothing: one bf16 near-tie over
    256,000 logits flips a row).  The CPU side multiplies by the plain
    version's dequantized weights (``dequantized``).  The control: the
    forward on ``dev`` with every layernorm bias dropped must miss the
    limit (the check sees the bias)."""
    import numpy as np
    import torch
    from repro_torch.bridge import tree_to
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.quantize import quantize_params_rtn
    cfg = get_config(CMDR).replace(num_layers=layers)
    params = random_norms(quantize_params_rtn(T.init_params(cfg, 1, dev),
                                              cfg, CMDR_GS))
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, shape).astype(np.int32))
    act = T.act_dtype(cfg)

    def no_bias(tree, key=""):
        if isinstance(tree, dict):
            return {k: no_bias(v, k) for k, v in tree.items()}
        return torch.zeros_like(tree) if key == "b" else tree
    out = {}
    t0 = time.perf_counter()
    with torch.no_grad():
        for name, d, tree in (("ref", ref_dev, dequantized(params, act)),
                              ("card", dev, params),
                              ("control", dev, no_bias(params))):
            p = T.cast_params(tree_to(tree, d), act)
            out[name] = T.forward(cfg, p, {"tokens": toks.to(d)}) \
                .float().cpu()
            del p, tree
    want, got = out["ref"], out["card"]
    scale = want.abs().max().item()
    tol = CMDR_LOGIT_REL_TOL * scale
    err = (got - want).abs().max().item()
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    control = (out["control"] - want).abs().max().item()
    res = {"positions": int(np.prod(shape)), "logit_max_abs_err": err,
           "max_abs_logit": scale, "greedy_agreement": agree,
           "control_bias_dropped_max_abs_err": control,
           "tolerance": tol, "relative_tolerance": CMDR_LOGIT_REL_TOL,
           "seconds": time.perf_counter() - t0}
    if not (err <= tol and agree >= CMDR_AGREEMENT
            and bool(torch.isfinite(got).all())):
        raise AssertionError(f"model {CMDR} forward, card vs CPU: {res} "
                             f"(greedy >= {CMDR_AGREEMENT})")
    if not control > tol:
        raise AssertionError(f"model {CMDR} forward: the control with the "
                             f"layernorm biases dropped reads {control}, "
                             f"within the limit {tol}: the check is blind")
    return res


def served_bytes(params) -> int:
    """Bytes of every leaf a decode step reads from the served tree: int4
    codes, scales and zeros, norms, and the tied embedding (the
    unembedding reads all of it; the rows the lookup reads are part of
    it).  ``g_idx`` is not read on the card (the kernel takes contiguous
    groups)."""
    from repro_torch.models import transformer as T

    def walk(tree):
        if isinstance(tree, dict):
            return sum(walk(v) for k, v in tree.items() if k != "g_idx")
        if isinstance(tree, list):
            return sum(walk(v) for v in tree)
        return tree.numel() * tree.element_size()
    return walk({k: v for k, v in params.items() if k not in T.STACKS}) \
        + sum(walk(params[k]) for k in T.STACKS if k in params)


def paged_decode_ms(llm) -> dict:
    """One full-depth decode step of the served model over its paged pool
    with every slot's table full (max_blocks_per_seq x 16 keys):
    ``decode_step_times`` (elapsed, graphed, device busy), beside its
    bound: every leaf of the served tree it reads (``served_bytes``) and
    the pool's live K/V, over 3.35 TB/s, or its operations (two a weight
    and row, and the attention's) over the bf16 peak.  Writes one token
    per slot into the pool, so it runs after the serves."""
    import torch
    cfg, runner = llm.cfg, llm.engine.runner
    slots, mb = runner.max_slots, runner.mb
    keys = mb * cfg.paging.block_size
    st = dict(runner.state)
    st["seq_lens"] = torch.full((slots,), keys, dtype=torch.int32,
                                device="cuda")
    st["block_table"] = torch.arange(slots * mb, dtype=torch.int32,
                                     device="cuda").reshape(slots, mb)
    toks = torch.arange(slots, dtype=torch.int32, device="cuda")
    h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    weights = served_bytes(runner.params)
    kv_bytes = 2 * cfg.num_layers * slots * keys * kv * d * 2
    # two operations a weight and row (the embedding's in the
    # unembedding), and the attention's four a query head, key and dim
    flops = 2 * slots * cfg.num_params() \
        + 4 * cfg.num_layers * slots * h * d * keys
    out = decode_step_times(cfg, runner.params, st, toks)
    out.update(slots=slots, keys=keys, served_bytes=weights,
               kv_bytes=kv_bytes, params=cfg.num_params(),
               bound=bound_ms(weights + kv_bytes, flops))
    return out


def check_gptq_serve_launches(serve: dict, cfg, gs: int, slots: int,
                              width=None, wave_rows=None) -> int:
    """``gptq_matmul``'s launches over a serve, from the runner's steps:
    each decode step multiplies ``slots`` rows, each chunk ``width`` rows
    (a chunked engine) and each whole-prompt wave ``wave_rows`` rows (a
    whole-prompt one) through every layer's int4 linears, as their plans
    give (``_gptq_launches``: one a call).  Returns the count; raises on a
    step of the kind the engine does not run, and unless the wrapper
    counted the count."""
    steps = serve["runner_steps"]
    for kind, rows in (("chunk", width), ("wave", wave_rows)):
        if rows is None and steps.get(kind):
            raise AssertionError(f"serve {serve['label']}: {kind} steps "
                                 f"{steps} on an engine that runs none")
    want = steps["decode"] * _gptq_launches(cfg, slots, cfg.num_layers, gs) \
        + sum(steps[kind] * _gptq_launches(cfg, rows, cfg.num_layers, gs)
              for kind, rows in (("chunk", width), ("wave", wave_rows))
              if rows is not None)
    if serve["launches"]["gptq_matmul"] != want:
        raise AssertionError(f"serve {serve['label']}: gptq_matmul launched "
                             f"{serve['launches']['gptq_matmul']} times, its "
                             f"plans give {want} for the steps {steps}")
    return want


def cmdr_kernels(gen) -> list:
    """Phase 12's kernel checks: the decode and chunk kernels at
    command-r's G = 12 (96 query heads over 8 KV heads; 12 of the 16 mma
    rows live) in every case of PAGED_CASES / CHUNK_CASES, each live row
    also held to its own RMS; ``gptq_matmul`` at group size 128 at its
    linears at decode and at a chunk (w_down: K 33,792, 264 groups)."""
    import torch
    checks = []
    for check, label in ((check_paged_attention, "paged_attention[G=12]"),
                         (check_flash_attention_chunk,
                          "flash_attention_chunk[G=12]")):
        k = check(gen, heads=CMDR_HEADS, row_check=True)
        k["label"], k["serves"] = label, ("cmdr-defaults",)
        checks.append(k)
    g = check_gptq_matmul(
        gen, shapes=CMDR_GPTQ_SHAPES, main_shape=("gate/up", 8),
        shape="x[8,12288] @ int4[12288,33792] gs 128 (w_gate / w_up, "
              "decode)")
    g["label"], g["serves"] = "gptq_matmul[cmdr]", ("cmdr-defaults",)
    checks.append(g)
    for k in checks:
        lib = "null" if k["library_ms"] is None else f"{k['library_ms']:.4f}"
        log(f"[kernel] {k['label']}: kernel_ms={k['ms']:.4f} "
            f"plain_ms={k['plain_ms']:.4f} library_ms={lib} "
            f"bound_ms={k['bound'][0]:.5f} ({k['bound'][1]}) "
            f"max_abs_err={k['max_abs_err']:.3e} [{k['shape']}]")
    torch.cuda.empty_cache()
    return checks


def cmdr_model(layers: int = CMDR_MODEL_LAYERS) -> dict:
    """Phase 12's full-width model cut to ``layers``, card vs CPU:
    ``phase_model`` at group 128 over bf16 and int8 pools (the decode
    step, a chunk and the unified step, drawn norms, logits within
    CMDR_LOGIT_REL_TOL of their largest; no whole-prompt wave: the chunked
    serve runs none), then ``cmdr_forward`` (greedy agreement over its
    positions)."""
    import torch
    out = {}
    for kv in ("bf16", "int8"):
        t0 = time.perf_counter()
        out[kv] = res = phase_model("cuda", layers=layers, kv=kv,
                                    config=CMDR, gs=CMDR_GS,
                                    init_dev="cuda", wave=False,
                                    rel_tol=CMDR_LOGIT_REL_TOL)
        res["seconds"] = time.perf_counter() - t0
        log(f"[model] {layers}-layer full-width {CMDR} rtn-int4 gs {CMDR_GS}"
            f", {kv} pool, card vs CPU: {json.dumps(res)}")
        torch.cuda.empty_cache()
    out["forward"] = res = cmdr_forward(layers=layers)
    log(f"[model] {layers}-layer full-width {CMDR} T.forward card vs CPU: "
        f"{json.dumps(res)}")
    torch.cuda.empty_cache()
    return out


def cmdr_serve(kernels) -> dict:
    """Phase 12's full-depth part: command-r-plus-104b ``rtn-int4`` at
    group 128 (62.9 GB served) loaded (seconds, peak), served on the
    engine's defaults (``cmdr-defaults``: chunked, async, graphs on and
    off, profiled, 0 pageable copies, attention launches 64 x the
    runner's steps and ``gptq_matmul``'s as its plans give), and one full
    decode step timed beside its bound (``paged_decode_ms``)."""
    import torch
    from repro_torch.serving import LLM
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    llm = LLM.load(CMDR, quant="rtn-int4", quant_group_size=CMDR_GS, seed=0)
    torch.cuda.synchronize()
    load_s, load_peak = time.perf_counter() - t0, \
        torch.cuda.max_memory_allocated()
    eng = llm.engine
    served = served_bytes(eng.runner.params)
    log(f"[serve] {CMDR} rtn-int4 gs {CMDR_GS} loaded in {load_s:.2f} s "
        f"(init and RTN a layer at a time {llm.load_s['init']:.2f} s), peak "
        f"{load_peak} B, served tree {served} B, allocated "
        f"{torch.cuda.memory_allocated()} B; engine chunked={eng.chunked} "
        f"async_step={eng.async_step}")
    if not (eng.chunked and eng.async_step):
        raise AssertionError(f"{CMDR}: its defaults must be chunked and "
                             "async, as any full-attention decoder's")
    serve = phase_serve("cuda", config=CMDR, kernels=kernels,
                        label="cmdr-defaults", options={},
                        must=BF16_CHUNKED_KERNELS[0],
                        never=BF16_CHUNKED_KERNELS[1],
                        profile=True, llm=llm, graphs_off=True)
    serve["load_s"], serve["load_max_memory_allocated"] = load_s, load_peak
    serve["served_bytes"] = served
    log_serve("cmdr-defaults", serve, f"rtn-int4 gs {CMDR_GS}")
    for run in (serve, serve["off"]):
        if run["profile"]["pageable_copies"]:
            raise AssertionError(f"serve {run['label']}: pageable memcpys "
                                 "under the profiler (want 0)")
        run["gptq_launches_planned"] = check_gptq_serve_launches(
            run, llm.cfg, CMDR_GS, eng.runner.max_slots,
            eng.runner.chunk_tokens)
    log_time("cmdr serve")
    serve["decode_step"] = ds = paged_decode_ms(llm)
    log(f"[cmdr] one full-depth decode step, {ds['slots']} slots of "
        f"{ds['keys']} keys: {json.dumps(ds)}")
    llm.close()
    del llm, eng
    torch.cuda.empty_cache()
    return serve


def phase_cmdr(report: dict, gen, kernels) -> list:
    """Phase 12 on the card: ``cmdr_kernels``, ``cmdr_model`` and
    ``cmdr_serve``.  Returns the kernel checks."""
    r = report["cmdr"] = {}
    t_phase = time.perf_counter()
    r["kernels"] = checks = cmdr_kernels(gen)
    log_time("cmdr kernels")
    r["model"] = cmdr_model()
    log_time("cmdr model")
    r["serve"] = {"cmdr-defaults": cmdr_serve(kernels)}
    r["seconds"] = time.perf_counter() - t_phase
    log(f"[cmdr] phase 12 took {r['seconds']:.1f} s")
    return checks


# --------------------------------------------------------------------------
# Phase 13: the serve CLI (``python -m repro_torch.launch.serve``) in
# process, Opt-GQA and its MHA baseline
# --------------------------------------------------------------------------

CLI_ARGS = ("--arch", "qwen2-1.5b", "--no-reduced", "--quant", "rtn-int4",
            "--requests", "16", "--max-tokens", "32")
# the profiled run: torch.profiler records every kernel of the run (half a
# million for CLI_ARGS' 16 requests, which it slowed from ~2 s to ~25 s on
# an H100), so the timed runs go without it and a short run checks the
# capture
CLI_PROFILED = ("--requests", "4", "--max-tokens", "8")
# the MHA baseline's KV bytes a token over Opt-GQA's: 12 KV heads over 2
CLI_KV_RATIO = 6.0
CLI_KERNELS = ({"paged_attention", "flash_attention_chunk", "gptq_matmul"},
               {"paged_attention_quant", "flash_attention_chunk_int8",
                "flash_attention"} | SCAN_KERNELS)
# a gzipped profiler trace larger than this is checked, then not kept
CLI_PROFILE_KEEP = 8 << 20


def _finite(tree) -> bool:
    import math
    if isinstance(tree, dict):
        return all(_finite(v) for v in tree.values())
    if isinstance(tree, list):
        return all(_finite(v) for v in tree)
    return not isinstance(tree, float) or math.isfinite(tree)


def run_cli(argv, kernels, out_dir: Path, dev: str = "cuda",
            profile: bool = False) -> dict:
    """``repro_torch.launch.serve.main(argv)`` in process with
    ``--metrics-out`` and ``--trace-out`` (and with ``profile``
    ``--profile-dir``) under ``out_dir``; its printed lines read back
    (``read_output``), the kernels' launches counted from zero, and its
    files checked: every request finished with ``length``, the paged
    decode, chunk and int4 kernels launched and no other attention kernel,
    the span trace valid (``validate_chrome_trace``), the metrics snapshot
    finite, the profiler's Chrome trace holding kernel records (then
    gzipped, and kept if under CLI_PROFILE_KEEP).  ``dev="cpu"``
    rehearses it (``--device cpu`` and a reduced config in ``argv``): the
    plain versions count no launch and the profiler records no kernel
    there, so those two checks are the card's.  Returns the record."""
    import contextlib
    import gzip
    import io
    import shutil
    import torch
    from repro_torch.launch import serve as cli
    from repro_torch.obs.trace import validate_chrome_trace
    out_dir.mkdir(parents=True, exist_ok=True)
    files = {"metrics": out_dir / "metrics.json",
             "trace": out_dir / "trace.json", "profile": out_dir / "profile"}
    argv = [*argv, "--device", dev, "--metrics-out", str(files["metrics"]),
            "--trace-out", str(files["trace"])]
    if profile:
        argv += ["--profile-dir", str(files["profile"])]
    card = dev != "cpu"
    for k in kernels:
        k.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    if card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    got = cli.read_output(buf.getvalue())
    reqs, mode = got["requests"], got["mode"]
    label = mode["mode"] + (" profiled" if profile else "")
    n = cli._parser().parse_args(argv).requests
    bad = [q["rid"] for q in reqs if q["finish_reason"] != "length"]
    if len(reqs) != n or bad:
        raise AssertionError(f"cli {label}: {len(reqs)} request lines, not "
                             f"finished with length: {bad}")
    missing = [k for k in CLI_KERNELS[0] if launches.get(k, 0) <= 0]
    stray = [k for k in CLI_KERNELS[1] if launches.get(k, 0) > 0]
    if card and (missing or stray):
        raise AssertionError(f"cli {label}: kernels {missing} never "
                             f"launched, {stray} launched: {launches}")
    trace = json.loads(files["trace"].read_text())
    problems = validate_chrome_trace(trace)
    if problems:
        raise AssertionError(f"cli {label}: --trace-out invalid: "
                             f"{problems[:5]}")
    metrics = json.loads(files["metrics"].read_text())
    if not _finite(metrics):
        raise AssertionError(f"cli {label}: the metrics snapshot holds a "
                             "non-finite number")
    out = {"mode": mode["mode"], "wall_s": wall, "launches": launches,
           "requests": len(reqs), "report": mode,
           "attribution": got["attribution"],
           "trace_events": len(trace.get("traceEvents", [])),
           "tokens": [q["tokens"] for q in reqs]}
    if profile:
        prof = files["profile"] / "trace.json"
        events = json.loads(prof.read_text()).get("traceEvents", [])
        kernel_events = sum(e.get("cat") == "kernel" for e in events)
        if card and not kernel_events:
            raise AssertionError(f"cli {label}: --profile-dir's trace holds "
                                 "no kernel record")
        gz = Path(str(prof) + ".gz")
        with prof.open("rb") as src, gzip.open(str(gz), "wb") as dst:
            shutil.copyfileobj(src, dst)
        out.update(profile_kernel_records=kernel_events,
                   profile_trace_bytes=prof.stat().st_size)
        prof.unlink()
        if gz.stat().st_size > CLI_PROFILE_KEEP:
            gz.unlink()                  # checked, too large to keep
        out["profile_trace_kept"] = gz.exists()
    return out


def phase_cli(report: dict, kernels, dev: str = "cuda",
              args=CLI_ARGS) -> None:
    """Phase 13 on the card: the serve CLI in process, full-depth
    qwen2-1.5b rtn-int4, 16 requests of 32 new tokens (CLI_ARGS), once
    as Opt-GQA and once with ``--mha-baseline`` (12 KV heads, prefix reuse
    off), each checked by ``run_cli``, their KV bytes a token (the
    ``mode`` lines) in the ratio CLI_KV_RATIO; then a short Opt-GQA run
    with ``--profile-dir`` (CLI_PROFILED).  Both timed runs' tok/s and
    ITL are printed, a finding and no claim.  On the CPU (``dev="cpu"``,
    ``args`` with ``--reduced``) it rehearses the phase."""
    import torch
    r = report["cli"] = {}
    t_phase = time.perf_counter()
    base = ROOT / "chiprun_out" / "cli"
    for label, extra, profile in (
            ("opt-gqa", (), False), ("mha", ("--mha-baseline",), False),
            ("opt-gqa-profiled", CLI_PROFILED, True)):
        r[label] = run = run_cli([*args, *extra], kernels, base / label, dev,
                                 profile)
        rep = run["report"]
        log(f"[cli] {label}: {run['requests']} requests in "
            f"{run['wall_s']:.2f} s (load included): "
            f"generate_tok_s={rep['generate_tok_s']} "
            f"itl_p50_ms={rep['itl_p50_ms']} itl_p99_ms={rep['itl_p99_ms']} "
            f"ttft_p50_ms={rep['ttft_p50_ms']} "
            f"kv_bytes_per_token={rep['kv_bytes_per_token']} "
            f"launches={run['launches']} "
            f"attribution {json.dumps(run['attribution'])}"
            + (f" profile_kernel_records={run['profile_kernel_records']} "
               f"profile_trace_bytes={run['profile_trace_bytes']}"
               if profile else ""))
        if dev != "cpu":
            torch.cuda.empty_cache()
    ratio = r["mha"]["report"]["kv_bytes_per_token"] \
        / r["opt-gqa"]["report"]["kv_bytes_per_token"]
    r["kv_bytes_ratio"] = ratio
    if ratio != CLI_KV_RATIO:
        raise AssertionError(f"cli: kv_bytes_per_token MHA / Opt-GQA = "
                             f"{ratio}, want {CLI_KV_RATIO}")
    log(f"[cli] kv_bytes_per_token MHA / Opt-GQA = {ratio}")
    r["seconds"] = time.perf_counter() - t_phase
    log(f"[cli] phase 13 took {r['seconds']:.1f} s")


# --------------------------------------------------------------------------
# Phase 13 (b): the port's examples (examples/repro_torch/)
# --------------------------------------------------------------------------

EXAMPLES_DIR = ROOT / "examples" / "repro_torch"
EXAMPLE_TRAIN_STEPS = 4
# (example, its arguments besides --device, the kernels it must launch;
# every other kernel must not).  On the card each takes qwen2-1.5b at full
# width (head dim 128), cut to 4 layers (train_small: 6)
EXAMPLES = (
    ("quickstart", (), {"gptq_matmul", "paged_attention",
                        "flash_attention_chunk", "flash_attention"}),
    ("serve_batched", (), {"paged_attention", "flash_attention_chunk"}),
    ("quantize_model", (), {"gptq_matmul", "flash_attention"}),
    ("convert_mha_to_gqa", (), {"flash_attention"}),
    ("train_small", ("--steps", str(EXAMPLE_TRAIN_STEPS)),
     {"flash_attention"}))


def load_example(name: str):
    """``examples/repro_torch/<name>.py`` as a module (examples/ is not a
    package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES_DIR / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_example(name: str, out) -> None:
    """What each example's numbers must show, on any device."""
    import math
    ok = {"quickstart": lambda o: len(o["tokens"]) == 8 and all(
              len(t) == 8 for t in o["tokens"])
          and set(o["finish_reasons"]) == {"length"},
          "serve_batched": lambda o: o["finished"] == 24
          and o["rejected"] == 0,
          "quantize_model": lambda o: all(
              v["gptq"] < v["rtn"] for v in o["single"].values())
          and all(math.isfinite(v["mean_abs_drift"])
                  for v in o["model"].values()),
          "convert_mha_to_gqa": lambda o: sorted(
              h for g in o["groups"] for h in g) == list(range(o["heads"]))
          and len(o["groups"]) == o["kv_heads"]
          and math.isfinite(o["attention_rel_diff"]),
          "train_small": lambda o: len(o) == EXAMPLE_TRAIN_STEPS
          and all(math.isfinite(x) for x in o)}[name]
    if not ok(out):
        raise AssertionError(f"example {name}: {out}")


def phase_examples(report: dict, kernels, dev: str = "cuda") -> dict:
    """Phase 13 (b): each example's ``main([..., "--device", dev])`` in
    process, the launch counters zeroed just before and read just after:
    on the card each must launch the kernels EXAMPLES names and no other;
    its numbers are checked (``check_example``) and its seconds kept.
    ``train_small`` writes its checkpoint under ``build/`` (removed
    after)."""
    import shutil
    import torch
    r = report["examples"] = {}
    t_phase = time.perf_counter()
    names = {k.name for k in kernels}
    ckpt = ROOT / "build" / "train_small_smoke"
    for name, args, must in EXAMPLES:
        argv = [*args, "--device", dev]
        if name == "train_small":
            shutil.rmtree(ckpt, ignore_errors=True)
            argv += ["--ckpt-dir", str(ckpt)]
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        try:
            out = load_example(name).main(argv)
            if dev != "cpu":
                torch.cuda.synchronize()
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        secs = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
        missing = sorted(k for k in must & names if launches[k] <= 0)
        stray = sorted(k for k in names - must if launches[k] > 0)
        if missing or stray:
            raise AssertionError(f"example {name}: kernels {missing} never "
                                 f"launched, {stray} launched off its path: "
                                 f"{launches}")
        check_example(name, out)
        r[name] = {"seconds": secs, "launches": launches, "argv": argv}
        log(f"[examples] {name} {' '.join(argv)}: {secs:.1f} s, launches "
            f"{json.dumps({k: v for k, v in launches.items() if v})}")
        if dev != "cpu":
            torch.cuda.empty_cache()
    r["seconds"] = time.perf_counter() - t_phase
    log(f"[examples] phase 13 (b) took {r['seconds']:.1f} s")
    return r


# --------------------------------------------------------------------------
# Phase 14: the trainer (qwen2-1.5b at full width and depth: loss_fn, the
# rematerialised backward through B5's autograd rule, AdamW, SyntheticLM,
# the checkpoint writer, the Supervisor and launch/train.py)
# --------------------------------------------------------------------------

TRAIN = "qwen2-1.5b"
TRAIN_BATCH, TRAIN_SEQ = 8, 512  # SyntheticLM batches [8, 512]
TRAIN_STEPS = 8
# B5 launches a step: each of the 28 layers' forward, and again when the
# backward recomputes the layer (torch.utils.checkpoint)
TRAIN_B5_PER_STEP = 56
TRAIN_MODEL = {"layers": 2, "batch": (2, 64)}
# 2-layer full width, bf16 activations, card vs CPU: the loss within
# TRAIN_LOSS_REL of the CPU's, each leaf's gradient within TRAIN_GRAD_RMS
# of its RMS (RMS of the difference over RMS of the CPU's gradient; bf16
# rounds each product's output to 8 bits of mantissa, 0.4%, at other
# places on the two devices)
TRAIN_LOSS_REL = 1e-2
TRAIN_GRAD_RMS = 0.05
# the restart: full width cut to 2 layers, a save every 2 steps, a
# failure injected before step 3 (restored from step 2)
RESTART = ("--layers", "2", "--steps", "4", "--save-every", "2")
RESTART_FAIL_AT = 3
RESTART_LOSS_REL = 1e-3
# the profiled steps' optimizer: the CLI's (lr 3e-4 after a 100-step
# warmup; at lr 1e-3 from the first step the repeated batch's third loss
# overshot the first on an H100 80GB HBM3 at 700 W: 12.41, 9.85, 14.08)
TRAIN_PROFILE_OPT = {"total_steps": TRAIN_STEPS}


def _live_pairs(q, k, kw) -> int:
    """The (query, key) pairs a static-attention call computes."""
    import torch
    b, sq = q.shape[:2]
    q_pos = kw.get("q_offset", 0) + torch.arange(sq, device=q.device)
    dist = q_pos[:, None] - torch.arange(k.shape[1], device=q.device)[None]
    live = torch.ones_like(dist, dtype=torch.bool)
    if kw.get("causal", True):
        live &= dist >= 0
    if kw.get("sliding_window", 0):
        live &= dist < kw["sliding_window"]
    return b * int(live.sum())


def _flash_bounds(q, k, kw) -> tuple:
    """(forward bound, backward bound) of one static-attention call: the
    forward reads q, k, v and writes o (bf16) and does the two products
    of each live pair; the backward reads q, k, v, dO, writes dq, dk, dv
    and does five (S recomputed, dV, dP, dQ, dK)."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    pairs = _live_pairs(q, k, kw)
    fwd = bound_ms(2 * (2 * b * sq * h * d + 2 * b * sk * kvh * d),
                   4 * h * d * pairs)
    bwd = bound_ms(2 * (3 * b * sq * h * d + 4 * b * sk * kvh * d),
                   10 * h * d * pairs)
    return fwd, bwd


def _sdpa_train_ms(q, k, v, do) -> tuple:
    """SDPA (causal, ``enable_gqa``) forward and backward on the same
    inputs, the library yardstick; (None, None) where this torch refuses
    it."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (t.detach().transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    try:
        fwd = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                           enable_gqa=True)
        bwd = time_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), dot,
                                                  retain_graph=True))
    except (TypeError, RuntimeError) as e:
        log(f"[train] SDPA yardstick refused: {e}")
        return None, None
    return fwd, bwd


def check_flash_autograd(gen) -> dict:
    """Phase 14 (a): B5 under autograd (``ops.flash_attention`` on inputs
    that require grad goes through ``FlashAttentionFn``): at the trainer's
    shape [8, 512] (12 / 2 heads of 128, causal) and at a window, ALiBi,
    an offset and head dims 80 (not causal, ALiBi), 120 (window) and 256:
    one counted launch a forward, the output within TOL of the plain
    version and each row within FLASH_REL_TOL of its RMS, dq / dk / dv
    bitwise the plain version's autograd on the same inputs, two calls
    bitwise equal; the forward and the backward (the plain recompute)
    timed beside their bounds, and at the trainer's shape beside the plain
    version's and SDPA's."""
    import torch
    from repro_torch.core.alibi import alibi_slopes
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention
    cases = [(f"train [{TRAIN_BATCH},{TRAIN_SEQ}] causal",
              _qkv(gen, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ), {}),
             ("window 128", _qkv(gen, 2, 512, 512), {"sliding_window": 128}),
             ("ALiBi", _qkv(gen, 2, 512, 512),
              {"alibi_slopes": alibi_slopes(H, "cuda")}),
             ("q_offset 128, Sq 256 < Sk 384", _qkv(gen, 2, 256, 384),
              {"q_offset": 128}),
             ("D 80, 16 / 16 heads, not causal, ALiBi",
              _qkv(gen, 2, 256, 256, 16, 16, 80),
              {"causal": False, "alibi_slopes": alibi_slopes(16, "cuda")}),
             ("D 120, 32 / 8 heads, window 192",
              _qkv(gen, 1, 512, 512, 32, 8, 120), {"sliding_window": 192}),
             ("D 256, 10 / 1 heads, causal",
              _qkv(gen, 1, 512, 512, 10, 1, 256), {})]
    rows, worst = [], 0.0
    for label, (q, k, v), kw in cases:
        ins = [t.requires_grad_(True) for t in (q, k, v)]
        do = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
        n0 = flash_attention.launches
        out = ops.flash_attention(*ins, **kw)
        if flash_attention.launches != n0 + 1 \
                or type(out.grad_fn).__name__ != "FlashAttentionFnBackward":
            raise AssertionError(f"flash autograd {label}: not one launch "
                                 f"through FlashAttentionFn ({out.grad_fn})")
        want = ref.flash_attention_ref(*ins, **kw)
        err = (out.float() - want.float()).abs().max().item()
        rel = row_rel_err(out.detach(), want.detach())
        grads = torch.autograd.grad(out, ins, do)
        plain = torch.autograd.grad(want, ins, do)
        if not (err <= TOL and rel <= FLASH_REL_TOL) or not all(
                torch.equal(a, b) for a, b in zip(grads, plain)):
            raise AssertionError(
                f"flash autograd {label}: forward err {err} (tol {TOL}), "
                f"row-relative {rel} (tol {FLASH_REL_TOL}), grads equal to "
                "the plain autograd: "
                f"{[torch.equal(a, b) for a, b in zip(grads, plain)]}")
        out2 = ops.flash_attention(*ins, **kw)
        if not torch.equal(out2, out) or not all(
                torch.equal(a, b) for a, b in
                zip(torch.autograd.grad(out2, ins, do), grads)):
            raise AssertionError(f"flash autograd {label}: two calls differ")
        del out2, plain
        worst = max(worst, err)
        del out, want, grads
        fwd_b, bwd_b = _flash_bounds(q, k, kw)
        # the backward is timed on a graph kept for the repeats
        held = ops.flash_attention(*ins, **kw)
        row = {"case": label, "q": list(q.shape), "kv": list(k.shape),
               "max_abs_err": err, "max_row_rel_err": rel,
               "dq_dk_dv_equal_plain": True,
               "fwd_ms": time_ms(lambda: ops.flash_attention(*ins, **kw)),
               "bwd_ms": time_ms(lambda: torch.autograd.grad(
                   held, ins, do, retain_graph=True), iters=3),
               "fwd_bound": fwd_b, "bwd_bound": bwd_b}
        if not rows:                  # the trainer's shape: the yardsticks
            with torch.no_grad():
                row["plain_fwd_ms"] = time_ms(
                    lambda: ref.flash_attention_ref(q, k, v, **kw), iters=3)
            held = ref.flash_attention_ref(*ins, **kw)
            row["plain_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
                held, ins, do, retain_graph=True), iters=3)
            row["sdpa_fwd_ms"], row["sdpa_bwd_ms"] = _sdpa_train_ms(
                q, k, v, do)
        del held
        rows.append(row)
        log(f"[train] flash autograd {label}: q{row['q']} kv{row['kv']} "
            f"fwd_ms={row['fwd_ms']:.4f} (bound {fwd_b[0]:.5f} {fwd_b[1]}) "
            f"bwd_ms={row['bwd_ms']:.4f} (bound {bwd_b[0]:.5f} {bwd_b[1]}) "
            f"max_abs_err={err:.3e} max_row_rel_err={rel:.3e}; dq/dk/dv "
            "equal the plain autograd")
    main = rows[0]
    return {"name": "flash_attention", "label": "flash_attention[train]",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:386",
            "max_abs_err": worst, "ms": main["fwd_ms"],
            "plain_ms": main["plain_fwd_ms"], "bound": main["fwd_bound"],
            "library_ms": main["sdpa_fwd_ms"],
            "backward_ms": main["bwd_ms"],
            "backward_plain_ms": main["plain_bwd_ms"],
            "backward_bound_ms": main["bwd_bound"][0],
            "backward_bound_by": main["bwd_bound"][1],
            "backward_library_ms": main["sdpa_bwd_ms"],
            "shape": f"q[{TRAIN_BATCH},{TRAIN_SEQ},{H},{D}] k/v[{TRAIN_BATCH},"
                     f"{TRAIN_SEQ},{KV},{D}] causal under autograd (forward "
                     "the kernel, backward the plain version's); checked "
                     "also at " + "; ".join(c[0] for c in cases[1:]),
            "serves": ("train-full-depth",), "per_case": rows}


def _train_grads(cfg, params, batch, dev: str, control=None):
    """``T.loss_fn`` and every leaf's gradient of ``params`` (numpy-seeded
    CPU tensors, copied to ``dev`` in the trainer's per-layer layout);
    with ``control`` (module, attribute) that function's outputs are
    detached (``_Detached``: what lies behind it gets no gradient)."""
    import contextlib
    import torch
    from repro_torch.bridge import tree_to
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import tree_leaves
    p = T.unstack_layers(tree_to(params, dev))
    leaves = tree_leaves(p)
    for t in leaves:
        t.requires_grad_(True)
    with (_Detached(*control) if control else contextlib.nullcontext()):
        loss = T.loss_fn(cfg, p, {k: torch.from_numpy(v).to(dev)
                                  for k, v in batch.items()})
        g = torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(loss.detach()), [torch.zeros_like(t) if d is None
                                  else d.detach()
                                  for t, d in zip(leaves, g)]


def _rms_rel(got, want) -> float:
    """RMS of the difference over the RMS of ``want``, in f32 on ``got``'s
    device (the MoE's 1.7 B gradients in float64 on the host took
    seconds)."""
    w = want.to(got.device).float()
    return ((got.float() - w).pow(2).mean().sqrt()
            / w.pow(2).mean().sqrt().clamp(min=1e-30)).item()


class _Detached:
    """Within the block, ``module.attr``'s outputs are detached (a
    control: what lies behind it gets no gradient)."""

    def __init__(self, module, attr):
        self.module, self.attr = module, attr

    def __enter__(self):
        import torch
        self.real = real = getattr(self.module, self.attr)

        def detached(*a, **kw):
            out = real(*a, **kw)
            return (out.detach() if isinstance(out, torch.Tensor)
                    else type(out)(t.detach() for t in out))

        setattr(self.module, self.attr, detached)

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.real)


def phase_train_model(dev: str = "cuda", ref_dev: str = "cpu",
                      layers: int = TRAIN_MODEL["layers"],
                      shape=TRAIN_MODEL["batch"], reduced: bool = False
                      ) -> dict:
    """Phase 14 (b): full-width qwen2-1.5b cut to ``layers`` layers, bf16
    activations over f32 weights drawn from seed 0, one numpy-seeded batch
    of ``shape``: the loss and every leaf's gradient on the card against
    the CPU (the plain versions), within TRAIN_LOSS_REL and TRAIN_GRAD_RMS;
    the card's run launches B5 twice a layer (forward, recompute); the
    control (attention's output detached on the card) must miss the
    gradient limit (its loss is the same: the forward is unchanged)."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config, get_reduced
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import transformer as T
    cfg = (get_reduced(TRAIN) if reduced else get_config(TRAIN)).replace(
        num_layers=layers)
    params = T.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(5)
    b, s = shape
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s + 1))
             .astype(np.int32)}
    names = _leaf_paths(T.unstack_layers(params))
    t0 = time.perf_counter()
    want_loss, want = _train_grads(cfg, params, batch, ref_dev)
    cpu_s = time.perf_counter() - t0
    out = {"layers": layers, "batch": [b, s], "cpu_s": cpu_s,
           "cpu_loss": want_loss}
    for label, control in (("card", None),
                           ("control", (ops, "flash_attention"))):
        n0 = flash_attention.launches
        loss, got = _train_grads(cfg, params, batch, dev, control)
        rel = [_rms_rel(g, w) for g, w in zip(got, want)]
        worst = int(np.argmax(rel))
        out[label] = r = {"loss": loss,
                          "loss_rel_err": abs(loss - want_loss) / want_loss,
                          "grad_rms_rel_worst": rel[worst],
                          "grad_rms_rel_median": float(np.median(rel)),
                          "worst_leaf": names[worst],
                          "b5_launches": flash_attention.launches - n0}
        del got
        ok = (r["loss_rel_err"] <= TRAIN_LOSS_REL
              and r["grad_rms_rel_worst"] <= TRAIN_GRAD_RMS)
        if dev != "cpu" and label == "card" and \
                r["b5_launches"] != 2 * layers:
            raise AssertionError(f"train model: {r['b5_launches']} B5 "
                                 f"launches, want {2 * layers}")
        if ok != (label == "card"):
            raise AssertionError(
                f"train model {label}: loss rel err {r['loss_rel_err']:.3e} "
                f"(limit {TRAIN_LOSS_REL}), worst leaf gradient "
                f"{r['grad_rms_rel_worst']:.3e} of its RMS (limit "
                f"{TRAIN_GRAD_RMS})" + (": the control passed" if ok
                                        else ""))
        if dev != "cpu":
            torch.cuda.empty_cache()
    return out


def _leaf_paths(tree, prefix: str = "") -> list:
    """Dotted paths of a tree's leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in _leaf_paths(v, f"{prefix}.{k}" if prefix else k)]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in _leaf_paths(v, f"{prefix}.{i}")]
    return [prefix]


class _LogRecords:
    """The records of the named loggers at DEBUG while in use."""

    def __init__(self, *names):
        import logging
        self.names, self.records = names, []
        self.handler = logging.Handler(logging.DEBUG)
        self.handler.emit = self.records.append

    def __enter__(self):
        import logging
        self.levels = []
        for n in self.names:
            lg = logging.getLogger(n)
            self.levels.append(lg.level)
            lg.setLevel(logging.DEBUG)
            lg.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        import logging
        for n, level in zip(self.names, self.levels):
            lg = logging.getLogger(n)
            lg.removeHandler(self.handler)
            lg.setLevel(level)

    def args(self, prefix: str) -> list:
        return [r.args for r in self.records if r.msg.startswith(prefix)]


def _dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def run_train(argv, kernels, dev: str = "cuda") -> dict:
    """``repro_torch.launch.train.main(argv)`` in process with the kernels'
    counters zeroed before it and read after, the peak device memory,
    each step's seconds and each save's bytes and seconds from its DEBUG
    records."""
    import torch
    from repro_torch.launch import train
    for k in kernels:
        k.launches = 0
    if dev != "cpu":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _LogRecords("repro_torch.train", "repro_torch.checkpoint") as rec:
        losses = train.main([*argv, "--device", dev])
    wall = time.perf_counter() - t0
    return {"losses": losses, "wall_s": wall,
            "launches": {k.name: k.launches for k in kernels},
            "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                        if dev != "cpu" else None),
            "step_s": [a[2] for a in rec.args("step %d loss")],
            "saves": [{"step": a[0], "bytes": a[1], "seconds": a[2]}
                      for a in rec.args("saved step")]}


def train_depth(kernels, dev: str = "cuda", reduced: bool = False) -> dict:
    """Phase 14 (c): full-depth qwen2-1.5b through ``launch.train.main``,
    TRAIN_STEPS steps of [8, 512] and one save at the end: finite losses,
    exactly TRAIN_B5_PER_STEP B5 launches a step and no other kernel of
    the port; step seconds (the first apart: it builds cuBLAS' plans),
    tokens/s, peak memory, the save's bytes and seconds and the bytes on
    disk.  The checkpoint directory is removed after."""
    import math
    import shutil
    directory = ROOT / "build" / "train_smoke"
    shutil.rmtree(directory, ignore_errors=True)
    try:
        run = run_train(["--arch", TRAIN, "--batch", str(TRAIN_BATCH),
                         "--seq", str(TRAIN_SEQ), "--steps", str(TRAIN_STEPS),
                         "--save-every", str(TRAIN_STEPS), "--ckpt-dir",
                         str(directory)] + (["--reduced"] if reduced else []),
                        kernels, dev)
        run["disk_bytes"] = _dir_bytes(directory)
        free = shutil.disk_usage(directory).free
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    want = TRAIN_B5_PER_STEP * TRAIN_STEPS
    got = run["launches"]
    other = {k: n for k, n in got.items() if k != "flash_attention" and n}
    if len(run["losses"]) != TRAIN_STEPS or not all(
            math.isfinite(x) for x in run["losses"]):
        raise AssertionError(f"train depth: losses {run['losses']}")
    if dev != "cpu" and (got["flash_attention"] != want or other):
        raise AssertionError(f"train depth: launches {got}, want "
                             f"flash_attention {want} and no other")
    if len(run["saves"]) != 1:
        raise AssertionError(f"train depth: saves {run['saves']}")
    steady = run["step_s"][1:]
    run.update(first_step_s=run["step_s"][0],
               step_ms=1e3 * sum(steady) / len(steady),
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ * len(steady)
               / sum(steady), disk_free_after_bytes=free)
    return run


def train_profile(kernels, dev: str = "cuda", reduced: bool = False) -> dict:
    """Phase 14 (c), the profile: full-depth qwen2-1.5b built through the
    port's API (``T.init_params``, ``T.unstack_layers``,
    ``make_train_step``, a ``SyntheticLM`` batch), every leaf of params and
    moments on the card; one warm-up step, then two steps on the same
    batch under ``torch.profiler``: device busy time and idle share, the
    device time of B5, the dense products and the rest, launches; the
    loss must descend over the three steps.  Then AdamW's update alone,
    timed beside its bound (7 f32 words a parameter moved)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config, get_reduced
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw as A
    from repro_torch.runtime.train_loop import make_train_step
    cfg = get_reduced(TRAIN) if reduced else get_config(TRAIN)
    opt = A.AdamWConfig(**TRAIN_PROFILE_OPT)
    if dev != "cpu":
        torch.cuda.reset_peak_memory_stats()
    params = T.unstack_layers(T.init_params(cfg, 0, device=dev))
    state = A.init_opt_state(params, opt)
    leaves = A.tree_leaves(params) + A.tree_leaves(state)
    if any(t.device.type != torch.device(dev).type for t in leaves):
        raise AssertionError("train profile: a leaf is not on the device")
    n_params = sum(t.numel() for t in A.tree_leaves(params))
    step = make_train_step(cfg, opt)
    batch = SyntheticLM(cfg, ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH,
                                         "train")).next_batch(dev)
    params, state, m = step(params, state, batch)
    losses = [float(m["loss"])]
    for k in kernels:
        k.launches = 0
    if dev == "cpu":
        for _ in range(2):
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
        return {"losses": losses}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train profile: the repeated batch's loss "
                             f"did not descend: {losses}")
    if launches["flash_attention"] != 2 * TRAIN_B5_PER_STEP:
        raise AssertionError(f"train profile: launches {launches}")
    split = dict.fromkeys(("flash_attention", "gemm", "other"), 0.0)
    ops, by = 0, {}
    for name, on_device, ms in _events(prof):
        if not on_device:
            continue
        ops += 1
        key = ("flash_attention" if ours_name(name) == "flash_attention"
               else "gemm" if any(f in name.lower() for f in
                                  ("gemm", "cutlass", "xmma", "nvjet"))
               else "other")
        split[key] += ms
        t, n = by.get(name[:60], (0.0, 0))
        by[name[:60]] = (t + ms, n + 1)
    busy = sum(split.values())
    grads = state.mu                # any tree of the params' shapes
    adamw_ms = time_ms(lambda: A.apply_updates(params, grads, state, opt),
                       iters=3)
    return {"losses": losses, "wall_ms": wall * 1e3, "step_ms": wall * 5e2,
            "device_busy_ms": busy, "device_idle_share": 1 - busy
            / (wall * 1e3), "device_ms": split, "device_ops_per_step":
            ops / 2, "launches": launches, "params": n_params,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "adamw_ms": adamw_ms,
            "adamw_bound": bound_ms(7 * 4 * n_params, 0),
            "step_bound": bound_ms(0, _train_flops(cfg)),
            "top": [{"kernel": k, "ms": t, "calls": n} for k, (t, n) in
                    sorted(by.items(), key=lambda kv: -kv[1][0])[:10]]}


def _train_flops(cfg) -> float:
    """One train step's dense flops: 6 x parameters x tokens for the
    forward and backward, plus the recomputed forward of every layer
    (2 x its parameters x tokens), plus attention's products (forward,
    recompute and backward: 4 + 4 + 10 flops per head dim per live pair,
    causal)."""
    tokens = TRAIN_BATCH * TRAIN_SEQ
    d, f, L = cfg.d_model, cfg.d_ff, cfg.num_layers
    hd = cfg.resolved_head_dim
    layer = (d * cfg.num_heads * hd * 2 + 2 * d * cfg.num_kv_heads * hd
             + 3 * d * f)
    n = cfg.vocab_size * d + L * layer
    pairs = TRAIN_BATCH * TRAIN_SEQ * (TRAIN_SEQ + 1) // 2
    attn = L * 18 * cfg.num_heads * hd * pairs
    return 6 * n * tokens + 2 * L * layer * tokens + attn


def train_restart(kernels, dev: str = "cuda", reduced: bool = False) -> dict:
    """Phase 14 (d): full width cut to 2 layers through
    ``launch.train.main``: an uninterrupted run of 4 steps saving every 2,
    and the same run with a failure injected before step 3, which the
    Supervisor restores from step 2 (steps 2 and 3 run again): its losses
    must be the uninterrupted run's, step for step, within
    RESTART_LOSS_REL (and whether they are bitwise is recorded).  The
    directories are removed after."""
    import shutil
    base = ROOT / "build" / "train_restart"
    shutil.rmtree(base, ignore_errors=True)
    argv = ["--arch", TRAIN, "--batch", str(TRAIN_BATCH), "--seq",
            str(TRAIN_SEQ), *RESTART] + (["--reduced"] if reduced else [])
    try:
        plain = run_train([*argv, "--ckpt-dir", str(base / "plain")],
                          kernels, dev)
        failed = run_train([*argv, "--ckpt-dir", str(base / "failed"),
                            "--fail-at-step", str(RESTART_FAIL_AT)],
                           kernels, dev)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    f = RESTART_FAIL_AT
    want = plain["losses"][:f] + plain["losses"][f - 1:]
    got = failed["losses"]
    if len(got) != len(want) or any(
            abs(a - b) > RESTART_LOSS_REL * abs(b) for a, b in zip(got, want)):
        raise AssertionError(f"train restart: losses {got}, the "
                             f"uninterrupted run's {plain['losses']}")
    return {"plain": plain["losses"], "failed": got,
            "bitwise": got == want,
            "max_rel": max(abs(a - b) / abs(b) for a, b in zip(got, want)),
            "saves": len(plain["saves"]) + len(failed["saves"]),
            "save_s": [s["seconds"] for s in plain["saves"]],
            "save_bytes": [s["bytes"] for s in plain["saves"]],
            "wall_s": [plain["wall_s"], failed["wall_s"]]}


def check_no_hidden_grad(kernels) -> dict:
    """Phase 14 (e): every serving-only kernel entry (B1, B4, B2 with both
    pool formats, B3) raises ``RuntimeError`` naming its kernel when
    autograd would record its call, before it launches.  (The time scans
    have autograd rules since phase 14 (f).)"""
    import torch
    from repro_torch.kernels import ops
    c = dict(device="cuda")
    grad = lambda *shape: torch.zeros(shape, requires_grad=True, **c)
    z = lambda *shape, dt=torch.bfloat16: torch.zeros(shape, dtype=dt, **c)
    i32 = lambda *shape: torch.zeros(shape, dtype=torch.int32, **c)
    i8 = lambda *shape: torch.zeros(shape, dtype=torch.int8, **c)
    f32 = lambda *shape: z(*shape, dt=torch.float32)
    q1 = grad(1, 16, H, D)
    entries = {
        "paged_attention": lambda: ops.paged_attention(
            grad(2, H, D), z(4, BS, KV, D), z(4, BS, KV, D), i32(2, 2),
            i32(2)),
        "paged_attention_quant": lambda: ops.paged_attention_quant(
            grad(2, H, D), i8(4, BS, KV, D), f32(4, KV), i8(4, BS, KV, D),
            f32(4, KV), i32(2, 2), i32(2)),
        "flash_attention_chunk": lambda: ops.chunk_prefill_attention(
            q1, z(1, 4, BS, KV, D), z(1, 4, BS, KV, D), None, None, 0,
            i32(1, 2), i32(), i32(), z(1, 16, KV, D), z(1, 16, KV, D)),
        "flash_attention_chunk (int8)": lambda: ops.chunk_prefill_attention(
            q1, i8(1, 4, BS, KV, D), i8(1, 4, BS, KV, D), f32(1, 4, KV),
            f32(1, 4, KV), 0, i32(1, 2), i32(), i32(), z(1, 16, KV, D),
            z(1, 16, KV, D)),
        "gptq_matmul": lambda: ops.quant_matmul(
            grad(8, 256), {"qweight": i32(32, 256), "scales": f32(8, 256),
                           "zeros": f32(8, 256)})}
    for k in kernels:
        k.launches = 0
    out = {}
    for label, call in entries.items():
        try:
            call()
        except RuntimeError as e:
            if label.split(" ")[0] not in str(e):
                raise
            out[label] = str(e).split(";")[0]
            continue
        raise AssertionError(f"{label}: called with grad enabled on an "
                             "input that requires grad, it did not raise")
    launched = {k.name: k.launches for k in kernels if k.launches}
    if launched:
        raise AssertionError(f"no-hidden-grad guard: launched {launched}")
    return out


# --------------------------------------------------------------------------
# Phase 14 (f): the trainer for the MoE, hybrid and Mamba families
# (qwen2-moe-a2.7b, recurrentgemma-2b, falcon-mamba-7b at full width): the
# time scans' backward kernels against their plain versions, each family's
# loss and gradients card vs CPU, and deep runs through launch.train.main
# --------------------------------------------------------------------------

# the backward kernels' checks at the trainer's shapes [8, 512]: the
# RG-LRU's width 2560 and falcon-mamba's din 8192 with a state of 16, from
# a random state with a random h_last gradient; the selective scan also at
# a ragged S that is not a multiple of the forward's 16-step tiles (the
# backward's checkpoints)
SCAN_BWD_LINEAR = (TRAIN_BATCH, TRAIN_SEQ, 2560)
SCAN_BWD_SELECTIVE = (TRAIN_BATCH, TRAIN_SEQ, 8192, 16)
SCAN_BWD_RAGGED_S = 333
# each output's largest error over its own RMS (the plain version in f32
# sums in another order and takes torch's exp): 1e-3 in the first chip
# run, tightened to 1e-4 on its reading (NVIDIA H100 80GB HBM3, 700 W:
# the selective scan's worst output, gA, 1.37e-5 at [8, 512], 7.97e-6 at
# S 333; the linear scan bitwise its plain version)
SCAN_BWD_REL_TOL = 1e-4
# the fused mixer core's backward (``SsmScanFn``: the softplus', D skip's
# and gate's derivatives in the kernel, in f32 registers) in bf16 against
# its plain version ``ssm_scan_bwd_ref`` (the same f32 chain, its outputs
# rounded to bf16 once): each output's largest error over its own RMS.
# On the H100 (700 W) the kernel read 0.051 (served init) and 0.035
# (memory-carrying init), both at g_dt_lin, whose largest value is ~47x /
# ~100x its RMS; the shifted-cotangent control reads >= 1.  The limit sits
# 3x above the sound readings and well below the control.  The plain
# autograd of the composition in bf16 (every intermediate gradient
# rounded to bf16, the trainer's path before ``SsmScanFn``) is recorded
# beside it as a second witness, ungated (PERF.md)
FUSED_BWD_BF16_TOL = 0.15
# its cases: (label, activations, S, falcon-mamba's own init or
# MAMBA_MEMORY's, from a random state), each held to ``ssm_scan_bwd_ref``
# over each output's RMS: f32 at SCAN_BWD_REL_TOL, bf16 at
# FUSED_BWD_BF16_TOL; the first is the kernels line's
SCAN_BWD_FUSED_CASES = (
    ("bf16, served init, random state", "bfloat16", TRAIN_SEQ, "served",
     True),
    ("f32, served init, random state", "float32", TRAIN_SEQ, "served", True),
    ("f32, memory-carrying init", "float32", SCAN_BWD_RAGGED_S, "memory",
     False),
    ("bf16, memory-carrying init", "bfloat16", SCAN_BWD_RAGGED_S, "memory",
     False))
# each family card vs CPU at full width (TRAIN_LOSS_REL, TRAIN_GRAD_RMS):
# (layers, activations); 3 recurrentgemma layers run both RG-LRU blocks
# and the sliding-window one; the MoE in f32, as phase 6 (bf16 rounding
# turns routing ties into other experts, and one token's k assignments
# moved are ~6% of a 128-token batch's expert gradient)
TRAIN_FAMILY_MODEL = {MOE: (2, "float32"), RGEMMA: (3, "bfloat16"),
                      MAMBA: (2, "bfloat16")}
# the deep runs: layers, chosen so that f32 master weights, gradients and
# two AdamW moments (16 bytes a parameter) and a step's activations stay
# under ~75 GB of the card's 80 (peaks in PERF.md)
TRAIN_FAMILY_DEPTH = {MOE: 4, RGEMMA: 26, MAMBA: 32}
TRAIN_FAMILY_STEPS = 4           # the first builds plans; the last profiled


def _scan_bwd_case(name, label, kernel, plain, control, nbytes, exps, rows,
                   tol=SCAN_BWD_REL_TOL, exps_two=None, of="rms"):
    """One backward case: ``kernel()`` against ``plain()`` (each a tuple of
    outputs), each output's largest error within ``tol`` of its RMS (``of``
    "max": of its largest |value|; both recorded), two calls bitwise
    equal; ``control()`` (the plain version on a cotangent shifted by one
    step) must miss the limit; timed beside the plain version and the
    bound: bytes, or one exponential a state element on the MUFU
    (``exps``; ``exps_two``: the count of a design that takes two
    exponentials a state element, beside it)."""
    import torch

    def scale(w):
        w = w.double()
        return (w.abs().max() if of == "max" else w.pow(2).mean().sqrt()
                ).item()

    got = kernel()
    again = kernel()
    want = plain()
    torch.cuda.synchronize()
    rel, rel_rms, worst = {}, {}, 0.0
    for i, (g, a, w) in enumerate(zip(got, again, want)):
        if not torch.equal(g, a):
            raise AssertionError(f"{name} {label}: two calls differ (output "
                                 f"{i})")
        err = (g.double() - w.double()).abs().max().item()
        worst = max(worst, err)
        sc, rms = scale(w), w.double().pow(2).mean().sqrt().item()
        rel[i] = err / sc if sc else float("inf")
        rel_rms[i] = err / rms if rms else float("inf")
        if not (bool(torch.isfinite(g).all()) and rel[i] <= tol):
            raise AssertionError(f"{name} {label}: output {i} max err "
                                 f"{rel[i]:.3e} of its {of} (limit {tol})")
    ctrl = control()
    ctrl_rel = max((c.double() - w.double()).abs().max().item() / scale(w)
                   for c, w in zip(ctrl, want) if w.abs().max().item() > 0)
    if ctrl_rel <= tol:
        raise AssertionError(f"{name} {label}: the control (cotangent "
                             f"shifted a step) is within the limit: "
                             f"{ctrl_rel:.3e}")
    del got, again, want, ctrl
    clock = 16 * 132 * sm_clock_hz()
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_e = exps / clock * 1e3
    row = {"case": label, "max_abs_err": worst, "rel_err": rel,
           "max_rel_err": max(rel.values()), "limit": tol, "of": of,
           "rel_err_of_rms": rel_rms,
           "control_rel_err": ctrl_rel, "bitwise_repeat": True,
           "ms": time_ms(kernel, iters=5),
           "plain_ms": time_ms(plain, iters=1),
           "bound": (t_b, "bytes") if t_b >= t_e else (t_e, "operations"),
           "bound_bytes_ms": t_b, "bound_mufu_ms": t_e}
    if exps_two is not None:
        row["bound_mufu_two_exp_ms"] = exps_two / clock * 1e3
    log(f"[train] {name} {label}: kernel_ms={row['ms']:.4f} plain_ms="
        f"{row['plain_ms']:.2f} bound_ms={row['bound'][0]:.5f} "
        f"({row['bound'][1]}; bytes {t_b:.5f}, MUFU {t_e:.5f}"
        + (f", two exponentials {row['bound_mufu_two_exp_ms']:.5f}"
           if exps_two is not None else "")
        + f") max err over {of} {row['max_rel_err']:.2e} by output "
        f"{json.dumps(rel)} (over RMS {json.dumps(rel_rms)}); control "
        f"{ctrl_rel:.2e} (limit {tol})")
    rows.append(row)
    return row


def _recompute_bitwise(name, label, backward, ck, h_last) -> None:
    """The backward's recomputed state at the end of every tile (its
    ``h_end``) equals the forward's bit for bit: the next tile's
    checkpoint, and h_last at the last."""
    import torch
    h_end = torch.empty_like(ck)
    backward(h_end)
    torch.cuda.synchronize()
    if not (torch.equal(h_end[:, :-1], ck[:, 1:])
            and torch.equal(h_end[:, -1], h_last)):
        bad = int((h_end[:, :-1] != ck[:, 1:]).sum()) + int(
            (h_end[:, -1] != h_last).sum())
        raise AssertionError(f"{name} {label}: the recomputed h_t differs "
                             f"from the forward's in {bad} values")
    log(f"[train] {name} {label}: the recomputed h_t at every tile's end "
        f"equals the forward's bitwise ({ck.shape[1]} tiles)")


class _NoPlainCore:
    """While in use, ``ref.ssm_scan_ref`` (the Mamba core's plain torch
    composition) raises on a CUDA tensor: under autograd on the card the
    core must run through ``SsmScanFn``'s kernels alone."""

    def __enter__(self):
        from repro_torch.kernels import ref
        self.real = real = ref.ssm_scan_ref

        def guarded(*a, **kw):
            if a[2].is_cuda:
                raise AssertionError("ssm_scan_ref ran on the card: the "
                                     "Mamba core fell back to the plain "
                                     "composition")
            return real(*a, **kw)

        ref.ssm_scan_ref = guarded
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ref
        ref.ssm_scan_ref = self.real


def composed_ssm_scan(dt_lin, dt_bias, xc, B, C, z, A_log, D, h0):
    """The Mamba-1 mixer core under autograd as the trainer ran it before
    ``SsmScanFn``: the plain version's torch composition around
    ``SelectiveScanFn`` (the scan alone's forward and backward kernels)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.time_scan import SelectiveScanFn
    return ref.ssm_scan_ref(dt_lin, dt_bias, xc, B, C, z, A_log, D, h0,
                            scan=SelectiveScanFn.apply)


def _plain_core_grads(args, g_out, g_hlast):
    """Autograd of ``ref.ssm_scan_ref`` (the plain composition and scan)
    for every input of the core, on ``args``' device."""
    import torch
    from repro_torch.kernels import ref
    ins = [a.detach().requires_grad_(True) for a in args]
    with torch.enable_grad():
        y, h = ref.ssm_scan_ref(*ins)
        return torch.autograd.grad((y, h), ins, (g_out, g_hlast))


def check_scan_backward(gen) -> list:
    """Phase 14 (f) (1): ``linear_scan_bwd`` at recurrentgemma's [8, 512] x
    2560, the scan alone's ``selective_scan_bwd`` at falcon-mamba's [8,
    512] x 8192 x 16 and at a ragged S (from the forward's checkpoints),
    from random states with random gradients of every output, against
    ``ref.linear_scan_bwd_ref`` / ``selective_scan_bwd_ref``; then the
    fused core's backward in SCAN_BWD_FUSED_CASES on inputs made by the
    model's own projections (``mamba_core_inputs``) against
    ``ref.ssm_scan_bwd_ref`` (the plain autograd recorded beside the bf16
    cases); in every
    selective case the recomputed h_t bitwise the forward's
    (``_recompute_bitwise``).  See ``_scan_bwd_case``.  Returns the three
    kernel records."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.time_scan import linear_scan, selective_scan
    from repro_torch.models import ssm
    dev = "cuda"
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    out = []
    b, S, w = SCAN_BWD_LINEAR
    a = torch.rand((b, S, w), generator=gen, device=dev) * 0.5 + 0.5
    g, h0 = rnd(b, S, w), rnd(b, w)
    hs, _ = linear_scan(a, g, h0)
    ghs, ghl = rnd(b, S, w), rnd(b, w)
    from repro_torch.kernels import build
    log_ = build.LOGS.get("time_scan", "")
    ptxas = {fn: ptxas_usage(log_, key) for fn, key in (
        ("linear_scan_bwd_kernel", "linear_scan_bwd_kernel"),
        ("selective_scan_bwd_kernel<f32>", "selective_scan_bwd_kernelIfLb0"),
        ("selective_scan_bwd_kernel<f32, fused>",
         "selective_scan_bwd_kernelIfLb1"),
        ("selective_scan_bwd_kernel<bf16, fused>",
         "selective_scan_bwd_kernelI13__nv_bfloat16Lb1"))}
    log(f"[build] ptxas, the backward scans: {json.dumps(ptxas)}")
    rows = []
    _scan_bwd_case("linear_scan_bwd", f"rgemma train [{b},{S}] w {w}",
                   lambda: linear_scan.backward(a, hs, h0, ghs, ghl),
                   lambda: ref.linear_scan_bwd_ref(a, hs, h0, ghs, ghl),
                   lambda: ref.linear_scan_bwd_ref(
                       a, hs, h0, torch.roll(ghs, 1, 1), ghl),
                   4 * (5 * b * S * w + 3 * b * w), 0, rows)
    r = rows[0]
    out.append({"name": "linear_scan_bwd", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/time_scan.cu",
                "replaces": "src/repro/models/ssm.py:215 (XLA's derivative "
                            "of the lax.scan step of _rglru_scan; not a "
                            "Pallas site)",
                "max_abs_err": r["max_abs_err"],
                "max_rel_err": r["max_rel_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound": r["bound"],
                "library_ms": None, "serves": tuple(
                    f"train-{m}" for m in TRAIN_FAMILY_DEPTH),
                "shape": r["case"] + " (max_rel_err: the largest error over "
                "its output's RMS); no single torch call computes it",
                "cases": rows})
    del a, g, h0, hs, ghs, ghl
    b, S, din, N = SCAN_BWD_SELECTIVE
    A = -torch.arange(1, N + 1, dtype=torch.float32, device=dev).repeat(din, 1)
    rows = []
    for s in (S, SCAN_BWD_RAGGED_S):
        dt = torch.rand((b, s, din), generator=gen, device=dev) * 0.099 + 0.001
        u, Bm, Cm = rnd(b, s, din), rnd(b, s, N), rnd(b, s, N)
        h0, gy, ghl = rnd(b, din, N), rnd(b, s, din), rnd(b, din, N)
        _, h_last, ck = selective_scan(dt, u, Bm, Cm, A, h0, checkpoints=True)
        label = f"mamba train [{b},{s}] din {din} N {N} from a random state"
        elems = b * s * din * N
        _scan_bwd_case(
            "selective_scan_bwd", label,
            lambda: selective_scan.backward(dt, u, Bm, Cm, A, ck, gy, ghl),
            lambda: ref.selective_scan_bwd_ref(dt, u, Bm, Cm, A, h0, gy, ghl),
            lambda: ref.selective_scan_bwd_ref(dt, u, Bm, Cm, A, h0,
                                               torch.roll(gy, 1, 1), ghl),
            4 * (5 * b * s * din + 4 * b * s * N + 2 * din * N
                 + 3 * b * din * N), elems, rows, exps_two=2 * elems)
        _recompute_bitwise("selective_scan_bwd", label, lambda he:
                           selective_scan.backward(dt, u, Bm, Cm, A, ck, gy,
                                                   ghl, h_end=he),
                           ck, h_last)
        del dt, u, Bm, Cm, h0, gy, ghl, ck, h_last
        torch.cuda.empty_cache()
    r = rows[0]
    out.append({"name": "selective_scan_bwd", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/time_scan.cu",
                "replaces": "src/repro/models/ssm.py:99 (XLA's derivative "
                            "of the lax.scan step of _ssm_inner; not a "
                            "Pallas site)",
                "max_abs_err": max(x["max_abs_err"] for x in rows),
                "max_rel_err": max(x["max_rel_err"] for x in rows),
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound": r["bound"],
                "library_ms": None, "serves": tuple(
                    f"train-{m}" for m in TRAIN_FAMILY_DEPTH),
                "shape": r["case"] + " (max_rel_err: the largest error over "
                "its output's RMS; also at S " + str(SCAN_BWD_RAGGED_S)
                + "; bound: the bytes, or one exponential a state element "
                "on the MUFU); no single torch call computes it; the "
                "trainer runs the fused entry, counted on its own",
                "ptxas": ptxas, "cases": rows})

    # the fused core's backward
    cfg = get_config(MAMBA)
    rows = []
    for label, act, s, init, random_state in SCAN_BWD_FUSED_CASES:
        p = ssm.ssm_init(gen, cfg, device=dev)
        if init == "memory":
            p["dt_bias"].fill_(MAMBA_MEMORY["dt_bias"])
            p["A_log"].fill_(math.log(-MAMBA_MEMORY["A"]))
        args = mamba_core_inputs(cfg, p, gen, b, s, None, act,
                                 random_state)[:9]
        del p
        dt_lin, dt_bias, xc, Bm, Cm, z, A_log, D, h0 = args
        g_out = rnd(b, s, din).to(xc.dtype)
        ghl = rnd(b, din, N)
        _, h_last, ck = selective_scan.fused(*args, checkpoints=True)
        core = (dt_lin, dt_bias, xc, Bm, Cm, z, A_log, D)
        label = f"mamba core [{b},{s}] din {din} N {N}, {label}"
        kernel = lambda: selective_scan.fused_backward(*core, ck, g_out, ghl)
        elems = b * s * din * N
        esize = xc.element_size()
        row = _scan_bwd_case(
            "selective_scan_bwd[fused]", label, kernel,
            lambda: ref.ssm_scan_bwd_ref(*args, g_out, ghl),
            lambda: ref.ssm_scan_bwd_ref(*args, torch.roll(g_out, 1, 1),
                                         ghl),
            esize * (7 * b * s * din + 4 * b * s * N)
            + 4 * (2 * din * N + 4 * din + 3 * b * din * N), elems, rows,
            tol=SCAN_BWD_REL_TOL if act == "float32" else FUSED_BWD_BF16_TOL)
        if not rows[:-1]:
            # the trainer's core under autograd, forward and backward: the
            # fused rule against the composition it replaced
            ins = [t.detach().requires_grad_(True) for t in args]

            def fwd_bwd(fn):
                y, _ = fn(*ins)
                torch.autograd.grad(y, ins, g_out)

            row["core_fwd_bwd_ms"] = time_ms(
                lambda: fwd_bwd(ops.ssm_scan), iters=3)
            row["composed_fwd_bwd_ms"] = time_ms(
                lambda: fwd_bwd(composed_ssm_scan), iters=3)
            log(f"[train] mamba core {label}: forward + backward under "
                f"autograd {row['core_fwd_bwd_ms']:.4f} ms (SsmScanFn), "
                f"{row['composed_fwd_bwd_ms']:.4f} ms (the composition "
                f"around SelectiveScanFn, the path before SsmScanFn)")
            del ins
        if act == "bfloat16":
            # the second witness (recorded, not gated): the plain autograd
            # of the composition in bf16, each output's largest error over
            # its RMS and over its largest |value|
            got = kernel()
            want = _plain_core_grads(args, g_out, ghl)
            witness = row["autograd_witness"] = {"of_rms": {}, "of_max": {}}
            for i, (x, y) in enumerate(zip(got, want)):
                err = (x.double() - y.double()).abs().max().item()
                y = y.double()
                witness["of_rms"][i] = err / y.pow(2).mean().sqrt().item()
                witness["of_max"][i] = err / y.abs().max().item()
            log(f"[train] selective_scan_bwd[fused] {label}: against the "
                f"plain autograd in bf16 (recorded) {json.dumps(witness)}")
            del got, want
        _recompute_bitwise("selective_scan_bwd[fused]", label, lambda he:
                           selective_scan.fused_backward(*core, ck, g_out,
                                                         ghl, h_end=he),
                           ck, h_last)
        del args, core, dt_lin, dt_bias, xc, Bm, Cm, z, A_log, D, h0, g_out
        del ghl, ck, h_last
        torch.cuda.empty_cache()
    r = rows[0]
    out.append({"name": "selective_scan_bwd[fused]", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/time_scan.cu",
                "replaces": "src/repro/models/ssm.py:71 (XLA's derivative "
                            "of _ssm_inner after its projections: the "
                            "lax.scan step at :99 and its softplus, D skip "
                            "and gate; not a Pallas site)",
                "max_abs_err": max(x["max_abs_err"] for x in rows),
                "max_rel_err": max(x["max_rel_err"] for x in rows),
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound": r["bound"],
                "library_ms": None, "serves": (f"train-{MAMBA}",),
                "shape": r["case"] + " (max_rel_err: the largest error over "
                "its output's RMS against ssm_scan_bwd_ref, bf16 at "
                "FUSED_BWD_BF16_TOL, f32 at SCAN_BWD_REL_TOL; also f32 and "
                "the memory-carrying init at S " + str(SCAN_BWD_RAGGED_S)
                + "); no single torch call computes it", "cases": rows})
    return out


class _Routes:
    """Records each ``moe._route`` call's expert ids while in use."""

    def __enter__(self):
        from repro_torch.models import moe
        self.real, self.ids = moe._route, []

        def route(*a, **kw):
            ids, w = self.real(*a, **kw)
            self.ids.append(ids.detach().cpu())
            return ids, w

        moe._route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._route = self.real


def family_control(config: str):
    """The control of a family's card-vs-CPU gradients: the routed
    experts', the RG-LRU's or the Mamba mixer core's output detached."""
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    return {MOE: (moe, "_routed_local"), RGEMMA: (ops, "linear_scan"),
            MAMBA: (ops, "ssm_scan")}[config]


def family_launches(cfg, kernels=()) -> dict:
    """Each kernel's launches in one forward and backward of ``cfg``'s
    trainer: the forward and the recompute of each layer launch its
    forward kernel, the backward its backward kernel (B5 has none); the
    Mamba core's backward is the fused entry's (``SsmScanFn``), never the
    scan alone's, unless ``kernels`` has no counter of the fused entry (an
    older tree, served by ``chip_pair.py``, where the trainer ran the scan
    alone's backward)."""
    from repro_torch.models import transformer as T
    kinds = [k for k, _, _ in T.layer_plan(cfg)]
    attn = sum(k in ("full", "sliding") for k in kinds)
    rec, ssm = kinds.count("recurrent"), kinds.count("ssm")
    fused = "selective_scan_bwd[fused]"
    older = kernels and fused not in {k.name for k in kernels}
    return {"flash_attention": 2 * attn, "linear_scan": 2 * rec,
            "linear_scan_bwd": rec, "selective_scan": 2 * ssm,
            "selective_scan_bwd" if older else fused: ssm}


def _family_grads(cfg, params, batch, dev, kernels, control=None):
    """``_train_grads`` with the kernels' launches counted and the routed
    experts' ids of each ``_route`` call recorded: (loss, grads,
    launches, ids)."""
    for k in kernels:
        k.launches = 0
    with _Routes() as routes:
        loss, grads = _train_grads(cfg, params, batch, dev, control)
    return loss, grads, {k.name: k.launches for k in kernels}, routes.ids


def phase_train_family(config: str, kernels=(), dev: str = "cuda",
                       ref_dev: str = "cpu", reduced: bool = False) -> dict:
    """Phase 14 (f) (2): ``config`` at full width cut to
    TRAIN_FAMILY_MODEL's layers, one numpy-seeded batch of TRAIN_MODEL's
    shape, f32 weights drawn from seed 0 on the card (copied to the CPU
    for its side): the loss and every leaf's gradient on the card against
    the CPU (the plain versions), within TRAIN_LOSS_REL and TRAIN_GRAD_RMS;
    exact launches (``family_launches``); the control (``family_control``)
    must miss the gradient limit; for the MoE the (token, expert)
    assignments that differ between card and CPU."""
    import numpy as np
    import torch
    from repro_torch.bridge import tree_to
    from repro_torch.configs.registry import get_config, get_reduced
    from repro_torch.models import transformer as T
    layers, dtype = TRAIN_FAMILY_MODEL[config]
    cfg = (get_reduced(config) if reduced else get_config(config)).replace(
        num_layers=layers, dtype=dtype)
    params = tree_to(T.init_params(cfg, 0, device=dev), ref_dev)
    rng = np.random.default_rng(5)
    b, s = TRAIN_MODEL["batch"]
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s + 1))
             .astype(np.int32)}
    names = _leaf_paths(T.unstack_layers(params))
    t0 = time.perf_counter()
    want_loss, want, _, want_ids = _family_grads(cfg, params, batch, ref_dev,
                                                 kernels)
    cpu_s = time.perf_counter() - t0
    out = {"layers": layers, "dtype": dtype, "batch": [b, s],
           "cpu_s": cpu_s, "cpu_loss": want_loss}
    expect = family_launches(cfg, kernels)
    for label, control in (("card", None), ("control",
                                            family_control(config))):
        t0 = time.perf_counter()
        loss, got, launches, ids = _family_grads(cfg, params, batch, dev,
                                                 kernels, control)
        rel = [_rms_rel(g, w) for g, w in zip(got, want)]
        worst = int(np.argmax(rel))
        out[label] = r = {"loss": loss,
                          "loss_rel_err": abs(loss - want_loss) / want_loss,
                          "grad_rms_rel_worst": rel[worst],
                          "grad_rms_rel_median": float(np.median(rel)),
                          "worst_leaf": names[worst], "launches": launches,
                          "seconds": time.perf_counter() - t0}
        if ids:
            # the first forward's routing, layer by layer (the recompute
            # routes again), against the CPU's
            n = len(want_ids) // 2 or len(want_ids)
            r["assignments_differ"] = sum(
                int((~(a[..., :, None] == c[..., None, :]).any(-1)).sum())
                for a, c in zip(ids[:n], want_ids[:n]))
            r["assignments"] = sum(int(a.numel()) for a in ids[:n])
        del got
        ok = (r["loss_rel_err"] <= TRAIN_LOSS_REL
              and r["grad_rms_rel_worst"] <= TRAIN_GRAD_RMS)
        if dev != "cpu" and label == "card":
            bad = {k: (n, expect.get(k, 0)) for k, n in launches.items()
                   if n != expect.get(k, 0)}
            if bad:
                raise AssertionError(f"train {config}: launches (got, want) "
                                     f"{bad}")
        if ok != (label == "card"):
            raise AssertionError(
                f"train {config} {label}: loss rel err "
                f"{r['loss_rel_err']:.3e} (limit {TRAIN_LOSS_REL}), worst "
                f"leaf {r['worst_leaf']} gradient {r['grad_rms_rel_worst']:.3e}"
                f" of its RMS (limit {TRAIN_GRAD_RMS})"
                + (": the control passed" if ok else ""))
        if dev != "cpu":
            torch.cuda.empty_cache()
    return out


class _NoSave:
    """A ``Checkpointer`` whose saves write nothing (the deep family runs:
    an f32 tree and its moments are 40-60 GB; phase 14 (c) times the
    writer on qwen2-1.5b)."""

    def __init__(self, directory, keep: int = 3):
        self.saves = []

    def save(self, step, trees, extra=None):
        self.saves.append(step)

    def latest_step(self):
        return None


def _profile_split(prof) -> dict:
    """A profiled step's device time by part: the time scans' kernels, the
    static attention, the dense and grouped products, the rest."""
    split = dict.fromkeys(("time_scan", "flash_attention", "gemm", "other"),
                          0.0)
    by, ops = {}, 0
    for name, on_device, ms in _events(prof):
        if not on_device:
            continue
        ops += 1
        ours = ours_name(name)
        key = ("time_scan" if ours in SCAN_KERNELS | {"linear_scan_bwd",
                                                      "selective_scan_bwd"}
               else "flash_attention" if ours == "flash_attention"
               else "gemm" if any(f in name.lower() for f in
                                  ("gemm", "cutlass", "xmma", "nvjet"))
               else "other")
        split[key] += ms
        t, n = by.get(name[:60], (0.0, 0))
        by[name[:60]] = (t + ms, n + 1)
    return {"device_ms": split, "device_busy_ms": sum(split.values()),
            "device_ops": ops,
            "top": [{"kernel": k, "ms": t, "calls": n} for k, (t, n) in
                    sorted(by.items(), key=lambda kv: -kv[1][0])[:8]]}


class _Spans:
    """While in use, each call of ``module.attr`` on the card is bracketed
    by CUDA events on the current stream; ``ms()`` is their device time
    summed (events only: no synchronisation inside the step)."""

    def __init__(self, module, attr):
        self.module, self.attr, self.pairs = module, attr, []

    def __enter__(self):
        import torch
        self.real = real = getattr(self.module, self.attr)

        def spanned(*a, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = real(*a, **kw)
            e.record()
            self.pairs.append((s, e))
            return out

        setattr(self.module, self.attr, spanned)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.real)

    def ms(self) -> float:
        return sum(s.elapsed_time(e) for s, e in self.pairs)


def train_family_depth(config: str, kernels, dev: str = "cuda",
                       reduced: bool = False) -> dict:
    """Phase 14 (f) (3): ``config`` at TRAIN_FAMILY_DEPTH's layers through
    ``launch.train.main``, TRAIN_FAMILY_STEPS steps of [8, 512] with the
    saves stubbed (``_NoSave``): finite losses, exact launches a step
    (``family_launches``), step ms and tokens/s over the steps between the
    first and the last, peak memory; the last step runs under
    ``torch.profiler`` (device busy and idle share, time by part), with
    the AdamW update's and the Mamba cores' forwards' spans (``_Spans``:
    ``adamw_ms``, ``ssm_core_forward_ms``, the forward and the recompute
    of every layer)."""
    import math
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.registry import get_config, get_reduced
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.runtime import train_loop
    layers = TRAIN_FAMILY_DEPTH[config]
    cfg = (get_reduced(config) if reduced else get_config(config)).replace(
        num_layers=layers)
    prof_out = {}
    real_make, real_ckpt = train.make_train_step, train.Checkpointer

    def make(*a, **kw):
        step = real_make(*a, **kw)
        calls = [0]

        def profiled(*sa):
            calls[0] += 1
            if calls[0] < TRAIN_FAMILY_STEPS or dev == "cpu":
                return step(*sa)
            with profile(activities=[ProfilerActivity.CUDA]) as prof, \
                    _Spans(train_loop, "apply_updates") as adamw, \
                    _Spans(ops, "ssm_scan") as core:
                t0 = time.perf_counter()
                res = step(*sa)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            prof_out.update(_profile_split(prof), wall_ms=wall * 1e3,
                            adamw_ms=adamw.ms(),
                            ssm_core_forward_ms=core.ms())
            return res

        return profiled

    train.make_train_step, train.Checkpointer = make, _NoSave
    try:
        run = run_train(["--arch", config, "--layers", str(layers),
                         "--batch", str(TRAIN_BATCH), "--seq",
                         str(TRAIN_SEQ), "--steps", str(TRAIN_FAMILY_STEPS)]
                        + (["--reduced"] if reduced else []), kernels, dev)
    finally:
        train.make_train_step, train.Checkpointer = real_make, real_ckpt
    want = {k: n * TRAIN_FAMILY_STEPS
            for k, n in family_launches(cfg, kernels).items()}
    got = run["launches"]
    if len(run["losses"]) != TRAIN_FAMILY_STEPS or not all(
            math.isfinite(x) for x in run["losses"]):
        raise AssertionError(f"train {config} depth: losses {run['losses']}")
    bad = {k: (n, want.get(k, 0)) for k, n in got.items()
           if n != want.get(k, 0)}
    if dev != "cpu" and bad:
        raise AssertionError(f"train {config} depth: launches (got, want) "
                             f"{bad}")
    steady = run["step_s"][1:-1]
    run.update(layers=layers, first_step_s=run["step_s"][0],
               step_ms=1e3 * sum(steady) / len(steady),
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ * len(steady)
               / sum(steady), profile=prof_out)
    if prof_out:
        prof_out["device_idle_share"] = 1 - prof_out["device_busy_ms"] \
            / prof_out["wall_ms"]
    return run


def phase_train_families(report: dict, gen, kernels) -> list:
    """Phase 14 (f) on the card: (1) the backward kernels
    (``check_scan_backward``), (2) each family card vs CPU
    (``phase_train_family``), (3) each family's deep run
    (``train_family_depth``); falcon-mamba's (2) and (3) with the plain
    core composition refused on the card (``_NoPlainCore``).  Returns the
    three kernel checks."""
    import torch
    import contextlib
    r = report["train"]["families"] = {}
    t_phase = time.perf_counter()
    checks = check_scan_backward(gen)
    torch.cuda.empty_cache()
    log_time("train (f) kernels")
    for config in TRAIN_FAMILY_MODEL:
        # the Mamba core under autograd on the card: SsmScanFn's kernels
        # alone, never the plain composition (``_NoPlainCore``)
        guard = (_NoPlainCore() if config == MAMBA
                 else contextlib.nullcontext())
        t0 = time.perf_counter()
        with guard:
            r[config] = res = {"model": phase_train_family(config, kernels)}
        log(f"[train] {TRAIN_FAMILY_MODEL[config][0]}-layer full-width "
            f"{config} card vs CPU (loss, every leaf's gradient): "
            f"{json.dumps(res['model'])} ({time.perf_counter() - t0:.1f} s)")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with guard:
            res["depth"] = dp = train_family_depth(config, kernels)
        report["train"]["serve"][f"train-{config}"] = {
            "launches": dp["launches"]}
        log(f"[train] {config} at {dp['layers']} layers via "
            f"launch.train.main, {TRAIN_FAMILY_STEPS} steps of "
            f"[{TRAIN_BATCH},{TRAIN_SEQ}]: losses {dp['losses']}, step_ms="
            f"{dp['step_ms']:.1f} (first {dp['first_step_s']:.2f} s), "
            f"tokens_per_s={dp['tokens_per_s']:.0f}, peak_gb="
            f"{dp['peak_gb']:.2f}, launches {dp['launches']}, profiled step "
            f"{json.dumps(dp['profile'])} ({time.perf_counter() - t0:.1f} s)")
        torch.cuda.empty_cache()
        log_time(f"train (f) {config}")
    r["seconds"] = time.perf_counter() - t_phase
    log(f"[train] phase 14 (f) took {r['seconds']:.1f} s")
    return checks


def phase_train(report: dict, gen, kernels) -> list:
    """Phase 14 on the card: (a) B5 under autograd (``check_flash_autograd``),
    (b) the 2-layer full-width trainer card vs CPU with its control
    (``phase_train_model``), (c) full-depth qwen2-1.5b through
    ``launch.train.main`` (``train_depth``) and two profiled steps
    (``train_profile``), (d) the restart through the Supervisor
    (``train_restart``), (e) the serving kernels' refusals under autograd
    (``check_no_hidden_grad``), (f) the MoE, hybrid and Mamba families
    (``phase_train_families``).  Returns the kernel checks."""
    import torch
    r = report["train"] = {}
    t_phase = time.perf_counter()
    checks = [check_flash_autograd(gen)]
    log_time("train (a)")
    r["model"] = res = phase_train_model()
    log(f"[train] {TRAIN_MODEL['layers']}-layer full-width {TRAIN} bf16 "
        f"card vs CPU (loss, every leaf's gradient): {json.dumps(res)}")
    log_time("train (b)")
    r["depth"] = dp = train_depth(kernels)
    log(f"[train] full-depth {TRAIN} via launch.train.main, {TRAIN_STEPS} "
        f"steps of [{TRAIN_BATCH},{TRAIN_SEQ}]: losses {dp['losses']}, "
        f"step_ms={dp['step_ms']:.1f} (first {dp['first_step_s']:.2f} s), "
        f"tokens_per_s={dp['tokens_per_s']:.0f}, peak_gb="
        f"{dp['peak_gb']:.2f}, save {json.dumps(dp['saves'])}, on disk "
        f"{dp['disk_bytes']} bytes, launches {dp['launches']}")
    r["serve"] = {"train-full-depth": {"launches": dp["launches"]}}
    torch.cuda.empty_cache()
    log_time("train (c) main")
    r["profile"] = pf = train_profile(kernels)
    log(f"[train] two profiled steps on one batch: "
        f"{json.dumps({k: v for k, v in pf.items() if k != 'top'})}; top "
        f"{json.dumps(pf['top'][:6])}")
    torch.cuda.empty_cache()
    log_time("train (c) profile")
    r["restart"] = rs = train_restart(kernels)
    log(f"[train] restart (2 layers, failure before step "
        f"{RESTART_FAIL_AT}): {json.dumps(rs)}")
    r["guard"] = gd = check_no_hidden_grad(kernels)
    log(f"[train] serving kernels refuse autograd: {json.dumps(gd)}")
    torch.cuda.empty_cache()
    log_time("train (e)")
    checks += phase_train_families(report, gen, kernels)
    r["seconds"] = time.perf_counter() - t_phase
    log(f"[train] phase 14 took {r['seconds']:.1f} s")
    return checks


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on an NVIDIA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import build, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}")
    report = {"card": card}

    t0 = time.perf_counter()
    compiled = build.build_all(verbose=True)
    report["build_s"] = time.perf_counter() - t0
    log(f"[build] {len(compiled)} sources compiled in "
        f"{report['build_s']:.1f} s: {compiled}")
    report["tensor_core_sass"] = sass = tensor_core_sass(build)
    log(f"[build] cuobjdump --dump-sass, HMMA/HGMMA per kernel: "
        f"{json.dumps(sass)}")
    report["flash_ptxas"] = usage = flash_ptxas(build)
    log("[build] ptxas, flash_attention_mma_kernel<D, narrow> (registers "
        "at entry; the consumers take 240, narrow 232, by setmaxnreg): "
        + (json.dumps(usage) if usage else "not measured (cached build)"))
    report["gptq_ptxas"] = usage = gptq_ptxas(build)
    log("[build] ptxas, gptq_wgmma_kernel<NT> (registers at entry; at NT "
        "256 the consumers take 240 by setmaxnreg): "
        + (json.dumps(usage) if usage else "not measured (cached build)"))

    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = []
    for check in (check_paged_attention, check_paged_attention_quant,
                  check_flash_attention_chunk,
                  check_flash_attention_chunk_int8, check_flash_attention,
                  check_gptq_matmul):
        k = check(gen)
        kernels.append(k)
        lib = "null" if k["library_ms"] is None else f"{k['library_ms']:.4f}"
        log(f"[kernel] {k['name']}: kernel_ms={k['ms']:.4f} "
            f"plain_ms={k['plain_ms']:.4f} library_ms={lib} "
            f"bound_ms={k['bound'][0]:.5f} ({k['bound'][1]}) "
            f"max_abs_err={k['max_abs_err']:.3e} [{k['shape']}]")
    log("[kernels] " + ", ".join(k["name"] for k in kernels)
        + " built, launched and within tolerance of their plain versions")
    log_time("kernels")

    report["sampling"] = smp = phase_sampling()
    log(f"[sampling] threefry on the card vs the CPU: {json.dumps(smp)}")
    log_time("sampling")

    report["model"] = {}
    for kv in ("bf16", "int8"):
        t0 = time.perf_counter()
        report["model"][kv] = res = phase_model("cuda", kv=kv)
        log(f"[model] 2-layer full-width qwen2-1.5b rtn-int4, {kv} pool, "
            f"card vs CPU: {json.dumps(res)} "
            f"({time.perf_counter() - t0:.1f} s)")

    log_time("model")
    serves = report["serve"] = {}
    gptq_llm = None
    for label, options, must, never in (*SERVES, GPTQ_SERVE):
        if label == "gptq-chunked":
            gptq_llm = phase_gptq(report, ops.KERNELS)
        serves[label] = serve = phase_serve(
            "cuda", kernels=ops.KERNELS, label=label, options=options,
            must=must, never=never, profile=True, llm=gptq_llm,
            graphs_off=True, profile_off=False,
            sync_twin=label == SYNC_TWIN_SERVE)
        log_serve(label, serve,
                  "gptq-int4" if gptq_llm is not None else "rtn-int4")
        log_time(f"serve {label}")
        if label in ATTENTION_LAUNCHES:
            got = {k: serve["launches"][k] for k in ATTENTION_LAUNCHES[label]}
            if got != ATTENTION_LAUNCHES[label]:
                raise AssertionError(
                    f"serve {label}: attention launches {got}, want "
                    f"{ATTENTION_LAUNCHES[label]}")
    del gptq_llm
    bf16, int8 = serves["bf16-chunked"], serves["int8-chunked"]
    ratio = int8["kv_pool_bytes"] / bf16["kv_pool_bytes"]
    dtoh = (int8["profile"]["dtoh_per_step"], bf16["profile"]["dtoh_per_step"])
    log(f"[serve] int8 / bf16 kv_pool_bytes = {int8['kv_pool_bytes']} / "
        f"{bf16['kv_pool_bytes']} = {ratio:.4f}; DtoH copies per step int8 "
        f"{dtoh[0]:.2f}, bf16 {dtoh[1]:.2f}")
    for other in ("int8-chunked", "bf16-whole-prompt", "gptq-chunked"):
        log(f"[serve] greedy agreement bf16-chunked vs {other}: "
            f"{agreement(bf16['tokens'], serves[other]['tokens']):.3f}")
    check_async_serve(serves["bf16-chunked-async"], bf16)
    report["async_vs_sync"] = pair = pair_async_sync()
    log(f"[serve] bf16-chunked traffic in turns sync, async, async, sync: "
        f"{json.dumps(pair)}")
    if ratio > 0.51:
        raise AssertionError(f"serve: int8 pool is {ratio:.4f} of the bf16 "
                             "pool (limit 0.51)")
    if dtoh[0] > dtoh[1]:
        raise AssertionError(f"serve: the int8 serve copies device to host "
                             f"{dtoh[0]:.2f} times per step, the bf16 one "
                             f"{dtoh[1]:.2f}: a hidden host sync")

    log_time("serve phase")
    moe_checks = phase_moe(report, gen, ops.KERNELS)
    log_time("moe phase")
    sliding_checks = phase_sliding(report, gen, ops.KERNELS)
    log_time("sliding phase")
    phase_danube_gptq(report, ops.KERNELS)
    log_time("danube-gptq phase")
    hybrid_checks = phase_hybrid(report, gen, ops.KERNELS)
    log_time("hybrid phase")
    ssm_checks = phase_ssm(report, gen, ops.KERNELS)
    log_time("ssm phase")
    vlm_checks = phase_vlm(report, gen, ops.KERNELS)
    log_time("vlm phase")
    audio_checks = phase_audio(report, gen, ops.KERNELS)
    log_time("audio phase")
    cmdr_checks = phase_cmdr(report, gen, ops.KERNELS)
    log_time("cmdr phase")
    phase_cli(report, ops.KERNELS)
    log_time("cli phase")
    phase_examples(report, ops.KERNELS)
    log_time("examples phase")
    train_checks = phase_train(report, gen, ops.KERNELS)
    log_time("train phase")

    record = []
    # each check's launches come from the serves of its own phase
    for k, phase_serves in ([(k, serves) for k in kernels]
                            + [(k, report["moe"]["serve"])
                               for k in moe_checks]
                            + [(k, report["sliding"]["serve"])
                               for k in sliding_checks]
                            + [(k, report["hybrid"]["serve"])
                               for k in hybrid_checks]
                            # the RG-LRU's scan runs in recurrentgemma's
                            # serve, the selective scan in falcon-mamba's
                            + [(k, report["hybrid" if k["name"] ==
                                        "linear_scan" else "ssm"]["serve"])
                               for k in ssm_checks]
                            # llava's serve and its vision wave with its
                            # decode steps; hubert's full-depth forward
                            + [(k, report["vlm"]["serve"])
                               for k in vlm_checks]
                            + [(k, report["audio"]["serve"])
                               for k in audio_checks]
                            + [(k, report["cmdr"]["serve"])
                               for k in cmdr_checks]
                            + [(k, report["train"]["serve"])
                               for k in train_checks]):
        # a check of one serve's shapes counts that serve's launches only
        by_serve = {lb: sv["launches"][k["name"]]
                    for lb, sv in phase_serves.items()
                    if lb in k.get("serves", phase_serves)}
        if phase_serves is serves:
            by_serve["gptq-load"] = \
                report["gptq"]["load"]["launches"][k["name"]]
            # the examples run qwen2-1.5b at full width
            by_serve.update({f"example {n}": ex["launches"][k["name"]]
                             for n, ex in report["examples"].items()
                             if isinstance(ex, dict)})
        if phase_serves is report["sliding"]["serve"]:
            by_serve["danube-gptq-load"] = \
                report["danube_gptq"]["load"]["launches"][k["name"]]
        record.append({
            "name": k.get("label", k["name"]), "route": k["route"],
            "source": k["source"],
            "replaces": k["replaces"],
            "launches": sum(by_serve.values()),
            "launches_by_serve": by_serve,
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound"][0],
            "bound_by": k["bound"][1], "library_ms": k["library_ms"],
            "shape": k["shape"],
            **{key: v for key, v in k.items()
               if key.startswith("backward_")}})
    report["kernels"] = (kernels + moe_checks + sliding_checks
                         + hybrid_checks + ssm_checks + vlm_checks
                         + audio_checks + cmdr_checks + train_checks)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(card)
    log(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
