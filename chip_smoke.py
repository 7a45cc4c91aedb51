#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails loudly (any failure exits non-zero):

1. build   — compile the hand-written kernels (``csrc/*.cu``, nvcc for
             sm_90a, one process per source), print the build time, and
             count the tensor-core instructions (HMMA / HGMMA) that
             ``cuobjdump --dump-sass`` shows in every instantiation of the
             bf16 paged decode, chunk prefill, static attention and int4
             matmul kernels (none is a failure);
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
             tokens;
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
             take pipelined steps and make no pageable copy;
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
             the experts it touches; the full-width model cut to 2 layers
             in f32 card vs CPU (as phase 3, within MOE_LOGIT_TOL); then
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

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Details also go to
``chiprun_out/chip_smoke.json``.  Without a card it exits non-zero and
prints no result.
"""
from __future__ import annotations

import json
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
SPIN_CYCLES = 2_000_000          # ~1 ms of device clock before each timing

H, KV, D, BS, NB, MB, B, W = 12, 2, 128, 16, 512, 64, 8, 256
LINEARS = {"wq/wo": (1536, 1536), "wk/wv": (1536, 256),
           "gate/up": (1536, 8960), "down": (8960, 1536)}
GS = 32


def log(msg: str) -> None:
    print(msg, flush=True)


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
                       "gptq_matmul": "gptq_mma_kernel",
                       "paged_attention": "paged_attention_mma_kernel",
                       "flash_attention_chunk": "chunk_attention_mma_kernel"}


def tensor_core_sass(build) -> dict:
    """Count the tensor-core instructions (HMMA, HGMMA) that ``cuobjdump
    --dump-sass`` shows in every instantiation of each kernel of
    TENSOR_CORE_KERNELS in the built libraries; fails if a kernel is
    missing or one of its instantiations has none."""
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
                    counts[name] = 0
            elif name in counts and ("HMMA" in line or "HGMMA" in line):
                counts[name] += 1
        mine = {n: c for n, c in counts.items() if fn in n}
        if not mine or not all(mine.values()):
            raise AssertionError(f"{fn}: no HMMA/HGMMA in {path}: {mine}")
    return counts


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


def check_paged_attention(gen, int8: bool = False, heads=(H, KV)):
    """The decode kernel over the bf16 pool, or (``int8``) over the int8
    pool, in every case of PAGED_CASES at ``heads`` (query heads, KV
    heads): live rows within TOL of the plain version, seq_len-0 rows
    exactly 0, two calls bitwise equal; each case timed beside its bound,
    the first also beside the plain version."""
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
        if not err <= TOL or zero != 0.0:
            raise AssertionError(f"{name} {label}: max err {err} (tol {TOL})"
                                 f", seq_len 0 rows max {zero} (want 0)")
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
        rows.append(row)
        log(f"{name} {label}: kernel_ms={row['ms']:.4f} "
            f"bound_ms={row['bound'][0]:.5f} ({row['bound'][1]}) "
            f"max_abs_err={err:.3e}")
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


def check_flash_attention_chunk(gen, int8: bool = False, heads=(H, KV)):
    """The chunk kernel over the bf16 pool, or (``int8``) its int8-pool
    branch, in every case of CHUNK_CASES at ``heads`` (query heads, KV
    heads): the live rows within TOL of the plain version, two calls
    bitwise equal, each case timed beside its bound (the last also beside
    the plain version)."""
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
        if not err <= TOL:
            raise AssertionError(f"{kernel.name} {label}: max err {err} "
                                 f"(tol {TOL})")
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
        rows.append(row)
        log(f"{kernel.name} {label}: kernel_ms={row['ms']:.4f} "
            f"bound_ms={row['bound'][0]:.5f} ({row['bound'][1]}) "
            f"max_abs_err={err:.3e}")
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


def check_flash_attention(gen):
    """The static prefill kernel at the whole-prompt serve's wave shape
    (causal), then at q_offset > 0 with Sq < Sk, a sliding band, ALiBi, a
    ragged Sq = Sk = 333 (causal and not), head dim 64 (qwen1.5-0.5b's
    16 heads over 16 KV heads, G = 1) and the GPTQ load's calibration batch
    (plain causal, [CALIB_B, CALIB_S]).  Every case is timed beside one SDPA
    call on its inputs (the library yardstick; a mask where the case is not
    a plain causal square) and its bound (the live (q, k) pairs)."""
    import torch
    from repro_torch.core.alibi import alibi_slopes
    from repro_torch.core.gqa import NEG_INF
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    dev = "cuda"

    def qkv(b, sq, sk, h=H, kv=KV, d=D):
        return tuple(torch.randn(shape, generator=gen, device=dev).bfloat16()
                     for shape in ((b, sq, h, d), (b, sk, kv, d),
                                   (b, sk, kv, d)))

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
    worst, rows = 0.0, []
    for label, (q, k, v), kw in cases:
        out = flash_attention(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        if not err <= TOL:
            raise AssertionError(f"flash_attention {label}: max err {err} "
                                 f"(tol {TOL})")
        _repeat_equal("flash_attention", label,
                      lambda: flash_attention(q, k, v, **kw), out)
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
        bias = None
        if kw:
            bias = torch.where(live, 0.0, NEG_INF)[None, None].expand(
                1, h, sq, sk)
            if "alibi_slopes" in kw:
                bias = bias - kw["alibi_slopes"][:, None, None] \
                    * dist.abs()[None].float()
            bias = bias.bfloat16()
        row = {"case": label, "q": list(q.shape), "kv": list(k.shape),
               "max_abs_err": err,
               "ms": time_ms(lambda: flash_attention(q, k, v, **kw)),
               "library_ms": _sdpa_ms(q, k, v, bias),
               "bound": bound_ms(nbytes, 4 * h * d * pairs)}
        rows.append(row)
        lib = row["library_ms"]
        log(f"flash_attention {label}: q{row['q']} kv{row['kv']} "
            f"kernel_ms={row['ms']:.4f} sdpa_ms="
            + ("null" if lib is None else f"{lib:.4f}")
            + f" bound_ms={row['bound'][0]:.5f} ({row['bound'][1]}) "
            f"max_abs_err={err:.3e}")
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


def check_gptq_matmul(gen):
    """Each product of GPTQ_SHAPES against the plain version; two calls
    must give bitwise-equal outputs (split-K sums in a fixed order).  Each shape is timed beside the plain version, the
    library call (``torch._weight_int4pack_mm`` on weights repacked once,
    checked against the plain version first) and a dense bf16 matmul on
    the dequantized weight (another function: what int4 is meant to
    beat)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.gptq_matmul import gptq_matmul
    dev = "cuda"
    rows, worst, main = [], 0.0, None
    lib_fn = getattr(torch, "_weight_int4pack_mm", None)
    for lname, K, N, gs, ms in GPTQ_SHAPES:
        qw = torch.randint(-2 ** 31, 2 ** 31 - 1, (K // 8, N), generator=gen,
                           device=dev, dtype=torch.int64).int()
        sc = (torch.rand((K // gs, N), generator=gen, device=dev) * 0.01)
        zr = torch.randint(0, 16, (K // gs, N), generator=gen,
                           device=dev).float()
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
                   "ms": time_ms(lambda: gptq_matmul(x, qw, sc, zr)),
                   "plain_ms": time_ms(lambda: ref.gptq_matmul_ref(
                       x, qw, sc, zr), iters=3),
                   "bound": bound_ms(nbytes, flops), "rel_err": err / scale,
                   "library_ms": None, "library_note": why,
                   "dense_bf16_matmul_ms": time_ms(lambda: x @ w16)}
            if packed is not None:
                row["library_note"] = _library_check(
                    row, lambda: lib_fn(x, packed, gs, sz), want, lim)
            rows.append(row)
            lib = row["library_ms"]
            log(f"gptq_matmul {lname:8s} M={M:4d} K={K} N={N} gs={gs}: "
                f"kernel_ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                f"library_ms=" + ("null" if lib is None else f"{lib:.4f}")
                + f" bound_ms={row['bound'][0]:.4f} ({row['bound'][1]}) "
                f"dense_bf16_matmul_ms={row['dense_bf16_matmul_ms']:.4f} "
                f"rel_err={row['rel_err']:.2e} [{row['library_note']}]")
            if lname == "gate/up" and M == 8:
                main = row
    return {"name": "gptq_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gptq_matmul.cu",
            "replaces": "src/repro/kernels/gptq_matmul.py:75",
            "max_abs_err": worst, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound": main["bound"],
            "library_ms": main["library_ms"],
            "shape": "x[8,1536] @ int4[1536,8960] gs 32 (gate/up, decode); "
                     "max_abs_err relative to max|ref|",
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
    return out


# --------------------------------------------------------------------------
# Phase 3: the 2-layer full-width model on the card and on the CPU
# --------------------------------------------------------------------------

# card vs CPU logits of the 2-layer MoE model in f32: the sums run in
# another order (rounding ~1e-6 of logits of size ~5); bf16 is not used
# because MoE routing turns its rounding into other experts
MOE_LOGIT_TOL = 1e-3


def phase_model(dev: str, ref_dev: str = "cpu", layers: int = 2,
                kv: str = "bf16", config: str = "qwen2-1.5b") -> dict:
    """The same params, pools and inputs through the decode step, a chunk
    at q_offset 160, the unified step and a whole-prompt ``T.prefill``
    wave on ``dev`` and on ``ref_dev``; ``kv`` picks the pool format.
    ``config``'s full width cut to ``layers``: a dense config with int4
    (RTN) weights and bf16 activations, held to LOGIT_TOL; an MoE config
    with f32 weights and activations, held to MOE_LOGIT_TOL."""
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
        params = quantize_params_rtn(T.init_params(cfg, 1, ref_dev), cfg, GS)
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
            p = T.split_layers(T.cast_params(tree_to(params, d),
                                             T.act_dtype(cfg)))

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
            st = fresh(wbt, wlens)
            wave, st = T.prefill(cfg, p, st, {"tokens": i32(wtoks),
                                              "ctx_lens": i32(wlens)})
            res[d] = (dec.float().cpu(), chunk.float().cpu(),
                      wave.float().cpu(), nxt.cpu(), unified_pool,
                      pool_values(st))
    (d0, c0, w0, n0, *p0), (d1, c1, w1, n1, *p1) = res[ref_dev], res[dev]
    # inactive decode rows (seq_len 0) are garbage by contract: the kernel
    # writes zeros there, the plain version an average — compare live rows
    live = torch.from_numpy(active)
    d0, d1 = d0[live], d1[live]
    err = max((a - b).abs().max().item()
              for a, b in ((d1, d0), (c1, c0), (w1, w0)))
    scale = max(t.abs().max().item() for t in (d0, c0, w0))
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
            "prefill_wave_greedy_agreement": wave_agree,
            "tolerance": tol}


# --------------------------------------------------------------------------
# Phase 4: serve full-depth qwen2-1.5b with int4 weights
# --------------------------------------------------------------------------

def serve_prompts(vocab: int, lens=(20, 64 + 40, 64 + 300, 150, 420, 600,
                                    777, 900), seed: int = 0):
    import numpy as np
    rng = np.random.default_rng(seed)
    ps = [rng.integers(0, vocab, n).tolist() for n in lens]
    ps[2][:64] = ps[1][:64]              # a shared 64-token prefix
    return ps


# The synchronous engine (read back every step, no span tracer): the
# first four serves run it, the fifth the engine's defaults.
SYNC = {"enable_async_step": False, "enable_telemetry": False}
BF16_CHUNKED_KERNELS = (
    {"paged_attention", "flash_attention_chunk", "gptq_matmul"},
    {"paged_attention_quant", "flash_attention_chunk_int8",
     "flash_attention"})
# The serves: (label, LLM.load options, kernels that must launch, kernels
# that must not).  Each runs its own path: the int8 serve never touches a
# bf16-pool attention kernel, the whole-prompt serve never the chunk
# kernel.  The last runs the engine's defaults (async pipelined step,
# telemetry and guards on) on bf16-chunked's traffic.
SERVES = (
    ("bf16-chunked", SYNC, *BF16_CHUNKED_KERNELS),
    ("int8-chunked", {**SYNC, "kv_cache_dtype": "int8"},
     {"paged_attention_quant", "flash_attention_chunk_int8", "gptq_matmul"},
     {"paged_attention", "flash_attention_chunk", "flash_attention"}),
    ("bf16-whole-prompt", {**SYNC, "enable_chunked_prefill": False},
     {"flash_attention", "paged_attention", "gptq_matmul"},
     {"flash_attention_chunk", "flash_attention_chunk_int8",
      "paged_attention_quant"}),
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


def phase_serve(dev: str, config: str = "qwen2-1.5b", reduced: bool = False,
                max_tokens: int = 32, kernels=(), label: str = "bf16-chunked",
                options=None, must=(), never=(), profile: bool = False,
                llm=None, quant="rtn-int4") -> dict:
    """Serve the 8 requests of ``serve_prompts`` on ``llm`` or, when none
    is given, on ``LLM.load(config, quant=quant, **options)``; on the card
    the peak of ``torch.cuda.max_memory_allocated`` over the load and
    over the whole phase is recorded."""
    import torch
    from repro_torch.serving import LLM, SamplingParams
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
    vocab = llm.cfg.vocab_size
    llm.generate([list(range(1, 40))], SamplingParams(max_tokens=2))  # warm
    prompts = serve_prompts(vocab)
    sps = [SamplingParams(max_tokens=max_tokens - 3 * i) for i in range(8)]
    eng = llm.engine
    # chip_pair.py also serves older trees of the port through this
    # function: what their engine lacks (the runner's step counts, the
    # metrics registry, the span tracer) is left out of their record
    new_engine = hasattr(eng, "obs")
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
    outs = llm.generate(prompts, sps)
    if dev != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    m = {k: eng.metrics.get(k, 0) - v for k, v in base.items()}
    steps = {k: eng.runner.steps[k] - steps0[k] for k in steps0}
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
        # each attention call launches its kernel once per layer
        L = llm.cfg.num_layers
        int8 = eng.kv_cache_dtype == "int8"
        want = {"paged_attention_quant" if int8 else "paged_attention":
                L * steps["decode"],
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
    prof = profile_serve(llm, prompts, sps, outs) if profile else None
    out = {"label": label, "options": options or {}, "profile": prof,
           "config": llm.cfg.name, "layers": llm.cfg.num_layers,
           "requests": len(outs), "prompt_lens": [len(p) for p in prompts],
           "load_s": load_s, "wall_s": wall,
           "load_max_memory_allocated": load_peak,
           "max_memory_allocated": torch.cuda.max_memory_allocated()
           if card else None,
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
           "launches": launches,
           "tokens": [o.token_ids for o in outs]}
    del llm, eng
    if dev != "cpu":
        torch.cuda.empty_cache()
    return out


# Our kernels' device functions (every instantiation) -> wrapper name; an
# int8 pool ("signed char") names the quantized entry.
OURS = {"paged_attention_": "paged_attention",
        "chunk_attention_": "flash_attention_chunk",
        "flash_attention_": "flash_attention", "gptq_m": "gptq_matmul",
        "splitk_reduce_kernel": "gptq_matmul"}
INT8_NAMES = {"paged_attention": "paged_attention_quant",
              "flash_attention_chunk": "flash_attention_chunk_int8"}


def ours_name(key: str):
    """The wrapper whose kernel a profiler key names, or None."""
    for frag, name in OURS.items():
        if frag in key:
            return INT8_NAMES.get(name, name) if "signed char" in key \
                else name
    return None


def profile_serve(llm, prompts, sps, outs) -> dict:
    """Serve the same requests again under ``torch.profiler`` (after the
    launch counts were read) and sum the device time by kernel: ours, and
    every other kernel PyTorch launched; count the device-to-host copies
    per engine step and the copies from or to pageable host memory.  Also
    checks the re-run's tokens against the first run's (greedy:
    identical)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    steps0 = llm.engine.metrics["work_steps"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        again = llm.generate(prompts, sps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = llm.engine.metrics["work_steps"] - steps0
    if [o.token_ids for o in again] != [o.token_ids for o in outs]:
        raise AssertionError("serve: the profiled re-run changed tokens")
    by, dtoh, pageable, ops = {}, 0, 0, 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        ops += e.count
        if "Memcpy DtoH" in e.key:
            dtoh += e.count
        # a copy from or to pageable host memory blocks the host on the
        # stream: it would stall the async engine's pipeline
        if "Memcpy" in e.key and "Pageable" in e.key:
            pageable += e.count
        key = ours_name(e.key) or e.key[:60]
        ms, n = by.get(key, (0.0, 0))
        by[key] = (ms + us / 1e3, n + e.count)
    busy = sum(ms for ms, _ in by.values())
    top = sorted(by.items(), key=lambda kv: -kv[1][0])[:12]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / (wall * 1e3),
            "work_steps": steps, "dtoh_copies": dtoh,
            "dtoh_per_step": dtoh / max(steps, 1),
            "pageable_copies": pageable,
            "device_ops_per_step": ops / max(steps, 1),
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


def gptq_load(kernels, dev: str = "cuda", reduced: bool = False):
    """(b) ``LLM.load("qwen2-1.5b", quant="gptq-int4")`` at full depth on
    CALIB_N x [CALIB_B, CALIB_S] seeded calibration tokens.  The launch
    counters are zeroed just before the load: the calibration forward
    must launch the static ``flash_attention`` once per layer and batch,
    and nothing else; every leaf of the served params lies on ``dev``."""
    import torch
    from repro_torch.configs.registry import get_config, get_reduced
    from repro_torch.models import transformer as T
    from repro_torch.serving import LLM
    from repro_torch.serving.llm import _synthetic_calib
    cfg = get_reduced("qwen2-1.5b") if reduced else get_config("qwen2-1.5b")
    calib = _synthetic_calib(cfg, 1, CALIB_N, CALIB_B, CALIB_S)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    llm = LLM.load("qwen2-1.5b", quant="gptq-int4", seed=0, reduced=reduced,
                   calib_batches=calib, device=dev, **SYNC)
    if dev != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
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
                        "launches": launches}


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


def gptq_quality(llm, calib, dev: str = "cuda") -> dict:
    """(b) GPTQ's Hessian-weighted proxy loss against RTN's (group size
    GS, ``quantize_params_rtn``) on the same dense weights, for the 56
    (layer, Hessian) pairs: wq|wk|wv under the attention-input Hessian,
    w_gate|w_up under the MLP-input one.  The dense weights and Hessians
    are made again from the load's seed and calibration tokens.  Then
    (a): layer 0's w_gate [1536, 8960] through the port's OBQ on the card
    and on the CPU, the same float64 W and H."""
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

    # (a) card OBQ against CPU OBQ, one full-width w_gate
    qcfg = QuantConfig(bits=4, group_size=GS)
    w = dl[0]["mlp"]["w_gate"].double()
    h = hess[0][1].h
    card, card_s = _timed_obq(w, h, qcfg)
    cpu, cpu_s = _timed_obq(w.cpu(), h.cpu(), qcfg)
    equal = float((card.q.cpu() == cpu.q).float().mean())
    same_sz = (torch.equal(card.scales.cpu(), cpu.scales)
               and torch.equal(card.zeros.cpu(), cpu.zeros))
    e_card = quant_error(w, card, h)
    e_cpu = quant_error(w.cpu(), cpu, h.cpu())
    rel = abs(e_card - e_cpu) / e_cpu
    # the load quantized w_gate in one loop with w_up: its codes
    loaded = _qt_of(llm.params["layers"][0]["mlp"], ("w_gate",), d)
    out["obq"] = {"shape": list(w.shape), "card_s": card_s,
                  "cpu_s": cpu_s, "codes_equal": equal,
                  "scales_zeros_equal": same_sz, "err_card": e_card,
                  "err_cpu": e_cpu, "err_rel": rel,
                  "load_codes_equal": float((loaded.q.cpu()
                                             == cpu.q).float().mean()),
                  "rtn_err": quant_error(w, _qt_of(rtn["layers"][0]["mlp"],
                                                   ("w_gate",), d), h)}
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
    attention, wo, residual): relative Frobenius difference of each."""
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
        sc = sc.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1),
                            float("-inf"))
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
    log(f"[gptq] OBQ of w_gate {o['shape']}: card_s={o['card_s']:.3f} "
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
MOE_BF16 = {"paged_attention", "flash_attention_chunk"}
MOE_INT8 = {"paged_attention_quant", "flash_attention_chunk_int8"}
# The MoE serves (bf16 weights, the reference's only MoE mode), full
# depth, on serve_prompts' traffic: (label, LLM.load options, kernels that
# must launch, kernels that must not).  No int4 matmul, no static
# attention: chunked prefill over the paged pool only.
MOE_SERVES = (
    ("moe-chunked-async", {}, MOE_BF16,
     MOE_INT8 | {"flash_attention", "gptq_matmul"}),
    ("moe-chunked", SYNC, MOE_BF16,
     MOE_INT8 | {"flash_attention", "gptq_matmul"}),
    ("moe-int8-chunked", {**SYNC, "kv_cache_dtype": "int8"}, MOE_INT8,
     MOE_BF16 | {"flash_attention", "gptq_matmul"}))


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
    """One serve's record, and its profiled re-run's, on the log."""
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
    log(f"[serve] {label}: load_s={serve['load_s']:.2f} "
        f"load_max_memory_allocated={serve['load_max_memory_allocated']} "
        f"max_memory_allocated={serve['max_memory_allocated']} "
        f"latency {json.dumps(serve['latency'])} "
        f"attribution {json.dumps(serve['attribution'])}")
    prof = serve["profile"]
    log(f"[profile] {label} re-run under torch.profiler: "
        f"wall_ms={prof['wall_ms']:.1f} "
        f"device_busy_ms={prof['device_busy_ms']:.1f} "
        f"device_idle_share={prof['device_idle_share']:.3f} "
        f"dtoh_copies={prof['dtoh_copies']} over "
        f"{prof['work_steps']} steps "
        f"({prof['dtoh_per_step']:.2f}/step) "
        f"pageable_copies={prof['pageable_copies']} "
        f"device_ops_per_step={prof['device_ops_per_step']:.0f} "
        f"ours_ms={json.dumps(prof['ours_ms'])}")
    for row in prof["top"]:
        log(f"[profile]   {row['ms']:9.2f} ms  {row['calls']:6d} calls  "
            f"{row['kernel']}")


def phase_moe(report: dict, gen, kernels) -> list:
    """Phase 6 on the card: the attention kernels at the MoE model's
    heads, one layer's expert product, the 2-layer f32 model card vs CPU,
    the three full-depth MoE serves (each with its launches counted from
    zero), then the checkpoint reader.  Returns the kernel checks."""
    m = report["moe"] = {}
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
    m["ffn"] = check_moe_ffn(gen)
    t0 = time.perf_counter()
    m["model"] = res = phase_model("cuda", config=MOE)
    log(f"[model] 2-layer full-width {MOE} f32, card vs CPU: "
        f"{json.dumps(res)} ({time.perf_counter() - t0:.1f} s)")
    serves = m["serve"] = {}
    for label, options, must, never in MOE_SERVES:
        serves[label] = serve = phase_serve(
            "cuda", config=MOE, quant=None, kernels=kernels, label=label,
            options=options, must=must, never=never, profile=True)
        log_serve(label, serve, "bf16")
    check_async_serve(serves["moe-chunked-async"], serves["moe-chunked"])
    same = agreement(serves["moe-chunked"]["tokens"],
                     serves["moe-int8-chunked"]["tokens"])
    log(f"[serve] greedy agreement moe-chunked vs moe-int8-chunked: "
        f"{same:.3f}")
    m["checkpoint"] = ck = phase_checkpoint()
    log(f"[checkpoint] qwen2-1.5b x{ck['layers']} written ({ck['bytes']} "
        f"bytes, {ck['write_s']:.2f} s) and read by LLM.load(checkpoint=..)"
        f" in {ck['load_s']:.2f} s: greedy tokens equal the in-memory "
        "params'")
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

    report["sampling"] = smp = phase_sampling()
    log(f"[sampling] threefry on the card vs the CPU: {json.dumps(smp)}")

    report["model"] = {}
    for kv in ("bf16", "int8"):
        t0 = time.perf_counter()
        report["model"][kv] = res = phase_model("cuda", kv=kv)
        log(f"[model] 2-layer full-width qwen2-1.5b rtn-int4, {kv} pool, "
            f"card vs CPU: {json.dumps(res)} "
            f"({time.perf_counter() - t0:.1f} s)")

    serves = report["serve"] = {}
    gptq_llm = None
    for label, options, must, never in (*SERVES, GPTQ_SERVE):
        if label == "gptq-chunked":
            gptq_llm = phase_gptq(report, ops.KERNELS)
        serves[label] = serve = phase_serve(
            "cuda", kernels=ops.KERNELS, label=label, options=options,
            must=must, never=never, profile=True, llm=gptq_llm)
        log_serve(label, serve,
                  "gptq-int4" if gptq_llm is not None else "rtn-int4")
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

    moe_checks = phase_moe(report, gen, ops.KERNELS)

    record = []
    for k in kernels + moe_checks:
        if "label" in k:          # the MoE model's heads: its serves
            by_serve = {lb: sv["launches"][k["name"]]
                        for lb, sv in report["moe"]["serve"].items()}
        else:
            by_serve = {lb: sv["launches"][k["name"]]
                        for lb, sv in serves.items()}
            by_serve["gptq-load"] = \
                report["gptq"]["load"]["launches"][k["name"]]
        record.append({
            "name": k.get("label", k["name"]), "route": k["route"],
            "source": k["source"],
            "replaces": k["replaces"],
            "launches": sum(by_serve.values()),
            "launches_by_serve": by_serve,
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound"][0],
            "bound_by": k["bound"][1], "library_ms": k["library_ms"],
            "shape": k["shape"]})
    report["kernels"] = kernels + moe_checks
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
