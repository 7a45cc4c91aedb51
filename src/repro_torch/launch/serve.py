"""Serving driver: continuous batching over the paged engine via ``LLM``,
the port's counterpart of the JAX package's ``launch/serve.py`` (its
flags, defaults, prompts and printed lines).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --no-reduced --quant rtn-int4 --requests 16 [--stream] \
        [--top-k 40] [--top-p 0.95] [--temperature 0.8] [--stop 13 198] \
        [--mha-baseline]
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu

It runs on the card (``--device cuda``, the default) and raises on a host
without one; ``--device cpu`` runs the plain reference path.
``--mha-baseline`` serves the same arch with kv_heads == num_heads and
prefix reuse off — the paper's comparison point (Fig. 2). ``--stream``
prints each ``RequestOutput`` delta as horizons complete instead of
waiting for the batch to drain.

Robustness knobs: ``--max-waiting N`` bounds the intake queue with
``--shed-policy {reject,shed-oldest}`` deciding what happens when it is
full (``reject`` raises ``EngineOverloadedError`` at submit — with this
driver's submit-all-upfront pattern that aborts the run, which is the
point of the policy; ``shed-oldest`` finishes the oldest waiting request
with ``finish_reason='shed'``), and ``--deadline-ms`` attaches an
end-to-end deadline to every request (``finish_reason='deadline'`` on
expiry).

Observability knobs: ``--metrics-port N`` serves ``/metrics``
(Prometheus), ``/health`` (JSON) and ``/trace`` (Chrome trace JSON) on
localhost while the run executes; ``--trace-out f.json`` writes the span
timeline at exit (open in Perfetto); ``--metrics-out f.json`` dumps the
registry snapshot; ``--profile-dir d/`` wraps the run in a
``torch.profiler`` capture (CPU, and CUDA on the card) with a
``record_function`` label on every device dispatch, exported to
``d/trace.json`` as a Chrome trace; ``--no-enable-telemetry`` turns the
span tracer off (the metrics registry is always on).

``main(argv)`` takes the argument list (``sys.argv[1:]`` when None), so
it can be called in process.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.configs.base import PagingConfig
from repro_torch.serving import LLM, SamplingParams


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the tiny same-family CPU config "
                         "(--no-reduced loads the full-size one)")
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs: the card (default; raises "
                         "without one) or 'cpu' for the plain reference "
                         "path")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-tokens", "--max-new", dest="max_tokens",
                    type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--blocks", type=int, default=256)
    ap.add_argument("--quant", default=None,
                    choices=["rtn-int4", "gptq-int4"],
                    help="serve int4 weights (Opt-GPTQ configuration): "
                         "RTN or Hessian-based GPTQ")
    ap.add_argument("--kv-cache-dtype", default="bf16",
                    choices=["bf16", "int8"],
                    help="paged KV pool format: int8 quantizes K/V on "
                         "write (per-block-per-head scales, ~2x lower KV "
                         "bytes/token vs bf16)")
    ap.add_argument("--checkpoint", default=None,
                    help="Checkpointer directory to restore params from")
    ap.add_argument("--max-num-batched-tokens", type=int, default=256,
                    help="per-step token budget: running decodes are "
                         "packed first, prefill chunks fill the rest "
                         "(bounds inter-token latency at O(chunk))")
    ap.add_argument("--enable-chunked-prefill",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="--no-enable-chunked-prefill restores the "
                         "stop-the-world whole-prompt prefill (the "
                         "parity oracle; also the path non-full-"
                         "attention archs always use)")
    ap.add_argument("--enable-unified-step",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="--no-enable-unified-step restores the two-call "
                         "mixed step (separate decode / prefill-chunk / "
                         "sample dispatches) — the unified single-"
                         "dispatch step's parity oracle")
    ap.add_argument("--enable-async-step",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="--no-enable-async-step restores the read-back-"
                         "every-step loop — the async pipelined step "
                         "(plan/enqueue N+1 while N executes, tokens "
                         "read back one step late) is on by default in "
                         "unified mode")
    ap.add_argument("--max-waiting", type=int, default=None,
                    help="bound the waiting queue; arrivals past the "
                         "bound are handled per --shed-policy")
    ap.add_argument("--shed-policy", default="reject",
                    choices=["reject", "shed-oldest"],
                    help="full-queue policy: 'reject' refuses the new "
                         "request (EngineOverloadedError), 'shed-oldest' "
                         "finishes the oldest waiting request with "
                         "finish_reason='shed' to make room")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request end-to-end deadline from arrival; "
                         "expired requests finish with "
                         "finish_reason='deadline'")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--stop", type=int, nargs="*", default=[],
                    help="stop token ids (finish_reason='stop')")
    ap.add_argument("--stream", action="store_true",
                    help="print RequestOutput deltas as they arrive")
    ap.add_argument("--mha-baseline", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--enable-telemetry",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="--no-enable-telemetry disables the span tracer "
                         "(zero-work no-op); counters/histograms stay on")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve /metrics (Prometheus), /health (JSON) and "
                         "/trace (Chrome JSON) on 127.0.0.1:PORT for the "
                         "duration of the run")
    ap.add_argument("--trace-out", default=None,
                    help="write the span timeline as Chrome-trace JSON "
                         "at exit (load in Perfetto / about:tracing)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the metrics-registry JSON snapshot at exit")
    ap.add_argument("--profile-dir", default=None,
                    help="capture a torch.profiler trace of the run into "
                         "DIR/trace.json (adds a record_function label to "
                         "every device dispatch)")
    return ap


def _start_profiler(device: str):
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = _parser().parse_args(argv)

    overrides = {}
    if args.mha_baseline:
        from repro_torch.configs.registry import get_config, get_reduced
        base = get_reduced(args.arch) if args.reduced else \
            get_config(args.arch)
        overrides = dict(num_kv_heads=base.num_heads,
                         paging=PagingConfig(enable_prefix_reuse=False))
    llm = LLM.load(args.arch, quant=args.quant,
                   kv_cache_dtype=args.kv_cache_dtype,
                   checkpoint=args.checkpoint,
                   reduced=args.reduced, overrides=overrides,
                   seed=args.seed, device=args.device, max_slots=args.slots,
                   num_blocks=args.blocks, max_blocks_per_seq=16,
                   max_num_batched_tokens=args.max_num_batched_tokens,
                   enable_chunked_prefill=args.enable_chunked_prefill,
                   enable_unified_step=args.enable_unified_step,
                   enable_async_step=args.enable_async_step,
                   max_waiting=args.max_waiting,
                   shed_policy=args.shed_policy,
                   prefill_bucket=32,
                   enable_telemetry=args.enable_telemetry,
                   profile_labels=bool(args.profile_dir))

    server = None
    if args.metrics_port is not None:
        from repro_torch.obs.http import start_obs_server
        server = start_obs_server(args.metrics_port,
                                  registry=llm.engine.obs,
                                  health_fn=llm.engine.health,
                                  tracer=llm.engine.tracer)
        print(f"# obs endpoint on http://127.0.0.1:"
              f"{server.server_address[1]} (/metrics /health /trace)")
    prof = None
    if args.profile_dir:
        os.makedirs(args.profile_dir, exist_ok=True)
        prof = _start_profiler(args.device)

    rng = np.random.default_rng(args.seed)
    prefix = list(rng.integers(1, 200, 24))
    prompts = [prefix + list(rng.integers(1, 200, int(rng.integers(4, 32))))
               for _ in range(args.requests)]
    sp = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                        top_p=args.top_p, stop=list(args.stop),
                        max_tokens=args.max_tokens,
                        deadline_ms=args.deadline_ms)

    try:
        if args.stream:
            for out in llm.stream(prompts, sp):
                print(json.dumps({
                    "rid": out.request_id, "new": out.new_token_ids,
                    "n_total": len(out.token_ids),
                    "finish_reason": out.finish_reason}))
        else:
            outs = llm.generate(prompts, sp)
            for out in outs:
                print(json.dumps({"rid": out.request_id,
                                  "tokens": out.token_ids,
                                  "finish_reason": out.finish_reason}))
        if prof is not None:
            prof.stop()
            prof.export_chrome_trace(os.path.join(args.profile_dir,
                                                  "trace.json"))
            prof = None
        if args.trace_out:
            llm.engine.tracer.save(args.trace_out)
        if args.metrics_out:
            with open(args.metrics_out, "w") as f:
                json.dump(llm.engine.obs.snapshot(), f, indent=1)
        attr = llm.engine.attribution()
        if attr["steps"]:
            print(json.dumps({"attribution": {k: round(float(v), 4)
                                              for k, v in attr.items()}}))
    finally:
        # flush the async pipeline + detok worker, stop the obs server
        # thread and the profiler — even when the run aborts
        # (EngineOverloadedError under --shed-policy reject, Ctrl-C, a
        # poisoned run), nothing leaks
        llm.close()
        if server is not None:
            server.shutdown()
        if prof is not None:
            prof.stop()
    rep = llm.engine.report()
    mode = ("mha" if args.mha_baseline else "opt-gqa") + \
        (f"+{args.quant}" if args.quant else "") + \
        (f"+kv-{args.kv_cache_dtype}" if args.kv_cache_dtype != "bf16"
         else "")
    print(json.dumps({"mode": mode, **{k: round(float(v), 4)
                                       for k, v in rep.items()}}, indent=1))


def read_output(text: str) -> dict:
    """What ``main`` printed, read back: the request lines (``requests``:
    one dict per line, results or ``--stream`` deltas), the
    ``attribution`` dict (None when no step was timed) and the ``mode``
    line's dict (the last object, printed over several lines)."""
    lines = text.splitlines()
    start = max(i for i, ln in enumerate(lines) if ln == "{")
    requests: List[dict] = []
    attribution = None
    for ln in lines[:start]:
        if not ln.startswith("{"):
            continue                     # the obs endpoint's comment line
        obj = json.loads(ln)
        if "attribution" in obj:
            attribution = obj["attribution"]
        else:
            requests.append(obj)
    return {"requests": requests, "attribution": attribution,
            "mode": json.loads("\n".join(lines[start:]))}


if __name__ == "__main__":
    main()
