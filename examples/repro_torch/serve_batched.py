"""End-to-end streamed serving on the port: continuous request intake
under preemption pressure, consuming ``RequestOutput`` deltas as horizons
complete; the counterpart of ``examples/serve_batched.py``.

Requests are added *while* the stream is being consumed (Poisson-ish
arrivals), each with its own ``SamplingParams`` — greedy, temperature and
top-p requests share every batch.  Ends with the engine's metric report.

    PYTHONPATH=src python examples/repro_torch/serve_batched.py \
        [--requests 24] [--max-waiting 8 --shed-policy shed-oldest] \
        [--deadline-ms 5000] [--device cpu]

On the card (``--device cuda``, the default; raises on a host without
one) ``--arch`` defaults to qwen2-1.5b at full width cut to 4 layers
(head dim 128; the reduced configs' head dim 16 is not one the bf16
tensor-core kernels are built for): the serve launches
``paged_attention`` and ``flash_attention_chunk``.  On the CPU (the
plain path) it serves the JAX example's config: reduced qwen1.5-0.5b, 4
layers.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from repro_torch import resolve_device
from repro_torch.serving import EngineOverloadedError, LLM, SamplingParams


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--arch", default=None,
                    help="default: qwen2-1.5b (full width) on the card, "
                         "qwen1.5-0.5b (reduced) on the CPU")
    ap.add_argument("--blocks", type=int, default=96,
                    help="small pool => exercises preemption")
    ap.add_argument("--max-waiting", type=int, default=None,
                    help="bound the waiting queue (load shedding)")
    ap.add_argument("--shed-policy", choices=("reject", "shed-oldest"),
                    default="reject",
                    help="what to do when the waiting queue is full")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request end-to-end deadline (finish_reason"
                         "='deadline' on expiry)")
    ap.add_argument("--device", default="cuda",
                    help="the card (default) or 'cpu' for the plain path")
    return ap


def run(args: argparse.Namespace) -> dict:
    """Serve ``args.requests`` streamed requests; returns the stream's
    counts, each request's tokens and finish reason, and the report."""
    card = resolve_device(args.device).type == "cuda"
    arch = args.arch or ("qwen2-1.5b" if card else "qwen1.5-0.5b")
    llm = LLM.load(arch, reduced=not card, overrides=dict(num_layers=4),
                   max_slots=6, num_blocks=args.blocks,
                   max_blocks_per_seq=12, prefill_bucket=32,
                   max_waiting=args.max_waiting,
                   shed_policy=args.shed_policy, device=args.device)
    eng = llm.engine

    rng = np.random.default_rng(0)
    prefix = list(rng.integers(1, 200, 24))

    def make_request(i):
        prompt = prefix + list(rng.integers(1, 200, int(rng.integers(4, 40))))
        sp = SamplingParams(
            temperature=0.7 if i % 3 == 0 else 0.0,
            top_p=0.9 if i % 3 == 0 else 1.0,
            max_tokens=int(rng.integers(4, 16)),
            deadline_ms=args.deadline_ms)
        return prompt, sp

    rejected = 0

    def submit(req):
        nonlocal rejected
        try:
            eng.add(*req)
        except EngineOverloadedError:
            rejected += 1     # --shed-policy reject with a full queue

    # seed the engine with a couple of requests, then keep adding while
    # consuming the stream — continuous intake, no drain barrier
    pending = [make_request(i) for i in range(args.requests)]
    for _ in range(2):
        if pending:
            submit(pending.pop(0))

    events = finished = 0
    first_tokens_seen = 0
    final = {}
    for out in eng.stream():
        events += 1
        if len(out.token_ids) == len(out.new_token_ids):
            first_tokens_seen += 1
        if out.finished:
            finished += 1
            final[out.request_id] = (list(out.token_ids), out.finish_reason)
        # Poisson-ish arrivals: ~1 new request per streamed event
        if pending:
            submit(pending.pop(0))
        if events % 20 == 0:
            print(f"event {events}: running={len(eng.running)} "
                  f"waiting={len(eng.waiting)} done={finished} "
                  f"pool_util={eng.alloc.utilization():.2f}")

    print(f"\n{events} streamed events, {finished} finished "
          f"({first_tokens_seen} first-token events before any drain, "
          f"{rejected} rejected at intake)")
    rep = eng.report()
    print("final report:")
    for k, v in rep.items():
        print(f"  {k:22s} {v}")
    llm.close()
    return {"config": llm.cfg.name, "layers": llm.cfg.num_layers,
            "events": events, "finished": finished,
            "first_tokens_seen": first_tokens_seen, "rejected": rejected,
            "tokens": {r: t for r, (t, _) in sorted(final.items())},
            "finish_reasons": {r: f for r, (_, f) in sorted(final.items())},
            "report": rep}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    return run(_parser().parse_args(argv))


if __name__ == "__main__":
    main()
