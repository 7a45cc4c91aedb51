#!/usr/bin/env python3
"""Time ``gptq_matmul``'s bf16 bodies under other plans than the planner's,
on one card.

    python3 chip_b3_plans.py

For each product of CASES (qwen2-1.5b's and command-r-plus-104b's int4
linears at decode, a chunk and a wave) it times the planner's own plan,
then the same call with the token tile, the split of K or the ring's
stages replaced (``kernels/gptq_matmul.plan`` is what the wrapper asks
through ``GptqMatmul.plan_for``), each within ``chip_smoke.TOL`` of the
plain version and bitwise equal on repeat.  Times are ``chip_smoke.
time_ms`` (device time, cold L2): the mean of 10 runs and the least of 5
single runs.  These are the sweeps the planner's cost model
(``TILE_US``, ``FIX_US``, ``LONG_SPLIT``) was fitted to.  One JSON line a
plan goes to ``chiprun_out/b3_plans.jsonl``; needs one card.
"""
from __future__ import annotations

import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# (label, K, N, group size, M, plan changes to time besides the planner's)
CASES = [
    ("wk/wv", 1536, 256, 32, 8, [{"splits": s} for s in (1, 2, 4, 8, 12)]),
    ("wq/wo", 1536, 1536, 32, 8, [{"splits": s} for s in (1, 2, 4, 6, 8)]),
    ("gate/up", 1536, 8960, 32, 8, [{"splits": s} for s in (1, 2, 3, 4, 6)]),
    ("down", 8960, 1536, 32, 8, [{"splits": s} for s in (4, 8, 12, 16)]),
    ("wk/wv", 1536, 256, 32, 64,
     [{"tile": t, "splits": s} for t in (16, 64) for s in (2, 4, 8)]),
    ("wq/wo", 1536, 1536, 32, 256,
     [{"tile": t, "splits": s} for t in (64, 256) for s in (1, 2, 4)]),
    ("gate/up", 1536, 8960, 32, 256, [{"tile": 256, "splits": s}
                                      for s in (1, 2)]),
    ("down", 8960, 1536, 32, 256, [{"tile": t, "splits": s}
                                   for t in (128, 256) for s in (1, 4, 7)]),
    ("gate/up", 1536, 8960, 32, 7680, [{"tile": t} for t in (128, 256)]),
    ("cmdr gate/up", 12288, 33792, 128, 8,
     [{"splits": 2}] + [{"stages": s} for s in (4, 8)]),
    ("cmdr down", 33792, 12288, 128, 8, [{"splits": s} for s in (2, 3, 4)]),
    ("cmdr down", 33792, 12288, 128, 256, [{"tile": 256, "splits": s}
                                           for s in (1, 2, 4)]),
]


def _replan(G, p, K, change):
    """``p`` with the token tile, splits or stages of ``change``."""
    kt = math.ceil(K / G.BK)
    if "tile" in change:
        p = p._replace(tile=change["tile"], bm=change["tile"])
    if "splits" in change:
        kt_per = math.ceil(kt / change["splits"])
        p = p._replace(kt_per=kt_per, splits=math.ceil(kt / kt_per))
    per_sm = 2 if p.tile <= 32 else 1
    stages = change.get("stages", G.MAX_STAGES)
    return p._replace(stages=max(1, min(
        stages, p.kt_per, G.RING_BUDGET[per_sm] // G.stage_bytes(p.tile,
                                                                  p.sr))))


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs                   # puts ROOT/src on the path
    import torch
    if not torch.cuda.is_available():
        print("chip_b3_plans: torch.cuda.is_available() is False; this "
              "script times the port on an NVIDIA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import gptq_matmul as G
    build.build_all()
    gm = G.gptq_matmul
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    lines = out / "b3_plans.jsonl"
    lines.write_text("")
    planner = gm.plan_for
    for label, K, N, gs, M, changes in CASES:
        qw = torch.randint(-2 ** 31, 2 ** 31 - 1, (K // 8, N), generator=gen,
                           device="cuda", dtype=torch.int64).int()
        sc = torch.rand((K // gs, N), generator=gen, device="cuda") * 0.01
        zr = torch.rand((K // gs, N), generator=gen, device="cuda") * 15
        x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
        want = ref.gptq_matmul_ref(x, qw, sc, zr).float()
        base = planner(x, N, gs)
        for change in [{}] + changes:
            p = _replan(G, base, K, change) if change else base
            gm.plan_for = lambda *_, p=p: p
            try:
                y = gm(x, qw, sc, zr)
                again = gm(x, qw, sc, zr)
                torch.cuda.synchronize()
                err = ((y.float() - want).abs().max()
                       / want.abs().max()).item()
                if err > cs.TOL or not torch.equal(y, again):
                    raise AssertionError(f"{label} M={M} {change}: rel err "
                                         f"{err}, repeat "
                                         f"{torch.equal(y, again)}")
                row = {"linear": label, "M": M, "K": K, "N": N, "gs": gs,
                       "change": change, "plan": p._asdict(),
                       "ms": cs.time_ms(lambda: gm(x, qw, sc, zr)),
                       "min_ms": min(cs.time_ms(lambda: gm(x, qw, sc, zr),
                                                iters=1) for _ in range(5)),
                       "rel_err": err}
            finally:
                gm.plan_for = planner
            cs.log(f"[b3 plan] {label} M={M} {json.dumps(change)}: tile "
                   f"{p.tile} splits {p.splits} stages {p.stages}: "
                   f"{row['ms']:.4f} ms (least {row['min_ms']:.4f})")
            with lines.open("a") as f:
                f.write(json.dumps(row) + "\n")
        del qw, sc, zr, x, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
