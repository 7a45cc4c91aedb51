#!/usr/bin/env python3
"""Compare another checkout's port with this one's, in turns, on one card.

    git archive <commit> | tar -x -C build/other    # any ignored directory
    python3 chip_pair.py build/other
    python3 chip_pair.py --b5 build/other           # the static kernel only
    python3 chip_pair.py --b3 build/other           # the int4 matmul only
    python3 chip_pair.py --scan build/other         # the Mamba-1 scan only
    python3 chip_pair.py --scan-bwd build/other     # the Mamba-1 backward

Each side runs in a process of its own, in the order other, this, this,
other: the kernel checks of ``chip_smoke.py`` (paged decode and chunk
prefill over both pools, static attention, int4 matmul: every case and
shape, with their library yardsticks; the static attention also at head
dims 120, 256 and 80 and at llava's vision wave) and its bf16-chunked and
bf16-whole-prompt serves, each profiled; with ``--b5``, the static
attention's checks alone; with ``--b3``, the int4 matmul's checks at the
shapes of every model ``chip_smoke.py`` serves (qwen2-1.5b with the ragged
check shape, h2o-danube-3-4b, recurrentgemma-2b, falcon-mamba-7b,
llava-next-mistral-7b, hubert-xlarge, command-r-plus-104b); with
``--scan``, falcon-mamba-7b's mixer core (``_ssm_inner``: the two
projections, then the scan with its softplus, D skip and gate, fused or
not as the side has it) at the serve's wave and a decode step, and the
selective scan's own cases (``check_selective_scan``: f32 in and out, the
serve's wave, a ragged wave, decode); with ``--scan-bwd``, the trainer's
Mamba path at [8, 512]: the scan alone's backward (``SelectiveScanFn``
under autograd, its backward alone timed), falcon-mamba's mixer core
(``ops.ssm_scan`` under autograd in bf16 on falcon-mamba's init: its
forward, and its forward and backward; fused or composed as the side has
it) and a 32-layer falcon-mamba train step (``train_family_depth``: step
ms, peak GB, the profiled step's split). Both sides are
built from their own sources but measured by THIS checkout's
``chip_smoke`` functions, so a difference is the code's, not the method's.
Prints one line per side and serve, then each static-attention case's time
on both sides (the mean of a side's two turns) and their ratio (with
``--b3`` each int4 product's, beside this side's bound, library call and
dense bf16 matmul; with ``--scan`` each case's); each side's details go to
``chiprun_out/chip_pair_<turn>_<side>.json``, the static attention's table
to ``chiprun_out/chip_pair_b5.json``, the int4 matmul's to
``chiprun_out/chip_pair_b3.json``, the scan's to
``chiprun_out/chip_pair_scan.json``, the backward's to
``chiprun_out/chip_pair_scan_bwd.json``. Needs one card.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


SERVES = ("bf16-chunked", "bf16-whole-prompt")


def b3_checks(cs) -> tuple:
    """The int4 matmul's checks at every model's shapes, as chip_smoke's
    phases call them."""
    def check(label, shapes, main, library_max_m=8192):
        def run(gen):
            r = cs.check_gptq_matmul(gen, shapes=shapes, main_shape=main,
                                     library_max_m=library_max_m)
            r["label"] = label
            return r
        return run
    return (check("gptq_matmul", cs.GPTQ_SHAPES, ("gate/up", 8), None),
            check("gptq_matmul[danube]", cs.DANUBE_GPTQ_SHAPES,
                  ("gate/up", 8)),
            check("gptq_matmul[rgemma]", cs.RGEMMA_GPTQ_SHAPES, ("up", 8)),
            check("gptq_matmul[mamba]", cs.MAMBA_GPTQ_SHAPES,
                  ("in_proj", 8)),
            check("gptq_matmul[llava]", cs.LLAVA_GPTQ_SHAPES,
                  ("gate/up", 8)),
            check("gptq_matmul[hubert]", cs.HUBERT_GPTQ_SHAPES,
                  ("up", 12000), 16384),
            check("gptq_matmul[cmdr]", cs.CMDR_GPTQ_SHAPES, ("gate/up", 8),
                  None))


# _ssm_inner's cases: (label, rows, width, prompt lengths, from a random
# state), bf16 on falcon-mamba's init as the serve runs it
SSM_INNER_CASES = (("serve wave", 8, 960, "SERVE_LENS", False),
                   ("decode", 8, 1, None, True))


def scan_checks(cs) -> tuple:
    """The selective scan's checks (the scan alone) and falcon-mamba's
    mixer core timed whole, as the side's ``_ssm_inner`` runs it."""
    def inner(gen):
        import torch
        from repro_torch.configs.registry import get_config
        from repro_torch.models import ssm
        cfg = get_config(cs.MAMBA)
        p = ssm.ssm_init(gen, cfg, device="cuda")
        rows = []
        for label, b, width, lens, random_state in SSM_INNER_CASES:
            lens = getattr(cs, lens) if lens else None
            args = cs.mamba_core_inputs(cfg, p, gen, b, width, lens,
                                        "bfloat16", random_state)
            _, _, xc, _, _, z, _, _, h0, mask = args
            with torch.no_grad():
                ms = cs.time_ms(lambda: ssm._ssm_inner(cfg, p, xc, z, h0,
                                                       mask))
            rows.append({"case": f"{label} [{b},{width}]", "ms": ms})
            del args, xc, z, h0, mask
        return {"name": "ssm_inner", "per_case": rows, "ms": rows[0]["ms"],
                "plain_ms": None, "library_ms": None}

    def scan(gen):
        r = cs.check_selective_scan(gen)
        return dict(r, per_case=r["cases"])
    return inner, scan


def scan_bwd_checks(cs) -> tuple:
    """The trainer's Mamba path at [8, 512] as the side runs it: the scan
    alone's backward kernel through its autograd rule, the mixer core's
    forward and forward plus backward under autograd, and a 32-layer
    falcon-mamba train step."""
    def timed_grad(outs, ins, cots):
        import torch
        return cs.time_ms(lambda: torch.autograd.grad(
            outs, ins, cots, retain_graph=True), iters=5)

    def scan(gen):
        import torch
        from repro_torch.kernels import ops
        b, S, din, N = cs.SCAN_BWD_SELECTIVE
        rnd = lambda *sh: torch.randn(sh, generator=gen, device="cuda")
        A = -torch.arange(1, N + 1, dtype=torch.float32,
                          device="cuda").repeat(din, 1)
        dt = torch.rand((b, S, din), generator=gen, device="cuda") * 0.099 \
            + 0.001
        ins = [t.requires_grad_(True) for t in
               (dt, rnd(b, S, din), rnd(b, S, N), rnd(b, S, N), A,
                rnd(b, din, N))]
        outs = ops.selective_scan(*ins)
        ms = timed_grad(outs, ins, (rnd(b, S, din), rnd(b, din, N)))
        return {"name": "selective_scan_bwd", "ms": ms, "plain_ms": None,
                "library_ms": None, "per_case": [
                    {"case": f"SelectiveScanFn backward [{b},{S}] din "
                             f"{din} N {N}", "ms": ms}]}

    def core(gen):
        import torch
        from repro_torch.configs.registry import get_config
        from repro_torch.kernels import ops
        from repro_torch.models import ssm
        cfg = get_config(cs.MAMBA)
        b, S, din, N = cs.SCAN_BWD_SELECTIVE
        p = ssm.ssm_init(gen, cfg, device="cuda")
        args = [t.detach().requires_grad_(True) for t in
                cs.mamba_core_inputs(cfg, p, gen, b, S, None, "bfloat16",
                                     False)[:9]]
        g_out = torch.randn((b, S, din), generator=gen,
                            device="cuda").to(torch.bfloat16)
        fwd = cs.time_ms(lambda: ops.ssm_scan(*args), iters=5)

        def both():
            y, _ = ops.ssm_scan(*args)
            torch.autograd.grad(y, args, g_out)
        rows = [{"case": f"core forward [{b},{S}] bf16", "ms": fwd},
                {"case": f"core forward + backward [{b},{S}] bf16",
                 "ms": cs.time_ms(both, iters=5)}]
        return {"name": "ssm_core", "ms": rows[1]["ms"], "plain_ms": None,
                "library_ms": None, "per_case": rows}

    def step(gen):
        import torch
        from repro_torch.kernels import ops
        torch.cuda.empty_cache()
        run = cs.train_family_depth(cs.MAMBA, ops.KERNELS)
        prof = run["profile"]
        keep = ("device_ms", "device_busy_ms", "wall_ms", "adamw_ms",
                "ssm_core_forward_ms", "device_idle_share")
        return {"name": "train_mamba", "ms": run["step_ms"],
                "plain_ms": None, "library_ms": None,
                "step": {"step_ms": run["step_ms"],
                         "peak_gb": run["peak_gb"],
                         "launches": run["launches"],
                         "profile": {k: prof.get(k) for k in keep}},
                "per_case": [{"case": f"falcon-mamba-7b "
                              f"{cs.TRAIN_FAMILY_DEPTH[cs.MAMBA]} layers, "
                              f"[{cs.TRAIN_BATCH},{cs.TRAIN_SEQ}] step",
                              "ms": run["step_ms"]}]}
    return scan, core, step


def side(src: str, only: str = "") -> dict:
    """This process's measurements of the port under ``src`` (``only``
    "--b5" or "--b3": that kernel's checks alone)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs                   # puts ROOT/src on the path
    sys.path.insert(0, src)                   # the side's package wins
    import torch
    from repro_torch.kernels import build, ops
    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"src": src, "card": torch.cuda.get_device_name(0)}
    b5 = (cs.check_flash_attention, cs.check_flash_attention_d120,
          cs.check_flash_attention_d256, cs.check_flash_attention_d80,
          cs.check_flash_attention_vision)
    others = (cs.check_paged_attention, cs.check_paged_attention_quant,
              cs.check_flash_attention_chunk,
              cs.check_flash_attention_chunk_int8, cs.check_gptq_matmul)
    checks = {"--b5": b5, "--b3": b3_checks(cs),
              "--scan": scan_checks(cs),
              "--scan-bwd": scan_bwd_checks(cs)}.get(only, b5 + others)
    for check in checks:
        r = check(gen)
        key = r.get("label", r["name"])
        out[key] = r.get("per_case") or r["per_shape"]
        out[key + ":main"] = {"ms": r["ms"], "plain_ms": r["plain_ms"],
                              "library_ms": r["library_ms"]}
        if "step" in r:
            out[key + ":step"] = r["step"]
        torch.cuda.empty_cache()
    if only:
        return out
    # the two synchronous serves (cs.SYNC), like for like with trees
    # whose engine had no async step
    for label, options, must, never in (cs.SERVES[0], cs.SERVES[2]):
        sv = cs.phase_serve("cuda", kernels=ops.KERNELS, label=label,
                            options=options, must=must, never=never,
                            profile=True)
        sv.pop("tokens")
        out[label] = sv
    return out


def b5_table(runs, prefixes=("flash_attention",)) -> list:
    """Each static-attention case's time on both sides (or the cases of
    the checks whose names start with one of ``prefixes``): (check, case,
    other ms, this ms, other / this), a side's ms the mean of its turns."""
    ms = {}
    for tag, r in runs:
        for key, rows in r.items():
            if key.startswith(prefixes) and ":" not in key \
                    and not key.startswith("flash_attention_chunk"):
                for row in rows:
                    ms.setdefault((key, row["case"]), {}).setdefault(
                        tag, []).append(row["ms"])
    table = []
    for (key, case), t in ms.items():
        other = sum(t["other"]) / len(t["other"])
        this = sum(t["this"]) / len(t["this"])
        table.append((key, case, other, this, other / this))
    return table


def b3_table(runs) -> list:
    """Each int4 product's time on both sides: (check, linear, M, other
    ms, this ms, other / this, this side's bound ms, library ms, dense
    bf16 matmul ms), a side's ms the mean of its turns."""
    ms, this_row = {}, {}
    for tag, r in runs:
        for key, rows in r.items():
            if key.startswith("gptq_matmul") and ":" not in key:
                for row in rows:
                    k = (key, row["linear"], row["M"])
                    ms.setdefault(k, {}).setdefault(tag, []).append(row["ms"])
                    if tag == "this":
                        this_row[k] = row
    table = []
    for k, t in ms.items():
        other = sum(t["other"]) / len(t["other"])
        this = sum(t["this"]) / len(t["this"])
        row = this_row[k]
        table.append((*k, other, this, other / this, row["bound"][0],
                      row["library_ms"], row["dense_bf16_matmul_ms"]))
    return table


def main() -> int:
    if sys.argv[1:2] == ["--side"]:
        Path(sys.argv[3]).write_text(json.dumps(
            side(sys.argv[2], only=(sys.argv[4:5] or [""])[0])))
        return 0
    import torch
    args = sys.argv[1:]
    only = args[0] if args[:1] in (["--b5"], ["--b3"], ["--scan"],
                                   ["--scan-bwd"]) else ""
    b5_only = only != ""
    args = args[1:] if only else args
    if len(args) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    sides = {"other": str(Path(args[0]).resolve() / "src"),
             "this": str(ROOT / "src")}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    runs = []
    for i, tag in enumerate(("other", "this", "this", "other")):
        res = out / f"chip_pair_{i}_{tag}.json"
        subprocess.run([sys.executable, __file__, "--side", sides[tag],
                        str(res)] + ([only] if only else []),
                       check=True, timeout=900)
        runs.append((tag, json.loads(res.read_text())))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else runs[0][1]["card"]
    print(f"[pair] card: {card}", flush=True)
    if only == "--b3":
        table = b3_table(runs)
        (out / "chip_pair_b3.json").write_text(json.dumps(
            {"card": card, "rows": table}, indent=1))
        for key, lin, M, other, this, ratio, bound, lib, dense in table:
            print(f"[pair] {key} {lin} M={M}: other_ms={other:.4f} "
                  f"this_ms={this:.4f} other/this={ratio:.3f} "
                  f"bound_ms={bound:.4f} library_ms="
                  + ("null" if lib is None else f"{lib:.4f}")
                  + f" dense_bf16_ms={dense:.4f}", flush=True)
        return 0
    if only == "--scan-bwd":
        table = b5_table(runs, ("selective_scan_bwd", "ssm_core",
                                "train_mamba"))
        steps = [(tag, r["train_mamba:step"]) for tag, r in runs]
        (out / "chip_pair_scan_bwd.json").write_text(json.dumps(
            {"card": card, "cases": table, "steps": steps}, indent=1))
        for key, case, other, this, ratio in table:
            print(f"[pair] {key} {case}: other_ms={other:.4f} this_ms="
                  f"{this:.4f} other/this={ratio:.3f}", flush=True)
        for tag, st in steps:
            print(f"[pair] {tag} train step: {json.dumps(st)}", flush=True)
        return 0
    if only == "--scan":
        table = b5_table(runs, ("selective_scan", "ssm_inner"))
        (out / "chip_pair_scan.json").write_text(json.dumps(
            {"card": card, "cases": table}, indent=1))
        for key, case, other, this, ratio in table:
            print(f"[pair] {key} {case}: other_ms={other:.4f} this_ms="
                  f"{this:.4f} other/this={ratio:.3f}", flush=True)
        return 0
    table = b5_table(runs)
    (out / "chip_pair_b5.json").write_text(json.dumps(
        {"card": runs[0][1]["card"], "cases": table}, indent=1))
    for key, case, other, this, ratio in table:
        print(f"[pair] {key} {case}: other_ms={other:.4f} this_ms="
              f"{this:.4f} other/this={ratio:.3f}", flush=True)
    for tag, r in runs:
        mains = {k.split(":")[0]: round(v["ms"], 4) for k, v in r.items()
                 if k.endswith(":main")}
        print(f"[pair] {tag} kernels ms: {json.dumps(mains)}", flush=True)
        for label in () if b5_only else SERVES:
            sv, p = r[label], r[label]["profile"]
            print(f"[pair] {tag} {label}: wall_s={sv['wall_s']:.3f} "
                  f"gen_tok_s={sv['gen_tok_s']:.1f} "
                  f"step_ms={sv['mean_step_ms']:.1f} "
                  f"device_busy_ms={p['device_busy_ms']:.1f} "
                  f"idle_share={p['device_idle_share']:.3f} "
                  f"ours_ms={json.dumps(p['ours_ms'])} "
                  f"launches={json.dumps(sv['launches'])}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
