#!/usr/bin/env python3
"""Plant faults that ``chip_smoke.py``'s checks must catch, on one card.

    python3 chip_faults.py

Reads what four of ``chip_smoke``'s checks measure, first on the sound
port, then with a fault planted, and holds each reading to the check's
own limit:

- the static attention kernel's cases (phases 2 and 7): the largest
  absolute error (``TOL``) and the largest error of a query row over
  that row's RMS (``FLASH_REL_TOL``).  Each fault is planted in a copy of
  the port's sources under a temporary directory, built there and
  checked in a process of its own: the band skips its first key tile
  (``k_begin`` one tile late), or its edge tiles go unmasked;
- the int4 matmul's shapes (phase 2, ``check_gptq_matmul``): every
  output within ``TOL`` of the plain version.  Each fault is planted in
  a copy of ``gptq_matmul.cu`` the same way: a group boundary inside a k
  tile keeps the previous group's scale and zero, or the two codes of
  each bf16 pair of an A fragment swap places;
- the Mamba-1 selective scan's checks (phase 9, ``check_ssm_scan``, the
  fused entry, and ``check_selective_scan``, the scan alone): each output
  within its limit of the plain version.  Each fault is planted in a copy
  of ``time_scan.cu`` the same way: the D skip dropped from the fused
  entry's gate, one lane's states (the last lane of each channel) left
  out of y, or C read from the step before inside a staged tile (a fault
  only a wave can show).  Each names the fused check's cases that must
  fail it (and those that must not);
- the Mamba-1 backward's checks (phase 14 (f), ``check_scan_backward``:
  the scan alone's and the fused core's backward against their plain
  versions, and the recomputed h_t bitwise the forward's).  Each fault is
  planted in a copy of ``time_scan.cu``: the checkpoint read one tile
  off, or e_{t+1} where e_t belongs in the gA and gdt terms;
- the full-depth h2o-danube-3-4b serve (``serve_ring``): every served
  token against teacher forcing, the share equal
  (``TEACHER_AGREEMENT``) and the teacher's largest logit gap to a
  served token (``TEACHER_GAP``).  Each fault is planted in this process
  by replacing the ring decode: V read one slot off, the window halved,
  or the new token written one slot ahead (its own slot stale).

Prints each reading beside its limit and exits 0 only if the sound port
passes every limit and every planted fault fails at least one.  Details
go to ``chiprun_out/chip_faults.json``.  Needs one card.

    python3 chip_faults.py --scan-bwd

reads the Mamba-1 backward's sound port and its two faults alone.

    python3 chip_faults.py --scan-bwd-variants [name ...]

times the scan alone's backward as it is and with each ablation of
SCAN_BWD_VARIANTS (a part of the kernel left out: not a fault, a cost)
planted the same way, and writes ``chiprun_out/chip_faults_variants.json``.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FLASH_CU = "kernels/csrc/flash_attention.cu"
GPTQ_CU = "kernels/csrc/gptq_matmul.cu"
SCAN_CU = "kernels/csrc/time_scan.cu"
# (name, text of flash_attention.cu's tensor-core kernel, its replacement)
KERNEL_FAULTS = (
    ("band skips its first key tile",
     "max(0, q_lo - window + 1) / T::BK * T::BK : 0",
     "max(0, q_lo - window + 1) / T::BK * T::BK + "
     "(q_lo - window + 1 > 0 ? T::BK : 0) : 0"),
    ("band edge tiles unmasked",
     "(window > 0 && k0 < w_hi - window + 1)",
     "(window > 0 && k0 < w_hi - window + 1 - T::BK)"),
)
# (name, text of gptq_matmul.cu's wgmma body, its replacement)
GPTQ_FAULTS = (
    ("group boundary keeps the previous scale",
     "load_sz(ss, zs, cur - g_lo);",
     "load_sz(ss, zs, cur - g_lo - 1);"),
    ("nibble pair swapped",
     "lo = (b & 0x000F000Fu) | MAGIC;\n  hi = ((b >> 4) & 0x000F000Fu) | MAGIC;",
     "hi = (b & 0x000F000Fu) | MAGIC;\n  lo = ((b >> 4) & 0x000F000Fu) | MAGIC;"),
)


# (name, text of time_scan.cu's selective-scan body, its replacement,
# the fused check's cases (MAMBA_FUSED_CASES labels) that must fail, those
# that must pass)
SCAN_FAULTS = (
    ("D skip dropped from the gate",
     "round_to<T>(__fadd_rn(round_to<T>(y), skip))",
     "round_to<T>(y)",
     ("serve wave", "serve wave f32"), ()),
    ("one lane's states left out of y",
     "f_part[tt * THREADS + tid] = acc;",
     "f_part[tt * THREADS + tid] = l == LANES - 1 ? 0.f : acc;",
     ("ragged wave from a random state", "decode",
      "single prompt, B and C scaled",
      "serve wave f32, memory-carrying init"), ()),
    # acts only inside a staged tile (tt > 0): decode's one-step tile
    # cannot see it, the waves must
    ("C read from the step before within a tile",
     "load_states<NS>(f_bc + tt * 2 * N_STATE + N_STATE + l * NS, cv);",
     "load_states<NS>(f_bc + (tt > 0 ? tt - 1 : 0) * 2 * N_STATE + N_STATE"
     " + l * NS, cv);",
     ("ragged wave from a random state",
      "single prompt, B and C scaled",
      "serve wave f32, memory-carrying init"), ("decode",)),
)


# (name, text of time_scan.cu's backward body, its replacement): each must
# fail ``check_scan_backward``
SCAN_BWD_FAULTS = (
    ("checkpoint read one tile off",
     "const float* ck = p.ck + ((long long)b * ntiles + k) * din * N_STATE",
     "const float* ck = p.ck + ((long long)b * ntiles + (k > 0 ? k - 1 : k))"
     " * din * N_STATE"),
    ("e_{t+1} in the gA and gdt terms",
     "        const float q = le * hp[tt][j];",
     "        const float q = lam[j] * decay(f_sc[(tt < TT - 1 ? tt + 1 : tt)"
     " * CH + c].x, a2[j]) * hp[tt][j];"),
)

# (not faults) name -> [(text of time_scan.cu's backward body, its
# replacement)]: what each ablation of ``--scan-bwd-variants`` leaves out
# of the kernel, to time what that part costs (its gradients are wrong)
SCAN_BWD_VARIANTS = {
    # the step back's second exponential (e_t recomputed) replaced by its
    # argument
    "no_second_exp": [
        ("        const float e = decay(sc.x, a2[j]);\n",
         "        const float e = fmaf(sc.x, a2[j], 1.f);\n")],
    # the recompute's exponential replaced by dt
    "no_recompute_exp": [
        ("        h[j] = fmaf(decay(sc.x, a2[j]), h[j], sc.y * bb[j]);",
         "        h[j] = fmaf(sc.x, h[j], sc.y * bb[j]);")],
    # the step back's shuffled sums (sum_n over the lanes, gC / gB over
    # the warp's channels) replaced by sums in the thread
    "no_reductions": [
        ("      float r[2] = {sb, sq};\n      scatter_level<1, 1>(r, lane);\n"
         "      r[0] += __shfl_xor_sync(0xffffffffu, r[0], 2);\n"
         "      if (l < 2) f_sq[(tt * CH + c) * 2 + l] = r[0];\n",
         "      if (l < 2) f_sq[(tt * CH + c) * 2 + l] = sb + sq;\n"),
        ("      scatter_level<16, 4>(v, lane);\n      scatter_level<8, 2>(v, "
         "lane);\n      scatter_level<4, 1>(v, lane);\n",
         "      v[0] = ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + "
         "(v[6] + v[7]));\n")],
    # no step back at all
    "no_step_back": [
        ("#pragma unroll\n    for (int tt = TT - 1; tt >= 0; --tt) {\n"
         "      const float4 sc = f_sc[tt * CH + c];   // dt, dt u, gy\n",
         "#pragma unroll\n    for (int tt = TT - 1; tt >= 0 && k < -5; --tt) "
         "{\n      const float4 sc = f_sc[tt * CH + c];   // dt, dt u, gy\n")],
    # no per-tile outputs (gu, gdt)
    "no_write_out": [("    write_out(k, buf);\n",
                      "    if (k < -5) write_out(k, buf);\n")],
    # no gC / gB partials and no arrivals
    "no_gcb": [("  auto write_bc = [&](int k) {\n",
                "  auto write_bc = [&](int k) {\n    if (k >= -1) return;\n")],
}


def flash_readings(src=None) -> dict:
    """{check: [(case, max abs err, max row-relative err)]} of the static
    kernel's checks, with their limits lifted, for the port under
    ``src`` (this checkout's when None)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs                   # puts ROOT/src on the path
    if src is not None:
        sys.path.insert(0, src)               # the planted copy wins
    import torch
    from repro_torch.kernels import build
    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.TOL = cs.FLASH_REL_TOL = float("inf")
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for check in (cs.check_flash_attention, cs.check_flash_attention_d120):
        r = check(gen)
        out[r.get("label", r["name"])] = [
            (c["case"], c["max_abs_err"], c["max_row_rel_err"])
            for c in r["per_case"]]
        torch.cuda.empty_cache()
    return out


def gptq_readings(src=None) -> dict:
    """The int4 matmul's check at qwen2-1.5b's shapes for the port under
    ``src`` (this checkout's when None), at its own limit: {"fails": the
    check's message if it failed, else None, "rows": (linear, M, max err
    over max |ref|) of the rows it passed}."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs                   # puts ROOT/src on the path
    if src is not None:
        sys.path.insert(0, src)               # the planted copy wins
    import torch
    from repro_torch.kernels import build
    build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, fails = [], None
    log = cs.log
    cs.log = lambda msg: (rows.append(msg), log(msg))
    try:
        cs.check_gptq_matmul(gen)
    except AssertionError as e:
        fails = str(e)
    finally:
        cs.log = log
    return {"fails": fails, "rows": rows}


def scan_readings(src=None) -> dict:
    """The selective scan's checks (the fused entry's, then the scan
    alone's) for the port under ``src`` (this checkout's when None), at
    their own limits: {check: its message if it failed, else None}."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs                   # puts ROOT/src on the path
    if src is not None:
        sys.path.insert(0, src)               # the planted copy wins
    import torch
    from repro_torch.kernels import build
    build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for check in (cs.check_ssm_scan, cs.check_selective_scan):
        try:
            check(gen)
            out[check.__name__] = None
        except AssertionError as e:
            out[check.__name__] = str(e)
        torch.cuda.empty_cache()
    return out


def scan_bwd_readings(src=None) -> dict:
    """Phase 14 (f)'s backward checks for the port under ``src`` (this
    checkout's when None), at their own limits: {"check_scan_backward":
    its message if it failed, else None}."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs                   # puts ROOT/src on the path
    if src is not None:
        sys.path.insert(0, src)               # the planted copy wins
    import torch
    from repro_torch.kernels import build
    build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    try:
        cs.check_scan_backward(gen)
        return {"check_scan_backward": None}
    except AssertionError as e:
        return {"check_scan_backward": str(e)}


def scan_bwd_timing(src=None) -> dict:
    """The scan alone's ``selective_scan_bwd`` for the port under ``src``
    (this checkout's when None) at falcon-mamba's trainer shape from a
    random state: its time and its outputs' largest error over their RMS
    against ``ref.selective_scan_bwd_ref``."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs                   # puts ROOT/src on the path
    if src is not None:
        sys.path.insert(0, src)               # the planted copy wins
    import torch
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.time_scan import selective_scan
    build.build_all()
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    b, S, din, N = cs.SCAN_BWD_SELECTIVE
    A = -torch.arange(1, N + 1, dtype=torch.float32,
                      device=dev).repeat(din, 1)
    dt = torch.rand((b, S, din), generator=gen, device=dev) * 0.099 + 0.001
    u, Bm, Cm = rnd(b, S, din), rnd(b, S, N), rnd(b, S, N)
    h0, gy, ghl = rnd(b, din, N), rnd(b, S, din), rnd(b, din, N)
    _, _, ck = selective_scan(dt, u, Bm, Cm, A, h0, checkpoints=True)
    call = lambda: selective_scan.backward(dt, u, Bm, Cm, A, ck, gy, ghl)
    got = call()
    want = ref.selective_scan_bwd_ref(dt, u, Bm, Cm, A, h0, gy, ghl)
    rel = max(((g - w).abs().max() / w.pow(2).mean().sqrt()).item()
              for g, w in zip(got, want))
    return {"ms": cs.time_ms(call, iters=5), "max_rel_err": rel}


def scan_bwd_variants(names) -> int:
    """Time the port as it is ("base") and each of ``names`` (all of
    SCAN_BWD_VARIANTS when empty) through ``planted_kernel``; one line a
    variant and ``chiprun_out/chip_faults_variants.json``."""
    import chip_smoke as cs
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    out = {"card": smi.stdout.strip()}
    cs.log(f"[variants] card: {out['card']}")
    for name in ["base", *(names or SCAN_BWD_VARIANTS)]:
        out[name] = planted_kernel(name, SCAN_BWD_VARIANTS.get(name, ()),
                                   SCAN_CU, "--scan-bwd-timing")
        cs.log(f"[variants] {name}: {json.dumps(out[name])}")
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "chip_faults_variants.json").write_text(
        json.dumps(out, indent=1))
    return 0


def scan_bwd_faults(report: dict, bad: list) -> None:
    """The sound port passes ``check_scan_backward`` and each of
    SCAN_BWD_FAULTS fails it."""
    import chip_smoke as cs
    bwd = report["selective_scan_bwd"] = {"sound": scan_bwd_readings()}
    for name, old, new in SCAN_BWD_FAULTS:
        bwd[name] = planted_kernel(name, [(old, new)], SCAN_CU,
                                   "--scan-bwd-readings")
    for name, r in bwd.items():
        msg = r["check_scan_backward"]
        cs.log(f"[scan_bwd] {name}: "
               + ("passes every limit" if msg is None else f"fails: {msg}"))
        if (name == "sound") != (msg is None):
            bad.append(f"selective_scan_bwd {name}: "
                       + (msg or "nothing fails"))


def flash_fails(readings: dict, tol: float, rel_tol: float) -> list:
    return [f"{check}: {case}" for check, rows in readings.items()
            for case, err, rel in rows if not (err <= tol and rel <= rel_tol)]


def planted_kernel(name: str, edits, source: str = FLASH_CU,
                   readings: str = "--flash-readings") -> dict:
    """Build a copy of the port with each ``(old, new)`` of ``edits``
    replaced in the kernel ``source`` and read its checks (``readings``)
    in a process of its own."""
    with tempfile.TemporaryDirectory() as tmp:
        pkg = Path(tmp) / "src" / "repro_torch"
        shutil.copytree(ROOT / "src" / "repro_torch", pkg,
                        ignore=shutil.ignore_patterns("__pycache__"))
        cu = pkg / source
        text = cu.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"fault {name!r}: its text occurs "
                                   f"{text.count(old)} times in {source}")
            text = text.replace(old, new)
        cu.write_text(text)
        proc = subprocess.run(
            [sys.executable, __file__, readings, str(pkg.parent)],
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"fault {name!r}: {proc.stderr[-3000:]}")
        return json.loads(proc.stdout.strip().splitlines()[-1])


def _ring_faults():
    """name -> a replacement of ``attention._ring_cache_attend``: the sound
    one with one of the module functions it calls swapped while it runs."""
    import torch
    from repro_torch.models import attention as A
    sound = A._ring_cache_attend

    def swapped(name, fault):
        def attend(*args):
            real = getattr(A, name)
            setattr(A, name, fault(real))
            try:
                return sound(*args)
            finally:
                setattr(A, name, real)
        return attend

    def v_off_by_one(real):
        return lambda q, kc, vc, valid: real(q, kc, torch.roll(vc, 1, dims=1),
                                             valid)

    def write_ahead(real):
        # the new token lands one slot ahead: its own slot stays stale
        def write(pool, layer, x, bt, pos):
            ring = bt.shape[1] * pool.shape[2]
            return real(pool, layer, x, bt,
                        torch.where(pos >= 0, (pos + 1) % ring, pos))
        return write

    def half_window(q, k, v, cache, bt, seq_lens, layer, win):
        return sound(q, k, v, cache, bt, seq_lens, layer, win // 2)

    return A, sound, {
        "ring reads V one slot off": swapped("_ring_attention", v_off_by_one),
        "ring window halved": half_window,
        "ring's newest slot stale": swapped("write_decode_kv", write_ahead)}


def serve_readings() -> dict:
    """The danube serve's teacher-forced readings, sound and under each
    planted ring fault (the same load, the same requests)."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import ops
    from repro_torch.serving import SamplingParams
    llm, serve, tf = cs.serve_ring(ops.KERNELS)
    out = {"sound": tf}
    prompts = cs.serve_prompts(llm.cfg.vocab_size, cs.DANUBE_LENS)
    sps = [SamplingParams(max_tokens=m) for m in cs.DANUBE_MAX_TOKENS]
    A, sound, faults = _ring_faults()
    for name, fault in faults.items():
        # a captured megastep replays the ring code it was captured with:
        # release the graphs, so the faulty one is captured, and after it
        llm.engine.runner.close()
        A._ring_cache_attend = fault
        try:
            toks = [o.token_ids for o in llm.generate(prompts, sps)]
        finally:
            A._ring_cache_attend = sound
            llm.engine.runner.close()
        out[name] = cs.teacher_forced(llm, prompts, toks)
    llm.close()
    del llm
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--flash-readings":
        print(json.dumps(flash_readings(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--gptq-readings":
        print(json.dumps(gptq_readings(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--scan-readings":
        print(json.dumps(scan_readings(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--scan-bwd-readings":
        print(json.dumps(scan_bwd_readings(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--scan-bwd-timing":
        print(json.dumps(scan_bwd_timing(sys.argv[2])), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_faults: torch.cuda.is_available() is False; this script "
              "runs the port on an NVIDIA card", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    if sys.argv[1:] == ["--scan-bwd"]:
        report, bad = {}, []
        scan_bwd_faults(report, bad)
        return finish(report, bad, t0)
    if sys.argv[1:2] == ["--scan-bwd-variants"]:
        return scan_bwd_variants(sys.argv[2:])
    tol, rel_tol = cs.TOL, cs.FLASH_REL_TOL
    report, bad = {"limits": {"TOL": tol, "FLASH_REL_TOL": rel_tol,
                              "TEACHER_AGREEMENT": cs.TEACHER_AGREEMENT,
                              "TEACHER_GAP": cs.TEACHER_GAP}}, []
    flash = report["flash_attention"] = {"sound": flash_readings()}
    for name, old, new in KERNEL_FAULTS:
        flash[name] = planted_kernel(name, [(old, new)])
    cs.TOL, cs.FLASH_REL_TOL = tol, rel_tol
    for name, readings in flash.items():
        fails = flash_fails(readings, tol, rel_tol)
        for check, rows in readings.items():
            for case, err, rel in rows:
                cs.log(f"[flash] {name}: {check} {case}: max_abs_err="
                       f"{err:.4e} (tol {tol}) max_row_rel_err={rel:.4e} "
                       f"(tol {rel_tol})")
        cs.log(f"[flash] {name}: {len(fails)} cases fail")
        if (name == "sound") != (not fails):
            bad.append(f"{name}: {fails if fails else 'nothing fails'}")
    gptq = report["gptq_matmul"] = {"sound": gptq_readings()}
    for name, old, new in GPTQ_FAULTS:
        gptq[name] = planted_kernel(name, [(old, new)], GPTQ_CU,
                                    "--gptq-readings")
    for name, r in gptq.items():
        cs.log(f"[gptq] {name}: "
               + ("passes TOL" if r["fails"] is None
                  else f"fails: {r['fails']}"))
        if (name == "sound") != (r["fails"] is None):
            bad.append(f"gptq_matmul {name}: "
                       + (r["fails"] or "nothing fails"))
    scan = report["selective_scan"] = {"sound": scan_readings()}
    cases = {"sound": ((), ())}
    for name, old, new, must_fail, must_pass in SCAN_FAULTS:
        scan[name] = planted_kernel(name, [(old, new)], SCAN_CU,
                                    "--scan-readings")
        cases[name] = (must_fail, must_pass)
    for name, r in scan.items():
        fails = {k: v for k, v in r.items() if v is not None}
        cs.log(f"[scan] {name}: "
               + (f"fails {json.dumps(fails)}" if fails
                  else "passes every limit"))
        fused = r.get("check_ssm_scan") or ""
        must_fail, must_pass = cases[name]
        missed = [c for c in must_fail if f"ssm_scan {c}:" not in fused]
        wrong = [c for c in must_pass if f"ssm_scan {c}:" in fused]
        if (name == "sound") != (not fails):
            bad.append(f"selective_scan {name}: "
                       + (json.dumps(fails) if fails else "nothing fails"))
        elif missed or wrong:
            bad.append(f"selective_scan {name}: fused cases that pass "
                       f"{missed}, that fail {wrong}")
    scan_bwd_faults(report, bad)
    ring = report["serve"] = serve_readings()
    for name, tf in ring.items():
        ok = cs.teacher_ok(tf)
        cs.log(f"[serve] {name}: agreement {tf['agreement']:.4f} (limit "
               f"{cs.TEACHER_AGREEMENT}) by request "
               f"{json.dumps(tf['agreement_by_request'])}, max gap "
               f"{tf['max_gap']:.5f} (limit {cs.TEACHER_GAP}), mean gap "
               f"{tf['mean_gap']:.5f}: {'passes' if ok else 'fails'}")
        if (name == "sound") != ok:
            bad.append(f"{name}: {'fails' if name == 'sound' else 'passes'}")
    return finish(report, bad, t0)


def finish(report: dict, bad: list, t0: float) -> int:
    import chip_smoke as cs
    report["seconds"] = time.perf_counter() - t0
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_faults.json").write_text(json.dumps(report, indent=1))
    cs.log(f"[faults] {report['seconds']:.1f} s; "
           + ("the sound port passes every limit and every planted fault "
              "fails one" if not bad else f"WRONG: {bad}"))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
