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
- the full-depth h2o-danube-3-4b serve (``serve_ring``): every served
  token against teacher forcing, the share equal
  (``TEACHER_AGREEMENT``) and the teacher's largest logit gap to a
  served token (``TEACHER_GAP``).  Each fault is planted in this process
  by replacing the ring decode: V read one slot off, the window halved,
  or the new token written one slot ahead (its own slot stale).

Prints each reading beside its limit and exits 0 only if the sound port
passes every limit and every planted fault fails at least one.  Details
go to ``chiprun_out/chip_faults.json``.  Needs one card.
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


def flash_fails(readings: dict, tol: float, rel_tol: float) -> list:
    return [f"{check}: {case}" for check, rows in readings.items()
            for case, err, rel in rows if not (err <= tol and rel <= rel_tol)]


def planted_kernel(name: str, old: str, new: str, source: str = FLASH_CU,
                   readings: str = "--flash-readings") -> dict:
    """Build a copy of the port with ``old`` replaced by ``new`` in the
    kernel ``source`` and read its checks (``readings``) in a process of
    its own."""
    with tempfile.TemporaryDirectory() as tmp:
        pkg = Path(tmp) / "src" / "repro_torch"
        shutil.copytree(ROOT / "src" / "repro_torch", pkg,
                        ignore=shutil.ignore_patterns("__pycache__"))
        cu = pkg / source
        text = cu.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"fault {name!r}: its text occurs "
                               f"{text.count(old)} times in {source}")
        cu.write_text(text.replace(old, new))
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
    import torch
    if not torch.cuda.is_available():
        print("chip_faults: torch.cuda.is_available() is False; this script "
              "runs the port on an NVIDIA card", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    tol, rel_tol = cs.TOL, cs.FLASH_REL_TOL
    report, bad = {"limits": {"TOL": tol, "FLASH_REL_TOL": rel_tol,
                              "TEACHER_AGREEMENT": cs.TEACHER_AGREEMENT,
                              "TEACHER_GAP": cs.TEACHER_GAP}}, []
    flash = report["flash_attention"] = {"sound": flash_readings()}
    for name, old, new in KERNEL_FAULTS:
        flash[name] = planted_kernel(name, old, new)
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
        gptq[name] = planted_kernel(name, old, new, GPTQ_CU,
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
        scan[name] = planted_kernel(name, old, new, SCAN_CU,
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
