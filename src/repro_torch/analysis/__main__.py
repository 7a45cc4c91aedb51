"""CLI for the port's static checker.

Usage (from the repo root)::

    python -m repro_torch.analysis                   # full run, text report
    python -m repro_torch.analysis --baseline analysis/baseline_torch.json
    python -m repro_torch.analysis --rules R1,R4 --format json
    python -m repro_torch.analysis --baseline analysis/baseline_torch.json \
        --update-baseline                            # regenerate baseline

Exit codes: 0 clean (every finding baselined + justified), 1 gate
failure (new findings, or baseline entries without a justification),
2 usage error.  Stale baseline entries (fixed findings) only warn —
prune them with ``--update-baseline``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis import ALL_RULES, RULE_TITLES, analyze_project
from repro_torch.analysis.findings import (Baseline, load_baseline,
                                           write_baseline)
from repro_torch.analysis.project import Project


def _parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="CUDA-graph and ctypes-aware static checker of the "
                    "PyTorch port (rules R1-R5)")
    ap.add_argument("--root", default="src/repro_torch",
                    help="source subdir to analyze (default: "
                         "src/repro_torch)")
    ap.add_argument("--repo", default=".",
                    help="repo root paths are reported relative to")
    ap.add_argument("--baseline", default=None,
                    help="baseline JSON to diff findings against")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from current findings "
                         "(carries existing justifications forward)")
    ap.add_argument("--rules", default=",".join(ALL_RULES),
                    help="comma-separated rule subset (default: all)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _parse_args(argv if argv is not None else sys.argv[1:])
    rules = tuple(r.strip() for r in args.rules.split(",") if r.strip())
    bad = [r for r in rules if r not in ALL_RULES]
    if bad:
        print(f"error: unknown rule(s) {', '.join(bad)} "
              f"(known: {', '.join(ALL_RULES)})", file=sys.stderr)
        return 2
    repo = Path(args.repo)
    if not (repo / args.root).is_dir():
        print(f"error: source root {repo / args.root} not found",
              file=sys.stderr)
        return 2

    project = Project.from_root(repo, subdir=args.root)
    findings = analyze_project(project, rules=rules)

    baseline = Baseline()
    if args.baseline and Path(args.baseline).exists():
        try:
            baseline = load_baseline(args.baseline)
        except (ValueError, json.JSONDecodeError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    elif args.baseline and not args.update_baseline:
        print(f"warning: baseline {args.baseline} not found; "
              "treating every finding as new", file=sys.stderr)

    if args.update_baseline:
        if not args.baseline:
            print("error: --update-baseline requires --baseline",
                  file=sys.stderr)
            return 2
        Path(args.baseline).parent.mkdir(parents=True, exist_ok=True)
        write_baseline(args.baseline, findings, previous=baseline)
        print(f"wrote {args.baseline} with {len(findings)} finding(s); "
              "fill in any empty justifications")
        return 0

    new, known, stale = baseline.diff(findings)
    unjustified = [k for k in baseline.validate()
                   if k in {f.key for f in known}]

    if args.format == "json":
        print(json.dumps({
            "rules": list(rules),
            "new": [vars(f) | {"key": f.key} for f in new],
            "known": [vars(f) | {"key": f.key} for f in known],
            "stale": stale,
            "unjustified": unjustified,
        }, indent=2))
    else:
        for f in known:
            print(f.render("baselined"))
        for f in new:
            print(f.render("NEW"))
        for k in stale:
            print(f"stale baseline entry (no longer produced): {k}")
        for k in unjustified:
            print(f"baseline entry lacks a justification: {k}")
        counts = {}
        for f in findings:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        summary = ", ".join(
            f"{r} {RULE_TITLES[r]}: {counts.get(r, 0)}" for r in rules)
        print(f"-- {len(findings)} finding(s) [{summary}]; "
              f"{len(new)} new, {len(known)} baselined, "
              f"{len(stale)} stale, {len(unjustified)} unjustified")

    if new or unjustified:
        if new:
            print(f"FAIL: {len(new)} finding(s) not in the baseline — fix "
                  "them, or justify via --update-baseline + a "
                  "'justification' entry", file=sys.stderr)
        if unjustified:
            print(f"FAIL: {len(unjustified)} baseline entr(ies) have no "
                  "justification", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
