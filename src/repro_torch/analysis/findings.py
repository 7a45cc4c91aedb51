"""Finding records and the checked-in baseline.

A finding's *key* deliberately excludes line numbers: it is
``rule:path:qualname:kind:occurrence`` so that unrelated edits above a
justified site do not churn ``analysis/baseline_torch.json``.  The
occurrence index disambiguates repeated identical sites inside one
function (two ``.item()`` readbacks in the same body are two keys).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

BASELINE_VERSION = 1


@dataclass(frozen=True)
class Finding:
    rule: str          # "R1".."R5"
    path: str          # repo-relative posix path
    qualname: str      # enclosing function ("<module>" at top level)
    kind: str          # stable slug, e.g. "sync.item"
    detail: str        # human-readable message
    line: int          # 1-based source line (informational only)
    occurrence: int = 0

    @property
    def key(self) -> str:
        return (f"{self.rule}:{self.path}:{self.qualname}:{self.kind}"
                f":{self.occurrence}")

    def render(self, status: str = "") -> str:
        tag = f" [{status}]" if status else ""
        return (f"{self.rule}{tag} {self.path}:{self.line} "
                f"({self.qualname}): {self.detail}")


def finalize_occurrences(findings: List[Finding]) -> List[Finding]:
    """Assign occurrence indices: identical (rule, path, qualname, kind)
    tuples are numbered in source order so keys stay unique + stable."""
    seen: Dict[tuple, int] = {}
    out = []
    for f in sorted(findings, key=lambda f: (f.path, f.line)):
        ident = (f.rule, f.path, f.qualname, f.kind)
        n = seen.get(ident, 0)
        seen[ident] = n + 1
        out.append(Finding(f.rule, f.path, f.qualname, f.kind, f.detail,
                           f.line, occurrence=n))
    return out


@dataclass
class Baseline:
    """The justified-findings allowlist
    (``analysis/baseline_torch.json``)."""
    entries: Dict[str, dict] = field(default_factory=dict)

    def justification(self, key: str) -> str:
        return self.entries.get(key, {}).get("justification", "")

    def diff(self, findings: List[Finding]):
        """Split current findings against the baseline.

        Returns (new, known, stale_keys): *new* findings are absent from
        the baseline (the merge-gate failures), *known* are baselined,
        *stale_keys* are baseline entries the current tree no longer
        produces (fixed or renamed — prune with ``--update-baseline``).
        """
        current = {f.key for f in findings}
        new = [f for f in findings if f.key not in self.entries]
        known = [f for f in findings if f.key in self.entries]
        stale = sorted(k for k in self.entries if k not in current)
        return new, known, stale

    def validate(self) -> List[str]:
        """Every baseline entry must carry a non-empty justification —
        an unjustified suppression is itself a gate failure."""
        return sorted(k for k, v in self.entries.items()
                      if not str(v.get("justification", "")).strip())


def load_baseline(path) -> Baseline:
    data = json.loads(Path(path).read_text())
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(f"baseline {path}: unsupported version "
                         f"{data.get('version')!r} (expected "
                         f"{BASELINE_VERSION})")
    entries = data.get("findings", {})
    if not isinstance(entries, dict):
        raise ValueError(f"baseline {path}: 'findings' must be an object "
                         "keyed by finding key")
    return Baseline(entries=entries)


def write_baseline(path, findings: List[Finding],
                   previous: Baseline = None) -> None:
    """Regenerate the baseline from the current findings, carrying over
    existing justifications; fresh entries get an empty justification the
    validator will force the author to fill in."""
    prev = previous.entries if previous is not None else {}
    entries = {}
    for f in findings:
        entry = dict(prev.get(f.key, {}))
        entry.setdefault("justification", "")
        entry["rule"] = f.rule
        entry["detail"] = f.detail
        entries[f.key] = entry
    payload = {"version": BASELINE_VERSION,
               "findings": dict(sorted(entries.items()))}
    Path(path).write_text(json.dumps(payload, indent=2) + "\n")
