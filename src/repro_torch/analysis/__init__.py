"""repro_torch.analysis — the static checker of the PyTorch port.

The port's serving stack rests on contracts that no CPU test sees: the
hot loop must not sync with the card outside its planned readbacks (R1);
a captured step must write every state entry it returns anew back into
the runner's static tensors, allocate nothing lazily and return no view
of its static inputs (R2, capture safety: the counterpart of donation
safety); a host value a captured step branches on must be in its variant
key, and an array staged into a graph's fixed fields must not take its
shape from a runtime size (R3, variant hazards); every ctypes binding
must match its ``extern "C"`` entry in ``csrc/*.cu``, every launch must
be checked and counted, and every page walk of a kernel must stay inside
the live prefix (R4); and a captured step must never branch in Python on
a device tensor (R5).

``python -m repro_torch.analysis`` runs all rules over ``src/repro_torch``
and diffs the findings against ``analysis/baseline_torch.json``; any
finding not in the baseline exits nonzero.  Every baseline entry carries
a mandatory justification — see docs/ANALYSIS_torch.md.  The package
imports the standard library only and never the code it reads.
"""
from __future__ import annotations

from repro_torch.analysis.findings import (Baseline, Finding,  # noqa: F401
                                           load_baseline)
from repro_torch.analysis.project import (Project,  # noqa: F401
                                          SourceModule)

ALL_RULES = ("R1", "R2", "R3", "R4", "R5")

RULE_TITLES = {
    "R1": "host-sync-in-hot-path",
    "R2": "capture-safety",
    "R3": "variant-hazard",
    "R4": "kernel-contract",
    "R5": "device-control-flow",
}


def analyze_project(project: Project, rules=ALL_RULES):
    """Run the requested rules over a loaded ``Project``; returns the
    sorted finding list (inline ``# repro: allow[...]`` sites already
    dropped)."""
    from repro_torch.analysis.rules_donation import check_capture
    from repro_torch.analysis.rules_flow import check_device_flow
    from repro_torch.analysis.rules_kernel import check_kernel_contracts
    from repro_torch.analysis.rules_retrace import check_variants
    from repro_torch.analysis.rules_sync import check_host_sync

    runners = {"R1": check_host_sync, "R2": check_capture,
               "R3": check_variants, "R4": check_kernel_contracts,
               "R5": check_device_flow}
    findings = []
    for rule in rules:
        findings.extend(runners[rule](project))
    findings = [f for f in findings if not project.is_allowed(f)]
    return sorted(findings, key=lambda f: (f.path, f.line, f.key))


def analyze_source(source: str, filename: str = "<fixture>.py",
                   rules=ALL_RULES, roots=None):
    """Analyze a single in-memory module (the test-fixture entry point)."""
    project = Project.from_sources({filename: source}, roots=roots)
    return analyze_project(project, rules=rules)


def analyze_sources(sources, rules=ALL_RULES, roots=None):
    """Analyze in-memory modules and CUDA sources keyed by path."""
    project = Project.from_sources(dict(sources), roots=roots)
    return analyze_project(project, rules=rules)
