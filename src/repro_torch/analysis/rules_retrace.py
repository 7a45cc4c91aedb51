"""R3 — variant-hazard (the port's counterpart of retrace hazards).

A step graph replays the launches of one capture per variant key; the key
holds every host-side choice the step makes (``_variant(sampling)``: the
sampling plan, the guard, a poison row).  Two ways a call site breaks
that silently on the CPU:

* **unkeyed-branch** — a captured step function branches on a host value
  that can change between dispatches but is not in its variant key: an
  attribute of the runner that a method other than ``__init__`` assigns
  or mutates (``self._tables``), or a module global rebound under
  ``global``.  On the card the replay runs the branch its capture took
  (``StepGraph`` raises when the launch counts differ, but only on the
  card); on the CPU the step is called again and takes the other.  The
  step's own parameters (the kind and the key), constants, the config
  and attributes fixed at construction are stable.
* **varying-shape** — an array whose shape embeds a runtime quantity
  (``np.zeros((len(seqs), n))``) is staged into a graph's fixed
  ``Fields`` (``graph.stage(staging, arrays)``, or a method that
  forwards its arrays there, ``self._stage(kind, arrays)``): the staging
  raises on the card and the CPU alike, but only for the sizes a run
  happens to meet.  Propagated through ``np.asarray``, dict literals and
  dict-subscript stores, as the JAX checker does.

The eager paths (the whole-prompt wave, the standalone ``sample``, the
per-token oracle, the CoW copies) are never staged into a graph, so their
per-shape uploads give no finding here: they are the port's counterparts
of the JAX oracle paths whose recompiles the JAX baseline justifies.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Set

from repro_torch.analysis.capture_registry import registry_of
from repro_torch.analysis.findings import Finding, finalize_occurrences
from repro_torch.analysis.project import (FunctionInfo, Project, call_name,
                                          own_statements)

RULE = "R3"

_SHAPE_CTORS = {"zeros", "ones", "empty", "full", "arange"}
_ARRAY_WRAPS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
_MUTATORS = {"append", "extend", "update", "pop", "clear", "setdefault",
             "add", "remove", "discard", "insert", "popitem"}


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _unstable_names(fn: FunctionInfo) -> Set[str]:
    """Names holding runtime-varying host scalars: len() results, loop
    targets, and arithmetic derived from either."""
    unstable: Set[str] = set()
    for stmt in own_statements(fn.node):
        if isinstance(stmt, ast.For):
            for n in ast.walk(stmt.target):
                if isinstance(n, ast.Name):
                    unstable.add(n.id)
        if isinstance(stmt, (ast.Assign, ast.AugAssign)) \
                and getattr(stmt, "value", None) is not None:
            derived = False
            v = stmt.value
            if isinstance(v, ast.Call) and call_name(v) == "len":
                derived = True
            elif isinstance(v, (ast.BinOp, ast.UnaryOp)):
                names = _names_in(v)
                if names & unstable or any(
                        isinstance(c, ast.Call) and call_name(c) == "len"
                        for c in ast.walk(v)):
                    derived = True
            elif isinstance(v, ast.Name) and v.id in unstable:
                derived = True
            if derived:
                targets = stmt.targets if isinstance(stmt, ast.Assign) \
                    else [stmt.target]
                for tgt in targets:
                    for n in ast.walk(tgt):
                        if isinstance(n, ast.Name):
                            unstable.add(n.id)
    return unstable


def _varying_names(fn: FunctionInfo, unstable: Set[str]) -> Set[str]:
    """Names holding arrays (or containers of arrays) whose shape embeds
    an unstable quantity."""
    varying: Set[str] = set()
    for stmt in own_statements(fn.node):
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            tgt, v = stmt.targets[0], stmt.value
            marked = False
            if isinstance(v, ast.Call):
                name = call_name(v)
                if name.split(".")[-1] in _SHAPE_CTORS and v.args:
                    if _names_in(v.args[0]) & unstable:
                        marked = True
                elif name in _ARRAY_WRAPS and v.args:
                    if _names_in(v.args[0]) & varying:
                        marked = True
                elif name == "dict":
                    if any(_names_in(a) & varying for a in
                           list(v.args) + [k.value for k in v.keywords]):
                        marked = True
            elif isinstance(v, ast.Dict):
                if any(_names_in(val) & varying
                       for val in v.values if val is not None):
                    marked = True
            elif isinstance(v, (ast.DictComp, ast.ListComp)):
                if any(_names_in(g.iter) & varying for g in v.generators):
                    marked = True
            elif isinstance(v, ast.IfExp):
                if _names_in(v) & varying:
                    marked = True
            elif isinstance(v, ast.Name) and v.id in varying:
                marked = True
            if marked:
                if isinstance(tgt, ast.Name):
                    varying.add(tgt.id)
                elif isinstance(tgt, ast.Subscript) \
                        and isinstance(tgt.value, ast.Name):
                    varying.add(tgt.value.id)
            # dict-subscript store of a varying value marks the dict
            if isinstance(tgt, ast.Subscript) \
                    and isinstance(tgt.value, ast.Name) \
                    and _names_in(v) & varying:
                varying.add(tgt.value.id)
    return varying


def _mutable_attrs(project: Project, cls: str) -> Set[str]:
    """Attributes of class ``cls`` that a method other than ``__init__``
    assigns, or that any method mutates in place."""
    out: Set[str] = set()
    for m in project.modules:
        if cls not in m.classes:
            continue
        for fn in m.functions.values():
            if fn.class_name != cls:
                continue
            for node in fn.nodes:
                targets = []
                if isinstance(node, (ast.Assign, ast.AugAssign,
                                     ast.AnnAssign)):
                    targets = node.targets if isinstance(node, ast.Assign) \
                        else [node.target]
                for t in targets:
                    for e in (t.elts if isinstance(t, ast.Tuple) else [t]):
                        base = e.value if isinstance(e, ast.Subscript) else e
                        if isinstance(base, ast.Attribute) \
                                and isinstance(base.value, ast.Name) \
                                and base.value.id == "self" \
                                and (fn.node.name != "__init__"
                                     or base is not e):
                            out.add(base.attr)
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and node.func.attr in _MUTATORS \
                        and isinstance(node.func.value, ast.Attribute) \
                        and isinstance(node.func.value.value, ast.Name) \
                        and node.func.value.value.id == "self":
                    out.add(node.func.value.attr)
    return out


def _rebound_globals(fn: FunctionInfo) -> Set[str]:
    return {name for f in fn.module.functions.values()
            for n in ast.walk(f.node) if isinstance(n, ast.Global)
            for name in n.names}


class VariantChecker:
    def __init__(self, project: Project):
        self.project = project
        self.registry = registry_of(project)
        self._mutable: Dict[str, Set[str]] = {}

    def check(self) -> List[Finding]:
        findings: List[Finding] = []
        for fn in self.registry.step_functions.values():
            self._check_branches(fn, findings)
        for fn in self.project.all_functions():
            stages = self._stage_calls(fn)
            if not stages:
                continue
            unstable = _unstable_names(fn)
            varying = _varying_names(fn, unstable)
            for call, arrays in stages:
                self._check_stage(fn, call, arrays, varying, findings)
        return findings

    # ---------------------------------------------------------- branches
    def _check_branches(self, fn: FunctionInfo, findings) -> None:
        mutable = set()
        if fn.class_name:
            if fn.class_name not in self._mutable:
                self._mutable[fn.class_name] = _mutable_attrs(
                    self.project, fn.class_name)
            mutable = self._mutable[fn.class_name]
        rebound = _rebound_globals(fn)
        for stmt in own_statements(fn.node):
            if not isinstance(stmt, (ast.If, ast.While)):
                continue
            bad = sorted(
                {f"self.{n.attr}" for n in ast.walk(stmt.test)
                 if isinstance(n, ast.Attribute)
                 and isinstance(n.value, ast.Name) and n.value.id == "self"
                 and n.attr in mutable}
                | {n.id for n in ast.walk(stmt.test)
                   if isinstance(n, ast.Name) and n.id in rebound})
            if bad:
                findings.append(Finding(
                    RULE, fn.module.rel, fn.qualname, "variant.unkeyed-branch",
                    f"captured step branches on `{ast.unparse(stmt.test)}`: "
                    f"`{'`, `'.join(bad)}` can change between dispatches "
                    "and is not in the variant key, so a replay runs the "
                    "branch its capture took", stmt.lineno))

    # ------------------------------------------------------------ stages
    def _stage_calls(self, fn: FunctionInfo):
        """(call, arrays argument) of every staging call in ``fn``: a
        graph's ``stage`` and the methods that forward their arrays to
        one."""
        out = [(c, c.args[1]) for c in self.registry.stage_calls(fn)
               if len(c.args) > 1]
        for node in fn.calls:
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            target = None
            if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                    and f.value.id == "self" and fn.class_name:
                target = self.registry._method(fn.class_name, f.attr)
            elif isinstance(f, ast.Name):
                target = self.project.resolve_symbol(fn.module, f.id)
            if target is None or target.ref not in \
                    self.registry.stage_forwarders:
                continue
            idx = self.registry.stage_forwarders[target.ref]
            if target.class_name and target.positional_params[:1] == \
                    ["self"]:
                idx -= 1
            if 0 <= idx < len(node.args):
                out.append((node, node.args[idx]))
        return out

    def _check_stage(self, fn, call, arrays, varying, findings) -> None:
        bad = sorted(_names_in(arrays) & varying)
        if bad:
            findings.append(Finding(
                RULE, fn.module.rel, fn.qualname,
                f"variant.varying-shape.{bad[0]}",
                f"`{ast.unparse(call)}` stages `{ast.unparse(arrays)}` "
                f"whose shape depends on a runtime size (`"
                f"{'`, `'.join(bad)}`) into a graph's fixed fields",
                call.lineno))


def check_variants(project: Project) -> List[Finding]:
    return finalize_occurrences(VariantChecker(project).check())
