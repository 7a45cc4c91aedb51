"""Discovery of every captured step in the project: the port's counterpart
of the JAX checker's jit registry.

The port replaces ``jax.jit`` with CUDA graphs (``serving/step_graph.py``):
a runner builds one ``StepGraph`` per dispatch kind, hands it the step
function that kind captures, stages each dispatch's host arrays into the
graph's fixed ``Fields`` and calls ``graph.run(key)``, where ``key`` is
the variant: every host-side choice the step makes.  The step updates the
runner's static state (``self.state``) in place, through
``step_graph.copy_back`` for the entries it returns anew.

The registry records, from the AST alone:

* each ``StepGraph(...)`` construction, the class that builds it (the
  runner) and the step function each kind captures (the lambda's
  ``{kind: self._body}[kind]`` table, or a function passed directly);
* each ``run(key)`` site, its variant key and, where the staging call
  names it, its kind;
* each ``copy_back`` call and each ``stage`` call (and the methods that
  forward their arrays to one);
* the runner's static state attribute and the dispatch methods that run
  no graph (the whole-prompt wave, the standalone ``sample``, the
  per-token oracle, the CoW copies), which stay eager.

It is the shared ground truth for R1 (a run site's output is a device
value; the step functions are reachable from it), R2 (the step functions,
the static state, ``copy_back``), R3 (the variant key, the staged arrays)
and R5 (the step functions and their device inputs).
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.project import (FunctionInfo, Project, call_name,
                                          dotted_name, own_statements)

GRAPH_CLASS = "StepGraph"
STATE_ATTR = "state"            # the runner's static decode state
PARAMS_ATTR = "params"          # the runner's device weights
COPY_BACK = "copy_back"
STAGE = "stage"


@dataclass
class StepSite:
    """One ``StepGraph(...)`` construction."""
    builder: FunctionInfo              # the function that constructs it
    lineno: int
    owner: Optional[str]               # the class whose method builds it
    kinds: Dict[str, FunctionInfo] = field(default_factory=dict)


@dataclass
class RunSite:
    """One ``graph.run(key)`` call."""
    fn: FunctionInfo
    call: ast.Call
    key: Optional[ast.expr]
    kind: Optional[str] = None


def _is_graph_ctor(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) \
        and call_name(node).split(".")[-1] == GRAPH_CLASS


def _self_attr(node: ast.AST, attr: Optional[str] = None) -> bool:
    return isinstance(node, ast.Attribute) \
        and isinstance(node.value, ast.Name) and node.value.id == "self" \
        and (attr is None or node.attr == attr)


class CaptureRegistry:
    def __init__(self, project: Project):
        self.project = project
        self.steps: List[StepSite] = []
        self.runs: List[RunSite] = []
        self.copy_backs: List[Tuple[FunctionInfo, ast.Call]] = []
        # ref -> FunctionInfo of every step function a graph captures
        self.step_functions: Dict[str, FunctionInfo] = {}
        # classes that build step graphs (the runners)
        self.runner_classes: Set[str] = set()
        # (class, method) of methods that return a StepGraph
        self.graph_methods: Set[Tuple[str, str]] = set()
        # ref -> index of the param a method forwards into ``stage``
        self.stage_forwarders: Dict[str, int] = {}
        self._assign_memo: Dict[str, Dict[str, List[ast.expr]]] = {}
        self._stage_memo: Dict[str, List[ast.Call]] = {}
        self._collect()

    # ------------------------------------------------------------------
    def _collect(self) -> None:
        for fn in self.project.all_functions():
            for node in fn.calls:
                if _is_graph_ctor(node):
                    self._add_step(fn, node)
        self._collect_graph_methods()
        for fn in self.project.all_functions():
            self._collect_runs(fn)
            for node in fn.calls:
                if call_name(node).split(".")[-1] == COPY_BACK:
                    self.copy_backs.append((fn, node))
        self._collect_stage_forwarders()

    def _add_step(self, fn: FunctionInfo, call: ast.Call) -> None:
        site = StepSite(builder=fn, lineno=call.lineno, owner=fn.class_name)
        if fn.class_name:
            self.runner_classes.add(fn.class_name)
        step = call.args[3] if len(call.args) > 3 else next(
            (k.value for k in call.keywords if k.arg == "fn"), None)
        name = call.args[0].value if call.args and isinstance(
            call.args[0], ast.Constant) else "<step>"
        for kind, target in self._step_targets(fn, step, name):
            site.kinds[kind] = target
            self.step_functions[target.ref] = target
        self.steps.append(site)

    def _step_targets(self, fn: FunctionInfo, step: Optional[ast.expr],
                      name: str):
        """(kind, step FunctionInfo) pairs of a constructor's ``fn``."""
        if step is None:
            return []
        if isinstance(step, ast.Lambda):
            body = step.body
            if isinstance(body, ast.Call):
                return self._step_targets(fn, body.func, name)
            return []
        if _self_attr(step) and fn.class_name:
            target = self._method(fn.class_name, step.attr)
            return [(name, target)] if target else []
        if isinstance(step, ast.Name):
            # ``body = {"kind": self._body, ...}[kind]`` in the builder
            for stmt in own_statements(fn.node):
                if isinstance(stmt, ast.Assign) and any(
                        isinstance(t, ast.Name) and t.id == step.id
                        for t in stmt.targets):
                    v = stmt.value
                    if isinstance(v, ast.Subscript) \
                            and isinstance(v.value, ast.Dict):
                        out = []
                        for k, val in zip(v.value.keys, v.value.values):
                            kind = k.value if isinstance(k, ast.Constant) \
                                else name
                            out += [(kind, t) for _, t in
                                    self._step_targets(fn, val, kind)]
                        return out
                    return self._step_targets(fn, v, name)
            target = self.project.resolve_symbol(fn.module, step.id)
            return [(name, target)] if target else []
        return []

    def _method(self, cls: str, name: str) -> Optional[FunctionInfo]:
        for m in self.project.modules:
            if cls in m.classes:
                return m.functions.get(f"{cls}.{name}")
        return None

    def _collect_graph_methods(self) -> None:
        """Methods of the runners that return a StepGraph: annotated so,
        or returning a constructor's result or another such method's."""
        methods = [(fn, [r.value for r in own_statements(fn.node)
                         if isinstance(r, ast.Return)
                         and r.value is not None])
                   for fn in self.project.all_functions()
                   if fn.class_name in self.runner_classes]
        changed = True
        while changed:
            changed = False
            for fn, rets in methods:
                if (fn.class_name, fn.node.name) in self.graph_methods:
                    continue
                ann = fn.node.returns
                if (ann is not None and dotted_name(ann).split(".")[-1]
                        == GRAPH_CLASS) or any(
                            self.is_graph_expr(fn, r) for r in rets):
                    self.graph_methods.add((fn.class_name, fn.node.name))
                    changed = True

    def is_graph_expr(self, fn: FunctionInfo, node: ast.AST,
                      depth: int = 0) -> bool:
        """Does ``node`` (in ``fn``) evaluate to a StepGraph: a
        constructor, a graph method's result, an entry of ``self.graphs``,
        a local bound to one of those, or an if-expression holding one?"""
        if node is None or depth > 4:
            return False
        if _is_graph_ctor(node):
            return True
        if isinstance(node, ast.IfExp):
            return self.is_graph_expr(fn, node.body, depth + 1) \
                or self.is_graph_expr(fn, node.orelse, depth + 1)
        if isinstance(node, ast.Call) and _self_attr(node.func) \
                and fn.class_name \
                and (fn.class_name, node.func.attr) in self.graph_methods:
            return True
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute) \
                and node.func.attr == "get" \
                and _self_attr(node.func.value, "graphs"):
            return True
        if isinstance(node, ast.Subscript) \
                and _self_attr(node.value, "graphs"):
            return True
        if isinstance(node, ast.Name):
            return any(self.is_graph_expr(fn, v, depth + 1)
                       for v in self._assigned(fn).get(node.id, ()))
        return False

    def _assigned(self, fn: FunctionInfo) -> Dict[str, List[ast.expr]]:
        """name -> the values ``fn`` assigns to it (memoized)."""
        if fn.ref not in self._assign_memo:
            out: Dict[str, List[ast.expr]] = {}
            for stmt in own_statements(fn.node):
                if isinstance(stmt, ast.Assign):
                    for t in stmt.targets:
                        if isinstance(t, ast.Name):
                            out.setdefault(t.id, []).append(stmt.value)
            self._assign_memo[fn.ref] = out
        return self._assign_memo[fn.ref]

    def _collect_runs(self, fn: FunctionInfo) -> None:
        if not any(isinstance(c.func, ast.Attribute) and c.func.attr == "run"
                   for c in fn.calls):
            return
        kinds = {}
        for stmt in own_statements(fn.node):
            # the kind a staging call names: ``g = self._stage("chunk", ..)``
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                for c in ast.walk(stmt.value):
                    if isinstance(c, ast.Call) and c.args \
                            and isinstance(c.args[0], ast.Constant) \
                            and isinstance(c.args[0].value, str) \
                            and self.is_graph_expr(fn, c):
                        kinds[stmt.targets[0].id] = c.args[0].value
        for node in fn.calls:
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "run" \
                    and self.is_graph_expr(fn, node.func.value):
                recv = node.func.value
                self.runs.append(RunSite(
                    fn=fn, call=node, key=node.args[0] if node.args else None,
                    kind=kinds.get(recv.id) if isinstance(recv, ast.Name)
                    else None))

    def _collect_stage_forwarders(self) -> None:
        """Methods that pass one of their params on to a graph's
        ``stage`` (one hop: ``_stage(kind, arrays)`` → ``g.stage(...,
        arrays)``)."""
        for fn in self.project.all_functions():
            params = fn.positional_params
            for call in self.stage_calls(fn):
                for arg in call.args[1:]:
                    names = {n.id for n in ast.walk(arg)
                             if isinstance(n, ast.Name)}
                    for p in names & set(params):
                        self.stage_forwarders[fn.ref] = params.index(p)

    # ------------------------------------------------------------ queries
    def stage_calls(self, fn: FunctionInfo) -> List[ast.Call]:
        """``graph.stage(staging, arrays)`` calls in ``fn``."""
        if fn.ref not in self._stage_memo:
            self._stage_memo[fn.ref] = [
                n for n in fn.calls if isinstance(n.func, ast.Attribute)
                and n.func.attr == STAGE
                and self.is_graph_expr(fn, n.func.value)]
        return self._stage_memo[fn.ref]

    def is_runner(self, cls: Optional[str]) -> bool:
        return cls is not None and cls in self.runner_classes

    def run_functions(self) -> Set[str]:
        return {r.fn.ref for r in self.runs}

    def edges(self) -> Dict[str, Set[str]]:
        """Call edges the AST does not show: a function with a run site
        reaches ``StepGraph.run`` and every step function its class's
        graphs capture (a replay calls the step on the CPU; on the card
        the step ran at capture), and a staging call ``StepGraph.stage``."""
        out: Dict[str, Set[str]] = {}
        run = self._method(GRAPH_CLASS, "run")
        stage = self._method(GRAPH_CLASS, STAGE)
        for r in self.runs:
            callees = out.setdefault(r.fn.ref, set())
            if run is not None:
                callees.add(run.ref)
            for site in self.steps:
                if site.owner == r.fn.class_name:
                    callees.update(t.ref for t in site.kinds.values())
        for fn in self.project.all_functions():
            if stage is not None and self.stage_calls(fn):
                out.setdefault(fn.ref, set()).add(stage.ref)
        return out

    def eager_dispatchers(self) -> List[FunctionInfo]:
        """Runner methods that dispatch device work and run no graph: the
        whole-prompt wave, the standalone sample, the per-token oracle,
        the CoW copies."""
        runs = self.run_functions()
        out = []
        for fn in self.project.all_functions():
            if not self.is_runner(fn.class_name) or fn.ref in runs \
                    or fn.ref in self.step_functions \
                    or fn.node.name.startswith("_"):
                continue
            if any(isinstance(n, ast.AugAssign)
                   and dotted_name(n.target) == "self.dispatches"
                   for n in fn.nodes):
                out.append(fn)
        return out


def registry_of(project: Project) -> CaptureRegistry:
    """The project's capture registry, built once for all rules."""
    if "registry" not in project.memo:
        project.memo["registry"] = CaptureRegistry(project)
    return project.memo["registry"]
