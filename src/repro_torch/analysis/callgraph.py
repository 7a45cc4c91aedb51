"""Cheap flow-insensitive call graph over the project.

Good enough for hot-path reachability (R1/R5): resolves

* bare calls ``fn(...)`` to module-local or ``from m import fn`` defs,
* ``alias.fn(...)`` through module imports (``from repro_torch.models
  import transformer as T`` → ``T.prefill``),
* ``self.method(...)`` within the enclosing class,
* ``self.attr.method(...)`` via an attribute-type map built from
  ``self.attr = ClassName(...)`` assignments in ``__init__`` (so
  ``ServingEngine.step`` reaches ``ModelRunner.sample``), and
* callables passed as arguments (``self._protected(rids, lambda: ...)``
  marks the lambda body reachable too).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from repro_torch.analysis.project import FunctionInfo, Project, dotted_name


def _class_attr_types(project: Project) -> Dict[str, Dict[str, str]]:
    """class name -> {self attr name -> class name of assigned value}."""
    known_classes = {name for m in project.modules for name in m.classes}
    out: Dict[str, Dict[str, str]] = {}
    for mod in project.modules:
        for cls_name in mod.classes:
            attrs: Dict[str, str] = {}
            for node in (n for f in mod.functions.values()
                         if f.class_name == cls_name
                         and f.qualname.count(".") == 1 for n in f.nodes):
                if not isinstance(node, ast.Assign):
                    continue
                for tgt in node.targets:
                    if (isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"
                            and isinstance(node.value, ast.Call)):
                        callee = dotted_name(node.value.func)
                        base = callee.split(".")[-1]
                        if base in known_classes:
                            attrs[tgt.attr] = base
            out[cls_name] = attrs
    return out


class CallGraph:
    def __init__(self, project: Project):
        self.project = project
        self.attr_types = _class_attr_types(project)
        # FunctionInfo.ref -> set of callee refs
        self.edges: Dict[str, Set[str]] = {}
        # class name -> defining module (first wins; names are unique here)
        self.class_home: Dict[str, str] = {}
        for m in project.modules:
            for name in m.classes:
                self.class_home.setdefault(name, m.rel)
        for fn in project.all_functions():
            self.edges[fn.ref] = self._callees(fn)

    # ------------------------------------------------------------------
    def _method(self, cls: str, name: str) -> Optional[FunctionInfo]:
        rel = self.class_home.get(cls)
        if rel is None:
            return None
        return self.project.by_rel[rel].functions.get(f"{cls}.{name}")

    def _callees(self, fn: FunctionInfo) -> Set[str]:
        callees: Set[str] = set()
        mod = fn.module

        def add(info: Optional[FunctionInfo]):
            if info is not None:
                callees.add(info.ref)

        for node in fn.calls:
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Name):
                add(self.project.resolve_symbol(mod, f.id))
            elif isinstance(f, ast.Attribute):
                base = f.value
                if isinstance(base, ast.Name) and base.id == "self":
                    if fn.class_name:
                        add(self._method(fn.class_name, f.attr))
                elif (isinstance(base, ast.Attribute)
                      and isinstance(base.value, ast.Name)
                      and base.value.id == "self" and fn.class_name):
                    # self.attr.method(...)
                    attr_cls = self.attr_types.get(
                        fn.class_name, {}).get(base.attr)
                    if attr_cls:
                        add(self._method(attr_cls, f.attr))
                else:
                    add(self.project.resolve_attr_call(mod, base, f.attr))
            # callables passed as args reach their bodies: resolve
            # Name args that denote project functions (lambdas are part
            # of the caller's own AST and are walked in place by rules)
            for arg in list(node.args) + [k.value for k in node.keywords]:
                if isinstance(arg, ast.Name):
                    cand = self.project.resolve_symbol(mod, arg.id)
                    if cand is not None and isinstance(
                            cand.node,
                            (ast.FunctionDef, ast.AsyncFunctionDef)):
                        add(cand)
        return callees

    # ------------------------------------------------------------------
    def reachable(self, roots: List[str]) -> Set[str]:
        """BFS closure of FunctionInfo refs from the given root refs.
        Method roots pull in sibling private helpers conservatively via
        the explicit edges only."""
        seen: Set[str] = set()
        frontier = [r for r in roots if r in self.edges]
        seen.update(frontier)
        while frontier:
            nxt = []
            for ref in frontier:
                for callee in self.edges.get(ref, ()):
                    if callee not in seen:
                        seen.add(callee)
                        nxt.append(callee)
            frontier = nxt
        return seen


def _local_types(project: Project, fn: FunctionInfo,
                 known: Set[str]) -> Dict[str, str]:
    """name -> class of the locals and params ``fn`` types: ``x =
    ClassName(...)`` and ``x: ClassName`` annotations."""
    types: Dict[str, str] = {}
    a = fn.node.args
    for p in a.posonlyargs + a.args + a.kwonlyargs:
        if p.annotation is not None:
            base = dotted_name(p.annotation).split(".")[-1]
            if base in known:
                types[p.arg] = base
    for node in fn.nodes:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            base = dotted_name(node.value.func).split(".")[-1]
            if base in known:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        types[tgt.id] = base
    return types


def receiver_edges(project: Project,
                   graph: CallGraph) -> Dict[str, Set[str]]:
    """Call edges the base graph leaves out: a class called as a
    constructor reaches its ``__init__``, a module-level instance called
    (``gptq_matmul(...)``) its ``__call__``, ``x.method(...)`` on a local
    or parameter whose class the function shows (``x = Readback(...)``,
    ``rb: Readback``) that method, and a local bound to project functions
    (``pf = a if c else b``) each of them."""
    known = set(graph.class_home)
    # module-level instances: ``gptq_matmul = GptqMatmul()``
    instances: Dict[tuple, str] = {}
    for mod in project.modules:
        for stmt in mod.tree.body:
            if isinstance(stmt, ast.Assign) \
                    and isinstance(stmt.value, ast.Call):
                base = dotted_name(stmt.value.func).split(".")[-1]
                if base in known:
                    for tgt in stmt.targets:
                        if isinstance(tgt, ast.Name):
                            instances[(mod.rel, tgt.id)] = base

    def instance_of(mod, name: str):
        if (mod.rel, name) in instances:
            return instances[(mod.rel, name)]
        imp = mod.imports.get(name)
        if imp and imp[0] == "symbol":
            target = project.resolve_module(imp[1])
            if target is not None:
                return instances.get((target.rel, imp[2]))
        return None

    out: Dict[str, Set[str]] = {}
    for fn in project.all_functions():
        types = _local_types(project, fn, known)
        # function-valued locals: ``pf = attn_prefill_ring if ... else
        # attn_prefill``
        aliases: Dict[str, Set[str]] = {}
        for node in fn.nodes:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                vals = [node.value.body, node.value.orelse] \
                    if isinstance(node.value, ast.IfExp) else [node.value]
                refs = {t.ref for t in (
                    project.resolve_symbol(fn.module, v.id)
                    for v in vals if isinstance(v, ast.Name)) if t}
                if refs:
                    aliases.setdefault(node.targets[0].id, set()).update(refs)
        for node in fn.calls:
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            target = None
            if isinstance(f, ast.Name) and f.id in known:
                target = graph._method(f.id, "__init__")
            elif isinstance(f, ast.Name) and instance_of(fn.module, f.id):
                target = graph._method(instance_of(fn.module, f.id),
                                       "__call__")
            elif isinstance(f, ast.Attribute) \
                    and isinstance(f.value, ast.Name) \
                    and f.value.id in types:
                target = graph._method(types[f.value.id], f.attr)
            elif isinstance(f, ast.Attribute) \
                    and isinstance(f.value, ast.Name) \
                    and instance_of(fn.module, f.value.id):
                target = graph._method(instance_of(fn.module, f.value.id),
                                       f.attr)
            if isinstance(f, ast.Name) and f.id in aliases:
                out.setdefault(fn.ref, set()).update(aliases[f.id])
            if target is not None:
                out.setdefault(fn.ref, set()).add(target.ref)
    return out


def port_graph(project: Project) -> CallGraph:
    """The call graph the port's rules walk, built once for all rules: the
    base graph plus the capture registry's edges (a run site reaches the
    step functions it replays) and ``receiver_edges``."""
    if "graph" not in project.memo:
        from repro_torch.analysis.capture_registry import registry_of
        graph = CallGraph(project)
        for extra in (registry_of(project).edges(),
                      receiver_edges(project, graph)):
            for ref, callees in extra.items():
                graph.edges.setdefault(ref, set()).update(callees)
        project.memo["graph"] = graph
    return project.memo["graph"]
