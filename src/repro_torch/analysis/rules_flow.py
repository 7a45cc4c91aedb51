"""R5 — device-control-flow (the port's counterpart of traced control
flow).

A Python ``if`` / ``while`` on a CUDA tensor inside a captured step is a
host read of the tensor: on the card it is a sync that fails the capture
(or, in the eager warm-up, a wait the graph then skips); on the CPU it
silently works — the same class of bug that CPU interpret hides in the
JAX package.  This rule finds them statically:

1. seed the device values of every step function of the capture registry:
   the graph's static inputs (``g.inputs()``) and buffers
   (``g.buffers``), and the runner's static state and weights
   (``self.state``, ``self.params``);
2. propagate interprocedurally: a callee parameter becomes device-valued
   when a call from a step (or from a function it reaches) passes it a
   non-static expression, unless its annotation names a host type
   (``guard: bool``, ``plan: Optional[Tuple[bool, bool]]``);
3. in every function with device-valued names, flag ``if`` / ``while``
   whose test is not provably static.

"Static" is what the JAX rule takes: ``.shape`` / ``.dtype`` / ``.device``
and the tensor methods that answer host metadata (``dim()``,
``numel()``, ``data_ptr()``, ...), ``len()`` / ``isinstance()``, ``x is
(not) None``, ``key in tree``, and anything built only from host names.
A test for the card (``_on_cuda(q)``, ``x.is_cuda``) is static too.
"""
from __future__ import annotations

import ast
from collections import deque
from typing import Dict, List, Optional, Set

from repro_torch.analysis.callgraph import port_graph
from repro_torch.analysis.capture_registry import (PARAMS_ATTR, STATE_ATTR,
                                                   registry_of)
from repro_torch.analysis.findings import Finding, finalize_occurrences
from repro_torch.analysis.project import (FunctionInfo, Project, bind_args,
                                          call_name)
from repro_torch.analysis.rules_sync import (META_ATTRS, META_METHODS,
                                             host_annotation)

RULE = "R5"

_STATIC_CALLS = {"len", "isinstance", "hasattr", "callable", "type",
                 "getattr", "range", "id", "repr", "str", "is_tensor",
                 "is_grad_enabled", "_on_cuda", "is_current_stream_capturing",
                 "_records_grad"}


def _is_device_root(n: ast.AST) -> bool:
    """A step's own device values: ``self.state`` / ``self.params``,
    ``<graph>.inputs()`` and ``<graph>.buffers``."""
    if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name) \
            and n.value.id == "self" and n.attr in (STATE_ATTR, PARAMS_ATTR):
        return True
    if isinstance(n, ast.Attribute) and n.attr == "buffers":
        return True
    return isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
        and n.func.attr == "inputs" and not n.args


def _static_properties(project: Project) -> Set[str]:
    """Names of ``@property`` methods of project classes whose value is
    static even on a device instance — ``KVCache.quantized`` returning
    ``self.k_scale is not None``: branching on it is structure, not a
    device value."""
    props: Set[str] = set()
    for fn in project.all_functions():
        node = fn.node
        if fn.class_name is None or not any(
                isinstance(d, ast.Name) and d.id == "property"
                for d in node.decorator_list):
            continue
        rets = [s.value for s in fn.nodes
                if isinstance(s, ast.Return) and s.value is not None]
        if rets and all(_is_static(r, {"self"}, False) for r in rets):
            props.add(node.name)
    return props


def _host_returns(project: Project) -> Set[str]:
    """Names of project functions whose return annotation is host data
    (``sampling_plan(...) -> Tuple[bool, bool]``) or a project
    ``NamedTuple`` (a kernel's launch ``Plan``)."""
    tuples = {name for m in project.modules
              for name, cls in m.classes.items()
              if any(getattr(b, "id", getattr(b, "attr", "")) == "NamedTuple"
                     for b in cls.bases)}
    out: Set[str] = set()
    for fn in project.all_functions():
        ann = fn.node.returns
        if ann is not None and (host_annotation(ann) or (
                isinstance(ann, (ast.Name, ast.Constant))
                and getattr(ann, "id", getattr(ann, "value", None))
                in tuples)):
            out.add(fn.node.name)
    return out


def _is_static(node: ast.AST, traced: Set[str], roots: bool,
               static_attrs: Set[str] = frozenset(),
               host_calls: Set[str] = frozenset()) -> bool:
    def rec(n):
        if n is None or isinstance(n, ast.Constant):
            return True
        if roots and _is_device_root(n):
            return False
        if isinstance(n, ast.Name):
            return n.id not in traced
        if isinstance(n, ast.Attribute):
            if n.attr in META_ATTRS or n.attr in static_attrs:
                return True
            return rec(n.value)
        if isinstance(n, ast.Subscript):
            return rec(n.value) and rec(n.slice)
        if isinstance(n, ast.Call):
            leaf = n.func.attr if isinstance(n.func, ast.Attribute) \
                else call_name(n).split(".")[-1]
            if leaf in _STATIC_CALLS or leaf in META_METHODS \
                    or leaf in host_calls:
                return True
            return (rec(n.func) and all(rec(a) for a in n.args)
                    and all(rec(k.value) for k in n.keywords))
        if isinstance(n, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in n.ops):
                return True             # identity / key membership
            return all(rec(c) for c in [n.left] + n.comparators)
        if isinstance(n, ast.Lambda):
            return True
        if isinstance(n, (ast.BoolOp, ast.BinOp, ast.UnaryOp, ast.IfExp,
                          ast.Tuple, ast.List, ast.Set, ast.Dict,
                          ast.JoinedStr, ast.FormattedValue, ast.Starred,
                          ast.Slice)):
            return all(rec(c) for c in ast.iter_child_nodes(n)
                       if isinstance(c, (ast.expr, ast.Slice)))
        if isinstance(n, (ast.ListComp, ast.SetComp, ast.DictComp,
                          ast.GeneratorExp)):
            # iterating a python container of tensors is host-level: its
            # targets carry the device values into the element
            inner = set(traced)
            for g in n.generators:
                if not _is_static(g.iter, inner, roots, static_attrs,
                                  host_calls):
                    inner |= _target_names(g.target)
            parts = [n.key, n.value] if isinstance(n, ast.DictComp) \
                else [n.elt]
            parts += [c for g in n.generators for c in g.ifs]
            return all(_is_static(c, inner, roots, static_attrs, host_calls)
                       for c in parts)
        return True                     # unknown shapes: stay quiet

    return rec(node)


def _target_names(tgt: ast.expr) -> Set[str]:
    return {n.id for n in ast.walk(tgt) if isinstance(n, ast.Name)}


def _loop_bindings(stmt: ast.For, static):
    """(names, device?) of a for-loop's targets.  Over a literal tuple of
    tuples (``for t, name, nd in ((dt, "dt", 3), ...)``) each target
    position is device-valued only if some row's entry there is."""
    tgt, it = stmt.target, stmt.iter
    if isinstance(tgt, ast.Tuple) and isinstance(it, (ast.Tuple, ast.List)) \
            and it.elts and all(isinstance(r, (ast.Tuple, ast.List))
                                and len(r.elts) == len(tgt.elts)
                                for r in it.elts):
        return [(_target_names(t), any(not static(r.elts[i])
                                       for r in it.elts))
                for i, t in enumerate(tgt.elts)]
    return [(_target_names(tgt), not static(it))]


class FlowChecker:
    def __init__(self, project: Project):
        self.project = project
        self.registry = registry_of(project)
        self.graph = port_graph(project)
        # FunctionInfo.ref -> set of device-valued parameter names
        self.traced_params: Dict[str, Set[str]] = {}
        self.steps = set(self.registry.step_functions)
        self.static_attrs = _static_properties(project)
        self.host_calls = _host_returns(project)
        self.queue = deque()
        for ref in sorted(self.steps):
            self.traced_params.setdefault(ref, set())
            self.queue.append(ref)
        self._fixpoint()

    # ------------------------------------------------------------- seeds
    def _mark(self, fn: Optional[FunctionInfo], params: Set[str]) -> None:
        if fn is None:
            return
        params = {p for p in params
                  if not host_annotation(fn.annotation(p))}
        if not params:
            return
        cur = self.traced_params.setdefault(fn.ref, set())
        if not params <= cur:
            cur |= params
            self.queue.append(fn.ref)

    # ---------------------------------------------------------- fixpoint
    def _fixpoint(self) -> None:
        while self.queue:
            ref = self.queue.popleft()
            fn = self.project.function(ref)
            if fn is None:
                continue
            traced = self._local_traced(fn, self.traced_params[ref],
                                        findings=None)
            self._propagate_calls(fn, traced)

    def _propagate_calls(self, fn: FunctionInfo, traced: Set[str]) -> None:
        roots = fn.ref in self.steps
        for call in fn.calls:
            for callee in self._resolve(fn, call):
                params = callee.positional_params
                if callee.class_name and params[:1] == ["self"]:
                    params = params[1:]         # a bound method's self
                hot = {p for p, arg in bind_args(params, call).items()
                       if not self._static(arg, traced, roots)}
                self._mark(callee, hot)

    def _resolve(self, fn: FunctionInfo, call: ast.Call):
        """The project functions a call reaches (the port's call graph
        resolves constructors, instances and function-valued locals)."""
        f = call.func
        out = []
        target = None
        if isinstance(f, ast.Name):
            target = fn.module.functions.get(f"{fn.qualname}.{f.id}") \
                or self.project.resolve_symbol(fn.module, f.id)
        elif isinstance(f, ast.Attribute):
            if isinstance(f.value, ast.Name) and f.value.id == "self" \
                    and fn.class_name:
                target = self.graph._method(fn.class_name, f.attr)
            else:
                target = self.project.resolve_attr_call(fn.module, f.value,
                                                        f.attr)
        if target is not None:
            out.append(target)
        elif isinstance(f, (ast.Name, ast.Attribute)):
            # instances and aliases: the edges of this function whose
            # name matches the call's
            leaf = f.id if isinstance(f, ast.Name) else f.attr
            for ref in self.graph.edges.get(fn.ref, ()):
                cand = self.project.function(ref)
                if cand is not None and (
                        cand.node.name == leaf
                        or (cand.node.name == "__call__"
                            and isinstance(f, ast.Name))):
                    out.append(cand)
        return out

    def _static(self, node, traced, roots) -> bool:
        return _is_static(node, traced, roots, self.static_attrs,
                          self.host_calls)

    # --------------------------------------------------- per-fn analysis
    def _local_traced(self, fn: FunctionInfo, seed: Set[str],
                      findings: Optional[List[Finding]]) -> Set[str]:
        """Forward pass over the body: returns the final device-name set;
        when ``findings`` is given, flags device if/while tests."""
        traced = set(seed)
        roots = fn.ref in self.steps

        def static(e):
            return self._static(e, traced, roots)

        def visit(body):
            for stmt in body:
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    continue
                if isinstance(stmt, (ast.Assign, ast.AnnAssign,
                                     ast.AugAssign)):
                    value = getattr(stmt, "value", None)
                    targets = stmt.targets \
                        if isinstance(stmt, ast.Assign) else [stmt.target]
                    names = set()
                    for t in targets:
                        names |= _target_names(t)
                    if isinstance(stmt, ast.AugAssign):
                        if not static(value):
                            traced.update(names)
                    elif value is not None and static(value):
                        traced.difference_update(names)
                    elif value is not None:
                        traced.update(names)
                elif isinstance(stmt, ast.For):
                    for names, hot in _loop_bindings(stmt, static):
                        if hot:
                            traced.update(names)
                        else:
                            traced.difference_update(names)
                    visit(stmt.body)
                    visit(stmt.orelse)
                elif isinstance(stmt, (ast.If, ast.While)):
                    if findings is not None and not static(stmt.test):
                        kind = "flow.device-branch" \
                            if isinstance(stmt, ast.If) \
                            else "flow.device-loop"
                        word = "if" if isinstance(stmt, ast.If) \
                            else "while"
                        findings.append(Finding(
                            RULE, fn.module.rel, fn.qualname, kind,
                            f"python `{word} "
                            f"{ast.unparse(stmt.test)}:` branches on a "
                            "device tensor inside a captured step — a sync "
                            "that fails the capture on the card; use "
                            "torch.where, or hold the choice in the "
                            "variant key", stmt.lineno))
                    visit(stmt.body)
                    visit(stmt.orelse)
                elif isinstance(stmt, ast.Try):
                    visit(stmt.body)
                    for h in stmt.handlers:
                        visit(h.body)
                    visit(stmt.orelse)
                    visit(stmt.finalbody)
                elif isinstance(stmt, ast.With):
                    visit(stmt.body)

        visit(fn.node.body)
        return traced

    # ------------------------------------------------------------ report
    def check(self) -> List[Finding]:
        findings: List[Finding] = []
        for ref in sorted(self.traced_params):
            fn = self.project.function(ref)
            if fn is None or not (self.traced_params[ref]
                                  or ref in self.steps):
                continue
            self._local_traced(fn, self.traced_params[ref], findings)
        return findings


def check_device_flow(project: Project) -> List[Finding]:
    return finalize_occurrences(FlowChecker(project).check())
