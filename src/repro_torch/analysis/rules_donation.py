"""R2 — capture-safety (the port's counterpart of donation safety).

A CUDA graph replays the launches its capture recorded on the tensors the
capture saw.  The runner's static state (``self.state``) therefore keeps
its tensors for the runner's life, and a step writes into them; under
CPU tests a replay calls the step function again, so every hazard below
silently works there and gives wrong tokens (or a failed capture) only
on the card.  For the step functions of the capture registry and what
they reach:

* ``capture.state-not-copied-back`` — a step passes the static state to
  a model step and gets a state back (the last element of the returned
  tuple), but that state never reaches ``copy_back``: entries returned
  as new tensors (``seq_lens``, the recurrent state) are lost at replay;
* ``capture.partial-copy-back`` — ``copy_back`` receives a filtered or
  rebuilt dict (``{k: v for k, v in new.items() if k != "seq_lens"}``)
  instead of the returned state itself, or ``copy_back``'s own body
  skips a named entry;
* ``capture.state-rebound`` — an entry of the static state is rebound
  (``self.state[k] = ...``, ``self.state.update(...)``, ``self.state =
  ...`` after ``__init__``) rather than copied into, outside a branch
  where graphs are off (``if self.capture_graphs: ... else: ...``);
* ``capture.lazy-alloc`` — a function a step reaches allocates a tensor
  on its first call and keeps it (``if key not in _CACHE: _CACHE[key] =
  torch.zeros(...)``): memory that must exist before the capture (the
  kernels' scratch and arrival counters), made by the eager warm-up run
  ``StepGraph`` does first;
* ``capture.output-aliases-input`` — a step returns (a view of) one of
  its static inputs, buffers or state entries, which the next staging
  overwrites.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set

from repro_torch.analysis.callgraph import port_graph
from repro_torch.analysis.capture_registry import (COPY_BACK, STATE_ATTR,
                                                   registry_of)
from repro_torch.analysis.findings import Finding, finalize_occurrences
from repro_torch.analysis.project import (FunctionInfo, Project, call_name,
                                          dotted_name, own_statements)

RULE = "R2"

_FACTORIES = {"zeros", "ones", "empty", "full", "arange", "tensor",
              "as_tensor", "zeros_like", "ones_like", "empty_like",
              "full_like", "rand", "randn", "randint"}
# tensor methods that return a view of their receiver
_VIEWS = {"view", "reshape", "narrow", "select", "t", "transpose",
          "permute", "expand", "squeeze", "unsqueeze", "flatten",
          "detach", "as_strided", "unflatten", "view_as", "movedim"}
_REBINDING_METHODS = {"update", "pop", "clear", "setdefault", "popitem"}


def _is_state(node: ast.AST) -> bool:
    """``self.state`` or ``self.<runner>.state``."""
    return isinstance(node, ast.Attribute) and node.attr == STATE_ATTR \
        and dotted_name(node.value) in ("self", "self.runner")


def _mentions_state(node: ast.AST) -> bool:
    return any(_is_state(n) for n in ast.walk(node))


def _graphs_off(test: ast.expr) -> Optional[bool]:
    """True where ``test`` holds only with graphs off (``not
    self.capture_graphs``), False where only with graphs on, else None."""
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        inner = _graphs_off(test.operand)
        return None if inner is None else not inner
    if isinstance(test, ast.Attribute) and test.attr == "capture_graphs":
        return False
    return None


def _torch_alloc(node: ast.AST, project: Project, fn: FunctionInfo) -> bool:
    """Does ``node`` allocate a tensor: a torch factory, or a call of a
    project function that returns one."""
    for c in ast.walk(node):
        if not isinstance(c, ast.Call):
            continue
        name = call_name(c)
        if name.startswith("torch.") and name.split(".")[-1] in _FACTORIES:
            return True
        if isinstance(c.func, ast.Name):
            target = project.resolve_symbol(fn.module, c.func.id)
            if target is not None and any(
                    isinstance(r, ast.Return) and r.value is not None
                    and any(isinstance(x, ast.Call)
                            and call_name(x).startswith("torch.")
                            and call_name(x).split(".")[-1] in _FACTORIES
                            for x in ast.walk(r.value))
                    for r in target.nodes):
                return True
    return False


class CaptureChecker:
    def __init__(self, project: Project):
        self.project = project
        self.registry = registry_of(project)
        self.graph = port_graph(project)

    def check(self) -> List[Finding]:
        out: List[Finding] = []
        steps = list(self.registry.step_functions.values())
        for fn in steps:
            self._check_copy_back(fn, out)
            self._check_output(fn, out)
        for fn in self.project.all_functions():
            self._check_rebind(fn, out)
            if fn.node.name == COPY_BACK:
                self._check_copy_back_def(fn, out)
        reached = self.graph.reachable([f.ref for f in steps])
        for ref in sorted(reached):
            fn = self.project.function(ref)
            if fn is not None:
                self._check_lazy(fn, out)
        return out

    def _add(self, out, fn, kind, detail, node) -> None:
        out.append(Finding(RULE, fn.module.rel, fn.qualname, kind, detail,
                           getattr(node, "lineno", fn.node.lineno)))

    # ------------------------------------------------------- copy-back
    def _copy_backs(self, fn: FunctionInfo) -> List[ast.Call]:
        return [c for f, c in self.registry.copy_backs if f is fn]

    def _check_copy_back(self, fn: FunctionInfo, out) -> None:
        """A step's returned state reaches ``copy_back`` whole."""
        passed: Set[str] = set()
        for call in self._copy_backs(fn):
            if len(call.args) < 2:
                continue
            new = call.args[1]
            whole = isinstance(new, ast.Name) or (
                isinstance(new, ast.Call) and len(new.args) == 1
                and not new.keywords and isinstance(new.args[0], ast.Name)
                and call_name(new) != "dict")
            if not whole:
                self._add(out, fn, "capture.partial-copy-back",
                          f"`{ast.unparse(call)}` copies back a rebuilt "
                          "state, not the one the step returned: an entry "
                          "it leaves out keeps the value its capture saw "
                          "at every replay", call)
            passed |= {n.id for n in ast.walk(new)
                       if isinstance(n, ast.Name)}
        for stmt in own_statements(fn.node):
            if not (isinstance(stmt, ast.Assign)
                    and isinstance(stmt.value, ast.Call)
                    and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Tuple)
                    and any(_mentions_state(a) for a in
                            list(stmt.value.args)
                            + [k.value for k in stmt.value.keywords])):
                continue
            last = stmt.targets[0].elts[-1]
            if isinstance(last, ast.Name) and last.id not in passed:
                self._add(out, fn, "capture.state-not-copied-back",
                          f"`{last.id}`, the state "
                          f"`{call_name(stmt.value)}` returns, never "
                          "reaches copy_back: what it returns anew is lost "
                          "at every replay", stmt)

    def _check_copy_back_def(self, fn: FunctionInfo, out) -> None:
        """``copy_back`` itself copies every returned entry: no test
        against a named key."""
        for node in fn.nodes:
            if isinstance(node, ast.Compare) and any(
                    isinstance(c, ast.Constant) and isinstance(c.value, str)
                    for c in [node.left] + node.comparators):
                self._add(out, fn, "capture.partial-copy-back",
                          f"`{ast.unparse(node)}`: copy_back skips a named "
                          "entry of the returned state", node)

    # ---------------------------------------------------------- rebind
    def _check_rebind(self, fn: FunctionInfo, out) -> None:
        if fn.node.name == "__init__":
            return

        def visit(body, off: bool):
            for stmt in body:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if isinstance(stmt, ast.If):
                    side = _graphs_off(stmt.test)
                    visit(stmt.body, off or side is True)
                    visit(stmt.orelse, off or side is False)
                    continue
                if not off:
                    self._rebinds(fn, stmt, out)
                for name in ("body", "orelse", "finalbody"):
                    visit(getattr(stmt, name, []) or [], off)
                for h in getattr(stmt, "handlers", []) or []:
                    visit(h.body, off)

        visit(fn.node.body, False)

    def _rebinds(self, fn, stmt, out) -> None:
        targets = []
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = stmt.targets if isinstance(stmt, ast.Assign) \
                else [stmt.target]
        elif isinstance(stmt, ast.Delete):
            targets = stmt.targets
        for t in targets:
            for e in (t.elts if isinstance(t, ast.Tuple) else [t]):
                if _is_state(e) or (isinstance(e, ast.Subscript)
                                    and _is_state(e.value)):
                    self._add(out, fn, "capture.state-rebound",
                              f"`{ast.unparse(e)}` is rebound: a captured "
                              "graph keeps reading the tensor it saw (copy "
                              "into it, or step_graph.copy_back)", stmt)
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            f = stmt.value.func
            if isinstance(f, ast.Attribute) and f.attr in _REBINDING_METHODS \
                    and _is_state(f.value):
                self._add(out, fn, "capture.state-rebound",
                          f"`{ast.unparse(stmt.value)}` rebinds entries of "
                          "the static state: a captured graph keeps "
                          "reading the tensors it saw", stmt)

    # ------------------------------------------------------------ lazy
    def _check_lazy(self, fn: FunctionInfo, out) -> None:
        """A cache filled on the first call: an ``if`` whose body stores a
        new tensor into a subscript of a module global or into
        ``self.<attr>``."""
        globals_ = {t.id for s in fn.module.tree.body
                    if isinstance(s, (ast.Assign, ast.AnnAssign))
                    for t in (s.targets if isinstance(s, ast.Assign)
                              else [s.target])
                    if isinstance(t, ast.Name)}
        for stmt in own_statements(fn.node):
            if not isinstance(stmt, ast.If):
                continue
            for sub in stmt.body:
                if not isinstance(sub, ast.Assign) \
                        or not _torch_alloc(sub.value, self.project, fn):
                    continue
                for t in sub.targets:
                    cache = (isinstance(t, ast.Subscript)
                             and isinstance(t.value, ast.Name)
                             and t.value.id in globals_) or (
                        isinstance(t, ast.Attribute)
                        and dotted_name(t.value) == "self")
                    if cache:
                        self._add(out, fn, "capture.lazy-alloc",
                                  f"`{ast.unparse(t)}` is allocated at the "
                                  "first call and kept: it must exist "
                                  "before a capture (the warm-up run makes "
                                  "it)", sub)

    # ---------------------------------------------------------- output
    def _check_output(self, fn: FunctionInfo, out) -> None:
        static: Set[str] = set()
        for stmt in own_statements(fn.node):
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name) \
                    and self._static_view(stmt.value, static, inputs=True):
                static.add(stmt.targets[0].id)
        for stmt in own_statements(fn.node):
            if isinstance(stmt, ast.Return) and stmt.value is not None \
                    and self._static_view(stmt.value, static):
                self._add(out, fn, "capture.output-aliases-input",
                          f"`return {ast.unparse(stmt.value)}` hands out a "
                          "view of a static input, buffer or state entry: "
                          "the next staging overwrites it", stmt)

    def _static_view(self, node: ast.AST, static: Set[str],
                     inputs: bool = False) -> bool:
        """``node`` is a static tensor (or a view of one): a name bound to
        the graph's inputs, ``g.buffers[...]``, ``self.state[...]``, or a
        subscript / view method of one."""
        if isinstance(node, ast.Name):
            return node.id in static
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute):
            if node.func.attr == "inputs" and inputs:
                return True
            if node.func.attr in _VIEWS:
                return self._static_view(node.func.value, static)
            return False
        if isinstance(node, ast.Subscript):
            base = node.value
            if isinstance(base, ast.Attribute) and base.attr == "buffers":
                return True
            if _is_state(base):
                return True
            return self._static_view(base, static)
        if isinstance(node, ast.Attribute) and node.attr in ("T", "mT"):
            return self._static_view(node.value, static)
        return False


def check_capture(project: Project) -> List[Finding]:
    return finalize_occurrences(CaptureChecker(project).check())
