"""R1 — host-sync-in-hot-path.

Taint analysis over the serving hot loop (``ServingEngine.step`` /
``stream`` / ``run_until_done`` and everything they reach, the captured
step functions included): CUDA tensors are DEVICE, and reading one on the
host blocks the host until the stream has produced it.  Sinks flagged:

* ``x.item()`` / ``x.tolist()`` / ``x.cpu()`` / ``x.numpy()`` /
  ``x.to("cpu")`` and ``np.asarray(x)`` / ``np.array(x)``;
* ``int(x)`` / ``float(x)`` / ``bool(x)``, branching on ``x`` and
  iterating over ``x``;
* ops whose output shape depends on the data (``nonzero``, ``unique``,
  ``masked_select``, one-argument ``where``, ``argwhere``, indexing with
  a device boolean mask);
* ``torch.cuda.synchronize`` and every ``.synchronize()`` (a stream or an
  event: the host waits however little is left).

DEVICE values come from: a graph's ``run(key)`` (the capture registry),
the runner's static state and weights (``self.state``, ``self.params``,
``runner.state``), torch factories given a device other than the CPU,
``.cuda()`` / ``.to(<device>)``, and torch ops or tensor methods applied
to a DEVICE value.  numpy, Python scalars, ``.shape`` / ``.dtype`` /
``.device`` and ``is None`` are HOST.  Only *definitely-device* values
fire — UNKNOWN stays silent, so the scheduler's host bookkeeping
produces no noise.  A branch that tests for the card (``self.cuda``,
``x.is_cuda``, ``x.device.type == "cuda"``, ``ops._on_cuda``) is read on
its CUDA side only: the CPU side is the tests' plain path.

Cross-function precision comes from summaries (every project function's
return taint, including the "returns the result of calling its callable
parameter" shape of ``self._protected(rids, lambda: ...)``) and from
parameter taints: a parameter that every hot call site feeds a DEVICE
value (and none a HOST one) is DEVICE in the callee, unless its
annotation names a host type (``bool``, ``int``, ``Tuple[bool, bool]``).
The planned syncs — the pinned readback's event wait and the staging
buffer's reuse wait — are findings carried in
``analysis/baseline_torch.json`` with justifications; anything new is
creep the gate refuses.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional

from repro_torch.analysis.callgraph import port_graph
from repro_torch.analysis.capture_registry import (PARAMS_ATTR, STATE_ATTR,
                                                   registry_of)
from repro_torch.analysis.findings import Finding, finalize_occurrences
from repro_torch.analysis.project import (FunctionInfo, Project, call_name,
                                          dotted_name)

RULE = "R1"

DEVICE, HOST, UNKNOWN = "device", "host", "unknown"

# attribute reads that are host metadata even on a device tensor
META_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
              "requires_grad", "is_leaf", "itemsize", "grad_fn", "type",
              "index"}
# tensor methods that return host metadata
META_METHODS = {"dim", "size", "numel", "stride", "data_ptr",
                "element_size", "is_contiguous", "is_floating_point",
                "get_device", "nelement", "storage_offset", "nbytes"}
# tensor -> host copies (each blocks on the stream)
_COPY_METHODS = {"item", "tolist", "cpu", "numpy"}
_CAST_SINKS = {"int", "float", "bool"}
_DICT_VIEWS = {"keys", "values", "items"}
_NP_COPY_SINKS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
# ops whose output shape depends on the values: a sync to size the output
_DATA_SHAPED = {"nonzero", "unique", "unique_consecutive", "masked_select",
                "argwhere"}
_FACTORIES = {"zeros", "ones", "empty", "full", "arange", "tensor",
              "as_tensor", "rand", "randn", "randint", "linspace", "eye",
              "zeros_like", "ones_like", "empty_like", "full_like"}
_HOST_ROOTS = ("np.", "numpy.", "math.", "time.", "os.")
_HOST_BUILTINS = {"len", "sorted", "sum", "max", "min", "abs", "str",
                  "repr", "round", "isinstance", "hasattr", "id"}
# torch calls that answer a host question about their argument
_TORCH_HOST = {"torch.is_tensor", "torch.is_floating_point",
               "torch.is_grad_enabled", "torch.numel",
               "torch.cuda.is_current_stream_capturing",
               "torch.cuda.is_available", "torch.cuda.current_stream",
               "torch.cuda.get_device_properties"}
# annotations that make a parameter host data whatever it is fed
_HOST_ANNOTATIONS = {"bool", "int", "float", "str", "Tuple", "tuple",
                     "ModelConfig", "Sequence", "List", "list", "Set",
                     "np.ndarray", "ndarray"}


class Tup:
    """Taint of a tuple value (elementwise)."""
    def __init__(self, elts):
        self.elts = list(elts)


class ListOf:
    """Taint of a homogeneous container (element taint)."""
    def __init__(self, item):
        self.item = item


class DictOf:
    """Taint of a dict keyed by host names (value taint): the state, the
    weights, a dispatch's uploads.  Its keys are host data."""
    def __init__(self, item):
        self.item = item


_COMPOUND = (Tup, ListOf, DictOf)


def _join(a, b):
    if isinstance(a, Tup) and isinstance(b, Tup) \
            and len(a.elts) == len(b.elts):
        return Tup([_join(x, y) for x, y in zip(a.elts, b.elts)])
    if isinstance(a, ListOf) and isinstance(b, ListOf):
        return ListOf(_join(a.item, b.item))
    if isinstance(a, DictOf) and isinstance(b, DictOf):
        return DictOf(_join(a.item, b.item))
    if a == b:
        return a
    # host vs device (or compound) disagree -> unknown (silent)
    return UNKNOWN


def _scalar(t):
    """Collapse compound taints for contexts that need a plain one."""
    if isinstance(t, Tup):
        if any(_scalar(e) == DEVICE for e in t.elts):
            return DEVICE
        return UNKNOWN if any(_scalar(e) == UNKNOWN for e in t.elts) else HOST
    if isinstance(t, (ListOf, DictOf)):
        return _scalar(t.item)
    return t


def host_annotation(ann: Optional[ast.expr]) -> bool:
    """Whether a parameter's annotation names host data only (a bool, an
    int, a tuple of them, an Optional of one, a config)."""
    if ann is None:
        return False
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return False
    names = {dotted_name(n) for n in ast.walk(ann)
             if isinstance(n, (ast.Name, ast.Attribute))}
    names.discard("")
    names -= {"Optional", "typing.Optional"}
    if not names:
        return False
    leaves = {n for n in names if not any(
        m != n and m.startswith(n + ".") for m in names)}
    return all(n in _HOST_ANNOTATIONS or n.split(".")[-1]
               in _HOST_ANNOTATIONS for n in leaves)


def cuda_test(test: ast.expr) -> Optional[bool]:
    """True if ``test`` holds exactly on the card (``self.cuda``,
    ``x.is_cuda``, ``x.device.type == "cuda"``, ``_on_cuda(x)``), False if
    it holds exactly on the CPU (its negation, ``... == "cpu"``), None for
    any other test."""
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        inner = cuda_test(test.operand)
        return None if inner is None else not inner
    if isinstance(test, ast.Attribute) and test.attr in ("cuda", "is_cuda"):
        return True
    if isinstance(test, ast.Call) and call_name(test).split(".")[-1] in (
            "_on_cuda", "is_available"):
        return True
    if isinstance(test, ast.Compare) and len(test.ops) == 1 \
            and isinstance(test.comparators[0], ast.Constant) \
            and dotted_name(test.left).endswith("type"):
        val = test.comparators[0].value
        if val not in ("cuda", "cpu"):
            return None
        eq = isinstance(test.ops[0], ast.Eq)
        if not eq and not isinstance(test.ops[0], ast.NotEq):
            return None
        return eq == (val == "cuda")
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        for v in test.values:
            if cuda_test(v) is True:
                return True
    return None


def _cpu_literal(node: ast.expr) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant) and node.value == "cpu":
        return True
    return isinstance(node, ast.Call) and call_name(node) == "torch.device" \
        and bool(node.args) and isinstance(node.args[0], ast.Constant) \
        and node.args[0].value == "cpu"


class _Summary:
    """Per-function summary: return taint, or 'calls param i'."""
    def __init__(self):
        self.ret = UNKNOWN
        self.calls_param: Optional[int] = None  # positional index incl self


class SyncAnalyzer:
    def __init__(self, project: Project):
        self.project = project
        self.registry = registry_of(project)
        self.graph = port_graph(project)
        self.run_calls = {id(r.call) for r in self.registry.runs}
        self.hot = self.graph.reachable(project.roots) \
            if project.roots else set()
        self.summaries: Dict[str, _Summary] = {}
        # ref -> {param -> taint} fed by the hot call sites
        self.param_taint: Dict[str, Dict[str, object]] = {}
        self._sites: Dict[str, Dict[str, list]] = {}
        self._detect_param_calls()
        for _ in range(3):                      # summary fixpoint
            self._sites = {}
            for ref in sorted(self.hot):     # only hot callers use them
                fn = project.function(ref)
                if fn is not None:
                    self._summarize(fn)
            self._settle_params()

    # ------------------------------------------------------- summaries
    def _detect_param_calls(self) -> None:
        for fn in self.project.all_functions():
            s = self.summaries.setdefault(fn.ref, _Summary())
            params = fn.positional_params
            for node in fn.nodes:
                if (isinstance(node, ast.Return) and node.value is not None
                        and isinstance(node.value, ast.Call)
                        and isinstance(node.value.func, ast.Name)
                        and node.value.func.id in params):
                    s.calls_param = params.index(node.value.func.id)

    def _seed_env(self, fn: FunctionInfo) -> Dict[str, object]:
        return dict(self.param_taint.get(fn.ref, {}))

    def _summarize(self, fn: FunctionInfo) -> None:
        env = self._seed_env(fn)
        rets: List[object] = []
        self._walk_body(fn, list(fn.node.body), env, rets, findings=None)
        s = self.summaries.setdefault(fn.ref, _Summary())
        if rets:
            out = rets[0]
            for r in rets[1:]:
                out = _join(out, r)
            s.ret = out

    def _record_site(self, fn, target: FunctionInfo, node: ast.Call,
                     args: list, kw: Dict[str, object]) -> None:
        """Remember the taints a hot call site feeds ``target``'s
        params (lambdas inside a hot function count as hot)."""
        if fn.ref not in self.hot:
            return
        params = target.positional_params
        offset = 1 if target.class_name is not None \
            and params[:1] == ["self"] and isinstance(node.func,
                                                      ast.Attribute) else 0
        sites = self._sites.setdefault(target.ref, {})
        for i, t in enumerate(args):
            if isinstance(node.args[i], ast.Starred):
                break
            if i + offset < len(params):
                sites.setdefault(params[i + offset], []).append(t)
        for name, t in kw.items():
            sites.setdefault(name, []).append(t)

    def _settle_params(self) -> None:
        self.param_taint = {}
        for ref, sites in self._sites.items():
            fn = self.project.function(ref)
            env = {}
            for name, taints in sites.items():
                scal = [_scalar(t) for t in taints]
                if fn is not None and host_annotation(fn.annotation(name)):
                    env[name] = HOST
                elif DEVICE in scal and HOST not in scal:
                    env[name] = DictOf(DEVICE) if any(
                        isinstance(t, DictOf) for t in taints) else DEVICE
            self.param_taint[ref] = env

    # ------------------------------------------------------ entry point
    def hot_findings(self) -> List[Finding]:
        findings: List[Finding] = []
        for ref in sorted(self.hot):
            fn = self.project.function(ref)
            if fn is None:
                continue
            env = self._seed_env(fn)
            self._walk_body(fn, list(fn.node.body), env, rets=[],
                            findings=(findings, fn))
        return findings

    # ------------------------------------------------------- statements
    def _walk_body(self, fn, body, env, rets, findings) -> None:
        for stmt in body:
            self._stmt(fn, stmt, env, rets, findings)
            if isinstance(stmt, ast.If) and cuda_test(stmt.test) is True \
                    and stmt.body and isinstance(stmt.body[-1],
                                                 (ast.Return, ast.Raise)):
                return          # what follows is the CPU's plain path

    def _stmt(self, fn, stmt, env, rets, findings) -> None:
        ev = lambda e: self._eval(fn, e, env, findings)
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            value = getattr(stmt, "value", None)
            t = ev(value) if value is not None else UNKNOWN
            targets = stmt.targets if isinstance(stmt, ast.Assign) \
                else [stmt.target]
            for tgt in targets:
                self._bind(tgt, t, env)
        elif isinstance(stmt, ast.Expr):
            val = stmt.value
            # container building: x.append((a, b)) refines x's taint
            if (isinstance(val, ast.Call)
                    and isinstance(val.func, ast.Attribute)
                    and val.func.attr == "append"
                    and isinstance(val.func.value, ast.Name)
                    and len(val.args) == 1):
                item = ev(val.args[0])
                name = val.func.value.id
                prev = env.get(name)
                if isinstance(prev, ListOf):
                    env[name] = ListOf(_join(prev.item, item)
                                       if prev.item != UNKNOWN else item)
                else:
                    env[name] = ListOf(item)
            else:
                ev(val)
        elif isinstance(stmt, ast.Return):
            if stmt.value is not None:
                rets.append(ev(stmt.value))
        elif isinstance(stmt, ast.For):
            it = ev(stmt.iter)
            if _scalar(it) == DEVICE and not isinstance(it, _COMPOUND):
                self._report(findings, stmt.iter, "sync.iterate",
                             "iterating a device tensor syncs per element: "
                             f"`for ... in {ast.unparse(stmt.iter)}`")
            self._bind_iter(stmt.target, it, env)
            self._walk_body(fn, stmt.body, env, rets, findings)
            self._walk_body(fn, stmt.orelse, env, rets, findings)
        elif isinstance(stmt, (ast.If, ast.While)):
            side = cuda_test(stmt.test) if isinstance(stmt, ast.If) \
                else None
            if side is None:
                t = ev(stmt.test)
                if _scalar(t) == DEVICE \
                        and not isinstance(t, _COMPOUND):
                    self._report(findings, stmt.test, "sync.implicit-bool",
                                 "branching on a device tensor forces a "
                                 f"sync: `{ast.unparse(stmt.test)}`")
                self._walk_body(fn, stmt.body, env, rets, findings)
                self._walk_body(fn, stmt.orelse, env, rets, findings)
            else:
                # the card's side only; the other is the CPU's plain path
                self._walk_body(fn, stmt.body if side else stmt.orelse,
                                env, rets, findings)
        elif isinstance(stmt, ast.Try):
            self._walk_body(fn, stmt.body, env, rets, findings)
            for h in stmt.handlers:
                self._walk_body(fn, h.body, env, rets, findings)
            self._walk_body(fn, stmt.orelse, env, rets, findings)
            self._walk_body(fn, stmt.finalbody, env, rets, findings)
        elif isinstance(stmt, ast.With):
            for item in stmt.items:
                ev(item.context_expr)
            self._walk_body(fn, stmt.body, env, rets, findings)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            pass                    # nested defs analyzed via their own ref
        else:
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    ev(child)

    def _bind(self, tgt, t, env) -> None:
        if isinstance(tgt, ast.Name):
            env[tgt.id] = t
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            elts = t.elts if isinstance(t, Tup) \
                and len(t.elts) == len(tgt.elts) \
                else [_scalar(t) if _scalar(t) == DEVICE else UNKNOWN] \
                * len(tgt.elts)
            for e_tgt, e_t in zip(tgt.elts, elts):
                self._bind(e_tgt, e_t, env)
        # attribute / subscript stores: no attr env

    def _bind_iter(self, tgt, it, env) -> None:
        """Bind a for-loop target from the iterable's taint."""
        if isinstance(it, ListOf):
            self._bind(tgt, it.item, env)
        elif isinstance(it, DictOf):
            self._bind(tgt, HOST, env)          # a dict iterates its keys
        elif _scalar(it) in (DEVICE, HOST):
            self._bind(tgt, _scalar(it), env)
        else:
            self._bind(tgt, UNKNOWN, env)

    # ------------------------------------------------------ expressions
    def _static_state(self, fn, node) -> bool:
        """``self.state`` / ``self.params`` of a runner, or
        ``self.<attr>.state`` where the attribute holds a runner."""
        if not isinstance(node, ast.Attribute) \
                or node.attr not in (STATE_ATTR, PARAMS_ATTR):
            return False
        base = node.value
        if isinstance(base, ast.Name) and base.id == "self":
            return self.registry.is_runner(fn.class_name)
        if isinstance(base, ast.Attribute) \
                and isinstance(base.value, ast.Name) \
                and base.value.id == "self" and fn.class_name:
            attr_cls = self.graph.attr_types.get(fn.class_name, {}).get(
                base.attr)
            return node.attr == STATE_ATTR \
                and self.registry.is_runner(attr_cls)
        return False

    def _eval(self, fn, node, env, findings):
        if node is None:
            return UNKNOWN
        if isinstance(node, ast.Constant):
            return HOST
        if isinstance(node, ast.Name):
            return env.get(node.id, UNKNOWN)
        if isinstance(node, ast.Tuple):
            return Tup([self._eval(fn, e, env, findings)
                        for e in node.elts])
        if isinstance(node, ast.List):
            item = UNKNOWN
            for e in node.elts:
                t = self._eval(fn, e, env, findings)
                item = _join(item, t) if item != UNKNOWN else t
            return ListOf(item)
        if isinstance(node, ast.Dict):
            item = None
            for k, v in zip(node.keys, node.values):
                t = self._eval(fn, v, env, findings)
                if k is None:                      # ``**other``
                    t = t.item if isinstance(t, DictOf) else UNKNOWN
                item = t if item is None else _join(item, t)
            return DictOf(UNKNOWN if item is None else item)
        if isinstance(node, ast.DictComp):
            local = dict(env)
            for gen in node.generators:
                it = self._eval(fn, gen.iter, local, findings)
                self._bind_iter(gen.target, it, local)
            self._eval(fn, node.key, local, findings)
            return DictOf(self._eval(fn, node.value, local, findings))
        if isinstance(node, ast.Set):
            for child in ast.walk(node):
                if isinstance(child, ast.Call):
                    self._eval(fn, child, env, findings)
            return UNKNOWN
        if isinstance(node, ast.Attribute):
            if self._static_state(fn, node):
                return DictOf(DEVICE)
            if node.attr in META_ATTRS:
                self._eval(fn, node.value, env, findings)
                return HOST
            base = self._eval(fn, node.value, env, findings)
            return DEVICE if _scalar(base) == DEVICE else UNKNOWN
        if isinstance(node, ast.Subscript):
            base = self._eval(fn, node.value, env, findings)
            idx = self._eval(fn, node.slice, env, findings)
            if isinstance(base, (ListOf, DictOf)):
                return base.item
            if isinstance(base, Tup):
                if isinstance(node.slice, ast.Constant) \
                        and isinstance(node.slice.value, int) \
                        and 0 <= node.slice.value < len(base.elts):
                    return base.elts[node.slice.value]
                return _scalar(base)
            if base == DEVICE and _scalar(idx) == DEVICE \
                    and self._bool_mask(node.slice, env):
                self._report(findings, node, "sync.mask-index",
                             f"`{ast.unparse(node)}` indexes with a device "
                             "boolean mask: its output size is read back")
            return _scalar(base) if _scalar(base) in (DEVICE, HOST) \
                else UNKNOWN
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            # `not x` on a python container is host truthiness; only a
            # bare device scalar would sync (reported via the If branch)
            t = self._eval(fn, node.operand, env, findings)
            return HOST if isinstance(t, _COMPOUND) else _scalar(t)
        if isinstance(node, ast.Compare) and all(
                isinstance(op, (ast.In, ast.NotIn, ast.Is, ast.IsNot))
                for op in node.ops):
            # membership / identity: dict-key and None checks are
            # host-level even when the container holds device tensors
            for c in [node.left] + node.comparators:
                self._eval(fn, c, env, findings)
            return HOST
        if isinstance(node, (ast.BinOp, ast.UnaryOp, ast.BoolOp,
                             ast.Compare, ast.IfExp)):
            parts = [self._eval(fn, c, env, findings)
                     for c in ast.iter_child_nodes(node)
                     if isinstance(c, ast.expr)]
            scal = [_scalar(p) for p in parts]
            if DEVICE in scal:
                return DEVICE
            if scal and all(s == HOST for s in scal):
                return HOST
            return UNKNOWN
        if isinstance(node, (ast.ListComp, ast.GeneratorExp, ast.SetComp)):
            local = dict(env)
            for gen in node.generators:
                it = self._eval(fn, gen.iter, local, findings)
                self._bind_iter(gen.target, it, local)
            return ListOf(self._eval(fn, node.elt, local, findings))
        if isinstance(node, ast.Lambda):
            return UNKNOWN          # evaluated at its call site
        if isinstance(node, ast.Starred):
            return self._eval(fn, node.value, env, findings)
        if isinstance(node, ast.Call):
            return self._call(fn, node, env, findings)
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._eval(fn, child, env, findings)
        return UNKNOWN

    @staticmethod
    def _bool_mask(index: ast.expr, env) -> bool:
        """A comparison or logical negation used as an index: a boolean
        mask (``x[x > 0]``, ``x[~done]``)."""
        return isinstance(index, ast.Compare) or (
            isinstance(index, ast.UnaryOp)
            and isinstance(index.op, ast.Invert))

    # ------------------------------------------------------------ calls
    def _device_kw(self, fn, node, env, findings) -> Optional[str]:
        """The taint a factory's ``device=`` / ``pin_memory=`` gives."""
        kw = {k.arg: k.value for k in node.keywords if k.arg}
        pin = kw.get("pin_memory")
        if isinstance(pin, ast.Constant) and pin.value is True:
            return HOST
        dev = kw.get("device")
        if dev is None:
            return None
        return HOST if _cpu_literal(dev) else DEVICE

    def _call(self, fn, node, env, findings):
        name = call_name(node)
        leaf = node.func.attr if isinstance(node.func, ast.Attribute) \
            else name
        args = [self._eval(fn, a, env, findings) for a in node.args]
        kw = {k.arg: self._eval(fn, k.value, env, findings)
              for k in node.keywords if k.arg}
        for k in node.keywords:
            if k.arg is None:
                self._eval(fn, k.value, env, findings)
        arg0 = args[0] if args else UNKNOWN
        any_dev = any(_scalar(a) == DEVICE for a in args + list(kw.values()))

        # ---- sinks -----------------------------------------------------
        if name in ("torch.cuda.synchronize", "cuda.synchronize") \
                or (leaf == "synchronize"
                    and isinstance(node.func, ast.Attribute)):
            self._report(findings, node, "sync.synchronize",
                         f"`{ast.unparse(node)}` blocks the host on the "
                         "device")
            return UNKNOWN
        if name in _NP_COPY_SINKS and _scalar(arg0) == DEVICE:
            self._report(findings, node, "sync.np.asarray",
                         f"`{ast.unparse(node)}` copies a device tensor to "
                         "the host (blocks on the stream)")
            return HOST
        if name in ("torch.equal", "torch.allclose") and any_dev:
            self._report(findings, node, "sync.cast",
                         f"`{ast.unparse(node)}` answers a python bool from "
                         "device tensors (host sync)")
            return HOST
        if name in _CAST_SINKS and len(node.args) == 1:
            if _scalar(arg0) == DEVICE:
                self._report(
                    findings, node, "sync.cast",
                    f"`{ast.unparse(node)}` collapses a device tensor to a "
                    "python scalar (host sync)")
            return HOST
        if isinstance(node.func, ast.Attribute):
            base = self._eval(fn, node.func.value, env, findings)
            if isinstance(base, DictOf):
                if leaf in _DICT_VIEWS:
                    return ListOf({"keys": HOST, "values": base.item,
                                   "items": Tup([HOST, base.item])}[leaf])
                if leaf in ("get", "pop"):
                    return base.item
                if leaf == "copy":
                    return base
                return UNKNOWN
            on_dev = _scalar(base) == DEVICE
            if leaf in _COPY_METHODS:
                if on_dev:
                    self._report(
                        findings, node, f"sync.{leaf}",
                        f"`{ast.unparse(node)}` copies a device tensor to "
                        "the host")
                return HOST
            if leaf == "to" and self._to_cpu(node):
                if on_dev:
                    self._report(
                        findings, node, "sync.cpu",
                        f"`{ast.unparse(node)}` copies a device tensor to "
                        "the host")
                return HOST
            if on_dev and leaf in META_METHODS:
                return HOST
            if leaf in _DATA_SHAPED and (on_dev or (
                    name.startswith("torch.") and _scalar(arg0) == DEVICE)):
                self._report(findings, node, f"sync.{leaf}",
                             f"`{ast.unparse(node)}` has an output shape "
                             "that depends on the data (a host sync)")
                return DEVICE
            if name in ("torch.where", "where") and len(node.args) == 1 \
                    and _scalar(arg0) == DEVICE:
                self._report(findings, node, "sync.nonzero",
                             f"`{ast.unparse(node)}` with one argument is "
                             "nonzero (a host sync)")
                return DEVICE
            if leaf in ("cuda",) and not name.startswith("torch."):
                return DEVICE
            if leaf == "to" and self._to_device(node):
                return DEVICE
            if on_dev and not name.startswith(("torch.", "np.", "self.")):
                return DEVICE               # a tensor method on a device value

        # ---- sources ---------------------------------------------------
        if id(node) in self.run_calls:
            return DEVICE
        if name.startswith("torch."):
            if name in ("torch.from_numpy",) or name in _TORCH_HOST:
                return HOST
            if leaf in _FACTORIES:
                t = self._device_kw(fn, node, env, findings)
                if t is not None:
                    return t
                if leaf.endswith("_like"):
                    return _scalar(arg0) if _scalar(arg0) == DEVICE \
                        else UNKNOWN
                return HOST if leaf in ("tensor", "as_tensor") \
                    and not any_dev else UNKNOWN
            return DEVICE if any_dev else UNKNOWN
        if name.startswith(_HOST_ROOTS) or name in _HOST_BUILTINS:
            return HOST
        if name == "dict":
            item = None
            for t in args + list(kw.values()):
                t = t.item if isinstance(t, DictOf) else t
                item = t if item is None else _join(item, t)
            return DictOf(UNKNOWN if item is None else item)
        if name == "enumerate" and args:
            return ListOf(Tup([HOST, args[0].item
                               if isinstance(args[0], ListOf)
                               else _scalar(args[0])]))
        if name == "range":
            return ListOf(HOST)
        if name == "zip" and args:
            return ListOf(Tup([a.item if isinstance(a, ListOf) else UNKNOWN
                               for a in args]))
        if name in ("list", "tuple") and args:
            return args[0] if isinstance(args[0], (ListOf, Tup)) else UNKNOWN

        target = self._target(fn, node)
        if target is not None:
            self._record_site(fn, target, node, args, kw)
            return self._apply_summary(fn, target, node, env, findings)
        return UNKNOWN

    @staticmethod
    def _to_cpu(node: ast.Call) -> bool:
        return any(_cpu_literal(a) for a in list(node.args) + [
            k.value for k in node.keywords if k.arg == "device"])

    @staticmethod
    def _to_device(node: ast.Call) -> bool:
        """``.to(<device>)``: a device keyword, a device string, or a
        ``<tensor>.device`` (the card's path: the port's entry points run
        on the card unless a test asks for the CPU)."""
        for a in list(node.args) + [k.value for k in node.keywords
                                    if k.arg == "device"]:
            if _cpu_literal(a):
                return False
            if (isinstance(a, ast.Constant) and isinstance(a.value, str)
                    and a.value.startswith("cuda")) \
                    or (isinstance(a, ast.Attribute) and a.attr == "device") \
                    or (isinstance(a, ast.Name) and "dev" in a.id):
                return True
        return any(k.arg == "device" for k in node.keywords)

    def _target(self, fn, node) -> Optional[FunctionInfo]:
        f = node.func
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.value.id == "self" and fn.class_name:
            return self.graph._method(fn.class_name, f.attr)
        if isinstance(f, ast.Attribute) \
                and isinstance(f.value, ast.Attribute) \
                and isinstance(f.value.value, ast.Name) \
                and f.value.value.id == "self" and fn.class_name:
            attr_cls = self.graph.attr_types.get(fn.class_name, {}).get(
                f.value.attr)
            return self.graph._method(attr_cls, f.attr) if attr_cls \
                else None
        if isinstance(f, ast.Name):
            return fn.module.functions.get(f"{fn.qualname}.{f.id}") \
                or self.project.resolve_symbol(fn.module, f.id)
        if isinstance(f, ast.Attribute):
            return self.project.resolve_attr_call(fn.module, f.value,
                                                  f.attr)
        return None

    def _apply_summary(self, fn, target, node, env, findings):
        s = self.summaries.get(target.ref)
        if s is None:
            return UNKNOWN
        if s.calls_param is not None:
            # map the callable argument (account for the bound self)
            idx = s.calls_param
            if target.class_name is not None \
                    and target.positional_params[:1] == ["self"]:
                idx -= 1
            if 0 <= idx < len(node.args):
                cb = node.args[idx]
                if isinstance(cb, ast.Lambda):
                    return self._eval(fn, cb.body, env, findings)
                if isinstance(cb, ast.Name):
                    nested = fn.module.functions.get(
                        f"{fn.qualname}.{cb.id}")
                    if nested is not None:
                        return self.summaries.get(nested.ref,
                                                  _Summary()).ret
                    other = self.project.resolve_symbol(fn.module, cb.id)
                    if other is not None:
                        return self.summaries.get(other.ref,
                                                  _Summary()).ret
            return UNKNOWN
        return s.ret

    # ---------------------------------------------------------- helpers
    def _report(self, findings, node, kind, detail) -> None:
        if findings is None:
            return
        out, fn = findings
        out.append(Finding(RULE, fn.module.rel, fn.qualname, kind, detail,
                           getattr(node, "lineno", 0)))


def check_host_sync(project: Project) -> List[Finding]:
    if not project.roots:
        return []
    return finalize_occurrences(SyncAnalyzer(project).hot_findings())
