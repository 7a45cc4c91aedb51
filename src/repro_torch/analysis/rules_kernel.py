"""R4 — kernel-contract checks for the ctypes bindings of ``csrc/*.cu``.

The port's kernels are plain C entry points (``extern "C" int
<name>_launch(...)``) bound with ctypes.  Nothing checks a binding
against its entry: an ``argtypes`` list one pointer short, or a
``c_int`` where the C function takes a pointer, shifts every later
argument — undefined behaviour on the card that no CPU test runs.  The
wrappers build their ``argtypes`` by list arithmetic, and one picks its
pointer count by a flag (``nptr = 12 if self.int8 else 10``).

Everything is abstract evaluation over the wrapper's AST with a small
constant environment (module constants such as ``_P = ctypes.c_void_p``,
class attributes, ``__init__``'s attributes, locals), once for each value
of the wrapper's boolean flags (``__init__`` parameters with a bool
default, ``self.int8``):

* ``kernel.argtypes-arity`` / ``kernel.argtypes-type`` — every
  ``fn.argtypes = [...]`` (and every ``_Launcher(symbol, argtypes)`` of a
  class that sets ``argtypes`` from its own attribute) against the
  ``extern "C"`` function of that name in the project's CUDA sources:
  the count, and each class (a pointer is ``c_void_p``, ``int``
  ``c_int``, ``long long`` ``c_longlong``, ``float`` ``c_float``).  The
  C declaration is read narrowly, from ``extern "C"`` to the opening
  brace; a symbol with no entry is ``kernel.argtypes-arity`` too;
* ``kernel.operand-count`` — every call of a bound launcher
  (``self._launcher()(...)``, ``self._launch(...)``) passes as many
  arguments as its ``argtypes`` (starred lists evaluated under the same
  flags; where the argtypes already disagree with the C entry, which is
  an arity finding, the call is held to the entry);
* ``kernel.unchecked-launch`` — a launcher's return code is assigned,
  passed to ``build.check_launch``, and the wrapper's launch counter
  (``<...>.launches += 1``) moves after that check;
* ``kernel.page-walk-unbounded`` — every ``block_table[...]`` read in the
  CUDA sources lies behind a bound that comes from the live length: an
  early return ``if (i >= B) return ...`` before the read, or an
  enclosing ``for (...; i < B; ...)``, for each index variable ``i``,
  where ``B`` is ``seq_len`` / ``seq_lens`` / ``q_off`` / ``q_offset`` /
  ``total_len`` / ``tlen``, or is defined from one by ``min(..., live)``,
  ``max(live, live)``, a block-size round-up ``(live + BS - 1) / BS``, or
  a multiple ``live * BS`` (docs/ANALYSIS_torch.md).
"""
from __future__ import annotations

import ast
import itertools
import re
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.findings import Finding, finalize_occurrences
from repro_torch.analysis.project import (FunctionInfo, Project, call_name,
                                          dotted_name, own_statements)

RULE = "R4"

# C parameter class -> the ctypes type that binds it
_C_TO_CTYPES = {"ptr": "c_void_p", "int": "c_int", "long long": "c_longlong",
                "float": "c_float", "double": "c_double",
                "unsigned": "c_uint", "unsigned int": "c_uint",
                "size_t": "c_size_t", "int64_t": "c_int64",
                "int32_t": "c_int32", "uint8_t": "c_uint8"}
_LIVE = {"seq_len", "seq_lens", "q_off", "q_offset", "total_len", "tlen"}
_MAX_FLAGS = 3


class _EvalError(Exception):
    pass


_OPAQUE = object()          # a list element whose value is not known


# --------------------------------------------------------------------------
# C sources
# --------------------------------------------------------------------------

def strip_c_comments(text: str) -> str:
    """The text with ``//`` and ``/* */`` comments blanked (newlines and
    offsets kept)."""
    def blank(m):
        return re.sub(r"[^\n]", " ", m.group(0))
    return re.sub(r"//[^\n]*|/\*.*?\*/", blank, text, flags=re.S)


_EXTERN_RE = re.compile(r'extern\s+"C"\s+([\w\s\*]+?)\b(\w+)\s*\(([^)]*)\)'
                        r'\s*\{')


def c_entries(project: Project) -> Dict[str, Tuple[str, int, List[str]]]:
    """name -> (path, line, parameter classes) of every ``extern "C"``
    function defined in the project's CUDA sources."""
    out = {}
    for rel, text in sorted(project.c_sources.items()):
        code = strip_c_comments(text)
        for m in _EXTERN_RE.finditer(code):
            params = [p.strip() for p in m.group(3).split(",") if p.strip()]
            classes = [_c_class(p) for p in params
                       if p.strip() != "void"]
            out[m.group(2)] = (rel, code.count("\n", 0, m.start()) + 1,
                               classes)
    return out


def _c_class(param: str) -> str:
    if "*" in param or "[" in param:
        return "ptr"
    words = [w for w in re.findall(r"\w+", param)
             if w not in ("const", "volatile", "__restrict__", "restrict")]
    return " ".join(words[:-1]) if len(words) > 1 else "int"


# --------------------------------------------------------------------------
# abstract evaluation of binding expressions
# --------------------------------------------------------------------------

class _Env:
    """Names and ``self.<attr>`` values known while evaluating one method
    of a wrapper under one flag assignment."""

    def __init__(self, values: Dict[str, object]):
        self.values = values

    def eval(self, node: ast.AST):
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, ast.Name):
            if node.id in self.values:
                return self.values[node.id]
            raise _EvalError(node.id)
        if isinstance(node, ast.Attribute):
            text = dotted_name(node)
            if text in self.values:
                return self.values[text]
            if text.startswith("ctypes."):
                return node.attr
            raise _EvalError(text)
        if isinstance(node, (ast.List, ast.Tuple)):
            out = []
            for e in node.elts:
                if isinstance(e, ast.Starred):
                    out.extend(self.eval(e.value))
                    continue
                try:
                    out.append(self.eval(e))
                except _EvalError:
                    out.append(_OPAQUE)     # its length is what counts
            return out
        if isinstance(node, ast.BinOp):
            a, b = self.eval(node.left), self.eval(node.right)
            if isinstance(node.op, ast.Add):
                return a + b
            if isinstance(node.op, ast.Mult):
                return a * b
            if isinstance(node.op, ast.Sub):
                return a - b
            raise _EvalError("binop")
        if isinstance(node, ast.IfExp):
            return self.eval(node.body) if self.eval(node.test) \
                else self.eval(node.orelse)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            return not self.eval(node.operand)
        if isinstance(node, ast.BoolOp):
            vals = [self.eval(v) for v in node.values]
            return all(vals) if isinstance(node.op, ast.And) else any(vals)
        if isinstance(node, ast.Compare) and len(node.ops) == 1:
            a, b = self.eval(node.left), self.eval(node.comparators[0])
            if isinstance(node.ops[0], ast.Eq):
                return a == b
            if isinstance(node.ops[0], ast.NotEq):
                return a != b
        if isinstance(node, ast.Call) and not node.args:
            # a data pointer, a size: one value the count needs, no more
            raise _EvalError("call")
        raise _EvalError(type(node).__name__)

    def run(self, body: List[ast.stmt], stop: Optional[ast.AST] = None
            ) -> bool:
        """Evaluate the simple assignments of ``body`` in order, into
        the environment, following ``if`` branches whose test evaluates;
        returns True when ``stop`` (a statement) was reached."""
        for stmt in body:
            if stmt is stop:
                return True
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                tgt = stmt.targets[0]
                key = tgt.id if isinstance(tgt, ast.Name) else (
                    dotted_name(tgt) if isinstance(tgt, ast.Attribute)
                    else None)
                if key:
                    try:
                        self.values[key] = self.eval(stmt.value)
                    except _EvalError:
                        self.values.pop(key, None)
            elif isinstance(stmt, ast.If):
                try:
                    branch = stmt.body if self.eval(stmt.test) \
                        else stmt.orelse
                except _EvalError:
                    if _contains(stmt, stop):
                        return self.run(stmt.body, stop) \
                            or self.run(stmt.orelse, stop)
                    continue
                if self.run(branch, stop):
                    return True
            elif _contains(stmt, stop):
                for name in ("body", "orelse", "finalbody"):
                    if self.run(getattr(stmt, name, []) or [], stop):
                        return True
        return False


def _contains(stmt: ast.AST, node: Optional[ast.AST]) -> bool:
    return node is not None and any(n is node for n in ast.walk(stmt))


def _module_env(mod) -> Dict[str, object]:
    """Module constants: ``_P, _I, _L = ctypes.c_void_p, ...``, numbers."""
    env = _Env({})
    for stmt in mod.tree.body:
        if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
            continue
        tgt = stmt.targets[0]
        try:
            val = env.eval(stmt.value)
        except _EvalError:
            continue
        if isinstance(tgt, ast.Name):
            env.values[tgt.id] = val
        elif isinstance(tgt, ast.Tuple) and isinstance(val, list) \
                and len(val) == len(tgt.elts):
            for e, v in zip(tgt.elts, val):
                if isinstance(e, ast.Name):
                    env.values[e.id] = v
    return env.values


class _Binding:
    def __init__(self, cls, symbol, argtypes, line, module, method):
        self.cls, self.symbol, self.argtypes = cls, symbol, argtypes
        self.line, self.module, self.method = line, module, method


class KernelChecker:
    def __init__(self, project: Project):
        self.project = project
        self.entries = c_entries(project)

    # -------------------------------------------------------- class envs
    def _flag_sets(self, mod, cls: str):
        """(flag assignments, env) of a class: module constants, class
        attributes, and ``__init__``'s attributes for each value of its
        bool-default parameters."""
        node = mod.classes[cls]
        base = _module_env(mod)
        cenv = _Env(dict(base))
        for stmt in node.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                try:
                    cenv.values["self." + stmt.targets[0].id] = \
                        cenv.eval(stmt.value)
                except _EvalError:
                    pass
        init = mod.functions.get(f"{cls}.__init__")
        flags = []
        if init is not None:
            a = init.node.args
            pos = a.args[len(a.args) - len(a.defaults):]
            for p, d in list(zip(pos, a.defaults)) + list(
                    zip(a.kwonlyargs, a.kw_defaults)):
                if isinstance(d, ast.Constant) and isinstance(d.value, bool):
                    flags.append(p.arg)
        flags = flags[:_MAX_FLAGS]
        for combo in itertools.product((False, True), repeat=len(flags)):
            env = _Env(dict(cenv.values))
            env.values.update(zip(flags, combo))
            if init is not None:
                env.run(init.node.body)
            yield dict(zip(flags, combo)), env

    # ---------------------------------------------------------- bindings
    def _binder_classes(self) -> Dict[str, Tuple[int, int]]:
        """Classes that bind a symbol given to their constructor:
        ``fn.argtypes = self._argtypes``.  class -> (symbol, argtypes)
        positions of ``__init__``."""
        out = {}
        for fn in self.project.all_functions():
            if fn.class_name is None:
                continue
            for n in fn.nodes:
                if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                        and isinstance(n.targets[0], ast.Attribute) \
                        and n.targets[0].attr == "argtypes" \
                        and isinstance(n.value, ast.Attribute) \
                        and dotted_name(n.value.value) == "self":
                    init = fn.module.functions.get(
                        f"{fn.class_name}.__init__")
                    if init is None:
                        continue
                    params = init.positional_params[1:]
                    sym = next((i for i, p in enumerate(params)
                                if "symbol" in p or p == "name"), 0)
                    out[fn.class_name] = (sym, params.index("argtypes")
                                          if "argtypes" in params else 1)
        return out

    def check(self) -> List[Finding]:
        findings: List[Finding] = []
        binders = self._binder_classes()
        for mod in self.project.modules:
            for cls in mod.classes:
                if cls in binders:
                    continue
                self._check_class(mod, cls, binders, findings)
        self._check_page_walks(findings)
        return findings

    def _check_class(self, mod, cls: str, binders, findings) -> None:
        methods = {q.split(".", 1)[1]: f for q, f in mod.functions.items()
                   if f.class_name == cls and q.count(".") == 1}
        if not any(isinstance(n, ast.Attribute) and n.attr == "argtypes"
                   or (isinstance(n, ast.Call)
                       and call_name(n).split(".")[-1] in binders)
                   for f in methods.values() for n in f.nodes):
            return
        seen = set()
        for combo, env in self._flag_sets(mod, cls):
            handles: Dict[str, _Binding] = {}
            for name, fn in methods.items():
                for b in self._bindings(fn, env, binders, cls, mod):
                    handles[b.method] = b
                    self._check_binding(b, combo, findings, seen)
            for fn in methods.values():
                self._check_calls(fn, env, handles, combo, findings, seen)

    def _bindings(self, fn: FunctionInfo, cenv: _Env, binders, cls, mod):
        """The bindings a method makes: ``fn.argtypes = <list>`` after
        ``fn = build.load(lib).<symbol>`` / ``getattr(lib, <expr>)`` (the
        handle is the method: ``self.<method>()(...)`` calls it), and
        ``self.<attr> = _Launcher(symbol, argtypes)`` (the handle is
        ``self.<attr>``)."""
        out = []
        for stmt in own_statements(fn.node):
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Attribute) \
                    and stmt.targets[0].attr == "argtypes":
                holder = dotted_name(stmt.targets[0].value)
                env = _Env(dict(cenv.values))
                env.run(fn.node.body, stop=stmt)
                sym = self._symbol(fn, holder, env)
                try:
                    types = env.eval(stmt.value)
                except _EvalError:
                    continue
                if sym is not None and isinstance(types, list):
                    out.append(_Binding(cls, sym, types, stmt.lineno, mod,
                                        fn.node.name + "()"))
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.value, ast.Call) \
                    and call_name(stmt.value).split(".")[-1] in binders:
                s_i, a_i = binders[call_name(stmt.value).split(".")[-1]]
                args = stmt.value.args
                env = _Env(dict(cenv.values))
                try:
                    sym = env.eval(args[s_i])
                    types = env.eval(args[a_i])
                except (_EvalError, IndexError):
                    continue
                out.append(_Binding(cls, sym, types, stmt.lineno, mod,
                                    dotted_name(stmt.targets[0])))
        return out

    def _symbol(self, fn, holder: str, env: _Env) -> Optional[str]:
        """The C symbol the local ``holder`` was bound to."""
        for stmt in own_statements(fn.node):
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and dotted_name(stmt.targets[0]) == holder:
                v = stmt.value
                if isinstance(v, ast.Attribute) \
                        and isinstance(v.value, ast.Call):
                    return v.attr
                if isinstance(v, ast.Call) and call_name(v) == "getattr" \
                        and len(v.args) == 2:
                    try:
                        return str(env.eval(v.args[1]))
                    except _EvalError:
                        return None
        return None

    def _add(self, findings, seen, b_or_mod, qual, kind, detail, line):
        rel = b_or_mod.rel
        key = (rel, qual, kind, line)
        if key in seen:
            return
        seen.add(key)
        findings.append(Finding(RULE, rel, qual, kind, detail, line))

    def _check_binding(self, b: _Binding, combo, findings, seen) -> None:
        qual = f"{b.cls}.{b.method.rstrip('()')}" \
            if b.method.endswith("()") else b.cls + ".__init__"
        flags = "".join(f" ({k}={v})" for k, v in combo.items())
        entry = self.entries.get(b.symbol)
        if entry is None:
            self._add(findings, seen, b.module, qual,
                      "kernel.argtypes-arity",
                      f"`{b.symbol}` has no extern \"C\" entry in the "
                      "CUDA sources", b.line)
            return
        rel, line, classes = entry
        want = [_C_TO_CTYPES.get(c, c) for c in classes]
        if len(b.argtypes) != len(want):
            self._add(findings, seen, b.module, qual,
                      "kernel.argtypes-arity",
                      f"argtypes of `{b.symbol}`{flags} has "
                      f"{len(b.argtypes)} entries, its extern \"C\" entry "
                      f"({rel}:{line}) takes {len(want)} parameters",
                      b.line)
            return
        bad = [(i, got, w) for i, (got, w) in enumerate(zip(b.argtypes,
                                                             want))
               if got != w]
        if bad:
            i, got, w = bad[0]
            self._add(findings, seen, b.module, qual,
                      "kernel.argtypes-type",
                      f"argtypes of `{b.symbol}`{flags}: parameter {i} is "
                      f"`{got}`, the C entry ({rel}:{line}) takes "
                      f"`{classes[i]}` (`{w}`)", b.line)

    # ------------------------------------------------------------- calls
    def _check_calls(self, fn: FunctionInfo, cenv: _Env, handles, combo,
                     findings, seen) -> None:
        stmts = own_statements(fn.node)
        # each call belongs to its innermost statement (checked once)
        owner = {}
        for stmt in stmts:
            for n in ast.walk(stmt):
                owner[id(n)] = stmt
        for si, stmt in enumerate(stmts):
            for call in (n for n in ast.walk(stmt)
                         if isinstance(n, ast.Call)
                         and owner[id(n)] is stmt):
                f = call.func
                handle = None
                if isinstance(f, ast.Call) and isinstance(f.func,
                                                          ast.Attribute) \
                        and dotted_name(f.func.value) == "self":
                    handle = f.func.attr + "()"
                elif isinstance(f, ast.Attribute) \
                        and dotted_name(f.value) == "self":
                    handle = dotted_name(f)
                b = handles.get(handle)
                if b is None:
                    continue
                self._check_count(fn, cenv, stmt, call, b, combo, findings,
                                  seen)
                self._check_checked(fn, stmt, call, stmts[si + 1:], b,
                                    findings, seen)

    def _check_count(self, fn, cenv, stmt, call, b, combo, findings,
                     seen) -> None:
        env = _Env(dict(cenv.values))
        env.run(fn.node.body, stop=stmt)
        n = 0
        for a in call.args:
            if isinstance(a, ast.Starred):
                try:
                    n += len(env.eval(a.value))
                except (_EvalError, TypeError):
                    return
            else:
                n += 1
        # against the argtypes; where those disagree with the C entry
        # (an arity finding of their own), against the entry
        entry = self.entries.get(b.symbol)
        want = len(entry[2]) if entry is not None \
            and len(entry[2]) != len(b.argtypes) else len(b.argtypes)
        if n != want:
            flags = "".join(f" ({k}={v})" for k, v in combo.items())
            self._add(findings, seen, fn.module, fn.qualname,
                      "kernel.operand-count",
                      f"`{b.symbol}` is called with {n} arguments{flags}, "
                      f"its binding takes {want}", call.lineno)

    def _check_checked(self, fn, stmt, call, later, b, findings,
                       seen) -> None:
        err = None
        if isinstance(stmt, ast.Assign) and stmt.value is call \
                and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            err = stmt.targets[0].id
        checked_at = None
        if err is not None:
            for s in later:
                for c in (n for n in ast.walk(s) if isinstance(n, ast.Call)):
                    if call_name(c).split(".")[-1] == "check_launch" \
                            and any(isinstance(a, ast.Name) and a.id == err
                                    for a in c.args):
                        checked_at = s
                        break
                if checked_at is not None:
                    break
        counted = checked_at is not None and any(
            isinstance(s, ast.AugAssign)
            and isinstance(s.target, ast.Attribute)
            and s.target.attr == "launches"
            for s in later[later.index(checked_at) + 1:])
        if checked_at is None or not counted:
            what = "its return code never reaches build.check_launch" \
                if checked_at is None else \
                "no launch counter moves after its check"
            self._add(findings, seen, fn.module, fn.qualname,
                      "kernel.unchecked-launch",
                      f"`{b.symbol}` launch: {what}", call.lineno)

    # -------------------------------------------------------- page walks
    def _check_page_walks(self, findings) -> None:
        for rel, text in sorted(self.project.c_sources.items()):
            code = strip_c_comments(text)
            for m in re.finditer(r"\bblock_table\s*\[", code):
                idx = _bracket(code, m.end() - 1)
                if idx is None:
                    continue
                line = code.count("\n", 0, m.start()) + 1
                kernel = _enclosing_kernel(code, m.start())
                bad = [v for v in _index_vars(idx)
                       if not _bounded(code, m.start(), v)]
                if bad:
                    findings.append(Finding(
                        RULE, rel, kernel, "kernel.page-walk-unbounded",
                        f"`block_table[{idx}]` reads column "
                        f"`{', '.join(bad)}` with no bound from the live "
                        "length (seq_len, q_offset, total_len): the walk "
                        "can read stale page ids past the live prefix",
                        line))


# --------------------------------------------------------------------------
# reading a page walk's bound in C
# --------------------------------------------------------------------------

def _bracket(code: str, open_at: int) -> Optional[str]:
    depth = 0
    for i in range(open_at, len(code)):
        if code[i] == "[":
            depth += 1
        elif code[i] == "]":
            depth -= 1
            if depth == 0:
                return code[open_at + 1:i].strip()
    return None


def _index_vars(idx: str) -> List[str]:
    """The column variables of a table index: identifiers other than the
    row (``b``), the table width, the block size and casts."""
    skip = {"b", "MB", "BS", "size_t", "int", "long", "const"}
    out = []
    for w in re.findall(r"[A-Za-z_]\w*", idx):
        if w not in skip and not w.isupper() and w not in out:
            out.append(w)
    return out


def _enclosing_kernel(code: str, pos: int) -> str:
    """The name of the ``__global__`` function the offset lies in."""
    start = code.rfind("__global__", 0, pos)
    if start < 0:
        return "<file>"
    head = re.sub(r"__launch_bounds__\s*\([^)]*\)", "", code[start:pos])
    m = re.search(r"(\w+)\s*\(", head[len("__global__"):])
    return m.group(1) if m else "<file>"


def _enclosing_blocks(code: str, pos: int) -> List[int]:
    """Offsets of the ``{`` of every block enclosing ``pos``, innermost
    first."""
    stack = []
    for i in range(pos):
        c = code[i]
        if c == "{":
            stack.append(i)
        elif c == "}" and stack:
            stack.pop()
    return stack[::-1]


def _bounded(code: str, pos: int, var: str) -> bool:
    """A guard ``if (var >= B) return`` before ``pos`` inside its blocks,
    or an enclosing ``for (...; var < B; ...)``, with a live ``B``."""
    v = re.escape(var)
    blocks = _enclosing_blocks(code, pos)
    for start in blocks:
        seg = code[start:pos]
        for g in re.finditer(rf"if\s*\(\s*{v}\s*>=?\s*([^)]+?)\s*\)\s*"
                             r"return", seg):
            if _live(code, pos, g.group(1)):
                return True
        head = re.search(rf"for\s*\([^;]*;\s*{v}\s*<=?\s*([^;]+);[^)]*\)"
                         r"\s*$", code[max(0, start - 400):start])
        if head and _live(code, pos, head.group(1)):
            return True
    return False


def _definition(code: str, pos: int, name: str) -> Optional[str]:
    """The right-hand side of the nearest ``<type> name = ...;`` before
    ``pos``."""
    found = None
    for m in re.finditer(rf"\b(?:const\s+)?(?:int|long long|auto|size_t|"
                         rf"unsigned)\s+{re.escape(name)}\s*=\s*([^;]+);",
                         code[:pos]):
        found = m.group(1)
    if found is None:
        # ``const int a = ..., name = ...;``
        for m in re.finditer(rf"[,]\s*{re.escape(name)}\s*=\s*([^,;]+)[,;]",
                             code[:pos]):
            found = m.group(1)
    return found


def _live(code: str, pos: int, expr: str, depth: int = 0) -> bool:
    """Whether a C expression is bounded by the live length, in the
    narrow forms the module docstring lists."""
    if depth > 8:
        return False
    text = re.sub(r"\((?:size_t|int|long long|float)\)", "", expr)
    text = text.replace("->", ".")
    try:
        node = ast.parse(text.strip(), mode="eval").body
    except SyntaxError:
        return False

    def live(n) -> bool:
        if isinstance(n, ast.Name):
            if n.id in _LIVE:
                return True
            d = _definition(code, pos, n.id)
            return d is not None and _live(code, pos, d, depth + 1)
        if isinstance(n, ast.UnaryOp) and isinstance(n.op, ast.USub):
            return False
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name):
            if n.func.id == "min":
                return any(live(a) for a in n.args)
            if n.func.id == "max":
                return all(live(a) for a in n.args)
            return False
        if isinstance(n, ast.BinOp):
            if isinstance(n.op, (ast.Div, ast.FloorDiv)):
                return live(n.left) and _block_size(n.right)
            if isinstance(n.op, ast.Mult):
                return (live(n.left) and _block_size(n.right)) or (
                    live(n.right) and _block_size(n.left))
            if isinstance(n.op, (ast.Add, ast.Sub)):
                # the round-up ``live + BS - 1``
                terms = _terms(n)
                lives = [t for t in terms if live(t)]
                rest = [t for t in terms if t not in lives]
                return len(lives) == 1 and all(
                    _block_size(t) or (isinstance(t, ast.Constant)
                                       and t.value == 1) for t in rest)
        return False

    return live(node)


def _terms(n: ast.AST) -> List[ast.AST]:
    if isinstance(n, ast.BinOp) and isinstance(n.op, (ast.Add, ast.Sub)):
        return _terms(n.left) + [n.right]
    return [n]


def _block_size(n: ast.AST) -> bool:
    return isinstance(n, ast.Name) and n.id == "BS"


def check_kernel_contracts(project: Project) -> List[Finding]:
    return finalize_occurrences(KernelChecker(project).check())
