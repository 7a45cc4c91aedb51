"""Source loading and indexing for the static checker.

Everything here is stdlib-``ast`` only: the analyzer never imports the
code under analysis, so it runs without torch or a card and cannot be
confused by import-time side effects.  Besides the Python modules, a
project holds the text of the CUDA sources beside them (``*.cu``), which
the kernel-contract rule (R4) reads for the ``extern "C"`` entry points
and the page walks.
"""
from __future__ import annotations

import ast
import functools
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

# inline suppression: ``# repro: allow[R1,R4] reason`` on the finding's
# line or the line directly above it.  The reason is mandatory — an
# allow without one is ignored.
_ALLOW_RE = re.compile(
    r"#\s*repro:\s*allow\[([A-Z0-9,\s]+)\]\s*(\S.*)$")

_DEFAULT_ROOTS = (
    "src/repro_torch/serving/engine.py::ServingEngine.step",
    "src/repro_torch/serving/engine.py::ServingEngine.stream",
    "src/repro_torch/serving/engine.py::ServingEngine.run_until_done",
)

# the package whose dotted module names the project resolves imports in
PACKAGE = "repro_torch"


@dataclass
class FunctionInfo:
    qualname: str                  # "Class.method" or "fn"
    module: "SourceModule"
    node: ast.AST                  # FunctionDef / AsyncFunctionDef
    class_name: Optional[str] = None

    @property
    def params(self) -> List[str]:
        a = self.node.args
        names = [p.arg for p in a.posonlyargs + a.args]
        if a.vararg:
            names.append("*" + a.vararg.arg)
        names += [p.arg for p in a.kwonlyargs]
        return names

    @property
    def positional_params(self) -> List[str]:
        a = self.node.args
        return [p.arg for p in a.posonlyargs + a.args]

    def annotation(self, param: str) -> Optional[ast.expr]:
        a = self.node.args
        for p in a.posonlyargs + a.args + a.kwonlyargs:
            if p.arg == param:
                return p.annotation
        return None

    @property
    def ref(self) -> str:
        return f"{self.module.rel}::{self.qualname}"

    @functools.cached_property
    def nodes(self) -> List[ast.AST]:
        """Every node of the function (``ast.walk`` order), walked once."""
        return list(ast.walk(self.node))

    @functools.cached_property
    def calls(self) -> List[ast.Call]:
        return [n for n in self.nodes if isinstance(n, ast.Call)]


@dataclass
class SourceModule:
    rel: str                       # repo-relative posix path
    tree: ast.Module
    lines: List[str]
    # lineno -> set of rules allowed there (inline suppressions)
    allows: Dict[int, Set[str]] = field(default_factory=dict)
    functions: Dict[str, FunctionInfo] = field(default_factory=dict)
    classes: Dict[str, ast.ClassDef] = field(default_factory=dict)
    # import name -> ("module", dotted) | ("symbol", dotted_mod, symbol)
    imports: Dict[str, Tuple] = field(default_factory=dict)

    @classmethod
    def parse(cls, rel: str, source: str) -> "SourceModule":
        tree = ast.parse(source, filename=rel)
        lines = source.splitlines()
        mod = cls(rel=rel, tree=tree, lines=lines)
        mod._collect_allows()
        mod._index(tree.body, prefix="", class_name=None)
        mod._collect_imports()
        return mod

    # ---------------------------------------------------------- indexing
    def _collect_allows(self) -> None:
        for i, line in enumerate(self.lines, start=1):
            m = _ALLOW_RE.search(line)
            if not m:
                continue
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            # the allow covers its own line and the following one
            # (comment-above style)
            self.allows.setdefault(i, set()).update(rules)
            self.allows.setdefault(i + 1, set()).update(rules)

    def _index(self, body, prefix: str, class_name: Optional[str]) -> None:
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{node.name}"
                self.functions[qual] = FunctionInfo(
                    qualname=qual, module=self, node=node,
                    class_name=class_name)
                # nested defs are indexed too
                self._index(node.body, prefix=qual + ".",
                            class_name=class_name)
            elif isinstance(node, ast.ClassDef):
                self.classes[node.name] = node
                self._index(node.body, prefix=node.name + ".",
                            class_name=node.name)

    def _collect_imports(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.imports[a.asname or a.name.split(".")[0]] = (
                        "module", a.name)
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.imports[a.asname or a.name] = (
                        "symbol", node.module, a.name)

    def function_at(self, lineno: int) -> Optional[FunctionInfo]:
        """The innermost function whose body spans ``lineno``."""
        best = None
        for fn in self.functions.values():
            end = getattr(fn.node, "end_lineno", fn.node.lineno)
            if fn.node.lineno <= lineno <= end and (
                    best is None or fn.node.lineno >= best.node.lineno):
                best = fn
        return best


class Project:
    """A set of parsed modules, the CUDA sources beside them, and
    cross-module lookup tables."""

    def __init__(self, modules: List[SourceModule], roots=None,
                 c_sources: Optional[Dict[str, str]] = None):
        self.modules = modules
        self.by_rel = {m.rel: m for m in modules}
        self.c_sources: Dict[str, str] = dict(c_sources or {})
        self.roots = list(roots) if roots is not None else \
            [r for r in _DEFAULT_ROOTS if r.split("::")[0] in self.by_rel]
        # analyses the rules share (the capture registry, the call graph)
        self.memo: Dict[str, object] = {}
        self._stems: Optional[Dict[str, SourceModule]] = None
        # dotted module name ("repro_torch.serving.engine") -> SourceModule
        self.by_dotted: Dict[str, SourceModule] = {}
        for m in modules:
            dotted = self._dotted(m.rel)
            if dotted:
                self.by_dotted[dotted] = m

    # ------------------------------------------------------ construction
    @classmethod
    def from_root(cls, root, subdir="src/repro_torch",
                  roots=None) -> "Project":
        root = Path(root)
        mods = []
        for p in sorted((root / subdir).rglob("*.py")):
            rel = p.relative_to(root).as_posix()
            mods.append(SourceModule.parse(rel, p.read_text()))
        c_sources = {p.relative_to(root).as_posix(): p.read_text()
                     for p in sorted((root / subdir).rglob("*.cu"))}
        return cls(mods, roots=roots, c_sources=c_sources)

    @classmethod
    def from_sources(cls, sources: Dict[str, str], roots=None) -> "Project":
        """Python modules and CUDA sources (keys ending in ``.cu``) given
        as text: the test-fixture entry point."""
        mods = [SourceModule.parse(rel, src)
                for rel, src in sorted(sources.items())
                if rel.endswith(".py")]
        c_sources = {rel: src for rel, src in sources.items()
                     if rel.endswith(".cu")}
        if roots is None:
            # fixture default: every top-level function/method is a root
            roots = [f.ref for m in mods for f in m.functions.values()]
        return cls(mods, roots=roots, c_sources=c_sources)

    # ---------------------------------------------------------- lookups
    @staticmethod
    def _dotted(rel: str) -> Optional[str]:
        parts = Path(rel).with_suffix("").parts
        if PACKAGE in parts:
            parts = parts[parts.index(PACKAGE):]
        if parts and parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join(parts) if parts else None

    def resolve_module(self, dotted: str) -> Optional[SourceModule]:
        if dotted in self.by_dotted:
            return self.by_dotted[dotted]
        # a bare module name for single-file fixtures (first by path)
        if self._stems is None:
            self._stems = {}
            for rel, m in self.by_rel.items():
                self._stems.setdefault(Path(rel).stem, m)
        return self._stems.get(dotted)

    def resolve_symbol(self, module: SourceModule,
                       name: str) -> Optional[FunctionInfo]:
        """Resolve a bare name used in ``module`` to a project function:
        local first, then ``from x import name``."""
        if name in module.functions:
            return module.functions[name]
        imp = module.imports.get(name)
        if imp and imp[0] == "symbol":
            target = self.resolve_module(imp[1])
            if target is not None:
                return target.functions.get(imp[2])
        return None

    def resolve_attr_call(self, module: SourceModule,
                          value: ast.expr,
                          attr: str) -> Optional[FunctionInfo]:
        """Resolve ``alias.attr(...)`` where ``alias`` is an imported
        project module (``from repro_torch.models import transformer as
        T``)."""
        if isinstance(value, ast.Name):
            imp = module.imports.get(value.id)
            if imp:
                dotted = imp[1] if imp[0] == "module" \
                    else f"{imp[1]}.{imp[2]}"
                target = self.resolve_module(dotted)
                if target is not None:
                    return target.functions.get(attr)
        return None

    def function(self, ref: str) -> Optional[FunctionInfo]:
        """Look up "rel/path.py::Qual.name"."""
        rel, _, qual = ref.partition("::")
        mod = self.by_rel.get(rel)
        return mod.functions.get(qual) if mod else None

    def all_functions(self):
        for m in self.modules:
            yield from m.functions.values()

    # ------------------------------------------------------ suppressions
    def is_allowed(self, finding) -> bool:
        mod = self.by_rel.get(finding.path)
        if mod is None:
            return _c_allowed(self.c_sources.get(finding.path),
                              finding.rule, finding.line)
        return finding.rule in mod.allows.get(finding.line, ())


def _c_allowed(text: Optional[str], rule: str, line: int) -> bool:
    """The allow comment in a CUDA source: ``// repro: allow[R4] reason``
    on the line or the one above."""
    if text is None:
        return False
    lines = text.splitlines()
    for i in (line - 1, line - 2):
        if 0 <= i < len(lines):
            m = re.search(r"//\s*repro:\s*allow\[([A-Z0-9,\s]+)\]\s*\S",
                          lines[i])
            if m and rule in {r.strip() for r in m.group(1).split(",")}:
                return True
    return False


# --------------------------------------------------------------------------
# Shared AST utilities
# --------------------------------------------------------------------------

def call_name(node: ast.Call) -> str:
    """Dotted text of a call target ("np.asarray", "self.runner.sample")."""
    return dotted_name(node.func)


def dotted_name(node: ast.expr) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def own_statements(fn_node):
    """Statements of a function body in source order, not descending into
    nested function definitions (they have their own FunctionInfo)."""
    out = []

    def rec(body):
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            out.append(stmt)
            for name in ("body", "orelse", "finalbody"):
                rec(getattr(stmt, name, []) or [])
            for h in getattr(stmt, "handlers", []) or []:
                rec(h.body)

    rec(fn_node.body)
    return out


def bind_args(params: List[str], call: ast.Call) -> Dict[str, ast.expr]:
    """Map positional params to the argument expressions at a call."""
    bound: Dict[str, ast.expr] = {}
    for i, arg in enumerate(call.args):
        if isinstance(arg, ast.Starred):
            break
        if i < len(params):
            bound[params[i]] = arg
    for kw in call.keywords:
        if kw.arg is not None:
            bound[kw.arg] = kw.value
    return bound
