"""repro_torch.analysis — the port's static checker: every rule fires on a
seeded bad fixture and stays quiet on its corrected twin; finding keys,
the baseline and the allow comment; the CLI gate against
``analysis/baseline_torch.json``; the planted faults on copies of the
real sources (the copy-back faults of ``tests/test_torch_step_graph.py``,
a ctypes binding one argument short or with an int for a pointer, a page
walk with ``seq_len`` dropped from its bound); the checker's imports; its
parity with ``repro.analysis`` on a plain-Python tree; and the runtime
counterpart of R3 (no new capture in a steady-state second wave).

The checker reads source text only; the runtime cases serve reduced
models on the CPU with the port's own seeded weights.
"""
import ast
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis import findings as j_findings
from repro.analysis.callgraph import CallGraph as JCallGraph
from repro.analysis.project import Project as JProject
from repro_torch.analysis import analyze_project, analyze_source, \
    analyze_sources
from repro_torch.analysis.__main__ import main
from repro_torch.analysis.callgraph import CallGraph
from repro_torch.analysis.capture_registry import registry_of
from repro_torch.analysis.findings import (Baseline, Finding,
                                           finalize_occurrences,
                                           load_baseline, write_baseline)
from repro_torch.analysis.project import Project, call_name

REPO = Path(__file__).resolve().parent.parent
BASELINE = REPO / "analysis" / "baseline_torch.json"


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Run this file on one torch intra-op thread (ROADMAP C13, C15)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def kinds(findings):
    return sorted(f.kind for f in findings)


@pytest.fixture(scope="module")
def tree():
    """The port's sources as text (Python and CUDA), its roots, and the
    unedited tree's findings by rule (filled on first use)."""
    p = Project.from_root(REPO)
    sources = {m.rel: "\n".join(m.lines) + "\n" for m in p.modules}
    sources.update(p.c_sources)
    return sources, p.roots, {}


def _planted(tree, rel, old, new, rules):
    """The findings of ``rules`` on the real sources with one edit,
    minus those of the unedited tree."""
    sources, roots, clean = tree
    assert sources[rel].count(old) >= 1, old
    if rules not in clean:
        clean[rules] = {f.key for f in analyze_project(
            Project.from_sources(sources, roots=roots), rules=rules)}
    edited = dict(sources, **{rel: sources[rel].replace(old, new)})
    return [f for f in analyze_project(
        Project.from_sources(edited, roots=roots), rules=rules)
        if f.key not in clean[rules]]


# ------------------------------------------------------------------ R1

R1_BAD = """
import torch

def hot(x):
    y = torch.exp(x.cuda())
    return y.cpu()
"""

R1_OK = """
import numpy as np
import torch

def hot(x):
    y = torch.exp(x.cuda())
    n = y.shape[0]          # metadata: no device sync
    h = np.arange(n)        # host array: np.asarray is free
    return np.asarray(h), int(n), y.dim(), y.data_ptr()
"""


def test_r1_flags_device_readback():
    found = analyze_source(R1_BAD, rules=("R1",))
    assert len(found) == 1 and found[0].rule == "R1"
    assert ".cpu()" in found[0].detail and found[0].kind == "sync.cpu"
    assert found[0].qualname == "hot"


def test_r1_quiet_on_host_values_and_metadata():
    assert analyze_source(R1_OK, rules=("R1",)) == []


def test_r1_item_readback_and_device_branch():
    src = """
import torch

def hot(x):
    s = torch.sum(torch.zeros(4, device="cuda") + x)
    if s:                   # implicit bool() of a device tensor
        return s.item()     # explicit sync
    return 0
"""
    found = analyze_source(src, rules=("R1",))
    assert kinds(found) == ["sync.implicit-bool", "sync.item"]


def test_r1_reads_the_card_side_of_a_device_test():
    """A branch on the device kind is read on its CUDA side only: the CPU
    side is the tests' plain path.  Stream and event waits always count."""
    src = """
import torch

def hot(x, ev):
    y = torch.exp(x.cuda())
    if not y.is_cuda:
        return int(y.sum())         # the CPU's plain path: not read
    ev.synchronize()
    return y
"""
    assert kinds(analyze_source(src, rules=("R1",))) == ["sync.synchronize"]


# --------------------------------------------------- R2, R3, R5 fixture

RUNNER = '''
import numpy as np
import torch
from repro_torch.serving import step_graph
from repro_torch.serving.step_graph import StepGraph


def model_step(params, state, toks):
    state = dict(state)
    state["seq_lens"] = state["seq_lens"] + 1
    return toks * 2, state


class Runner:
    def __init__(self):
        self.state = {"seq_lens": torch.zeros(4, dtype=torch.int32,
                                              device="cuda")}
        self.params = {}
        self.graphs = {}
        self._tables = None

    def _graph(self, kind) -> StepGraph:
        g = StepGraph(kind, {}, torch.device("cuda"),
                      lambda key: self._body(kind, key))
        self.graphs[kind] = g
        return g

    def sync_tables(self, tables):
        self._tables = tables

    def _body(self, kind, key):
        inp = self.graphs[kind].inputs()
        if key[0]:
            inp["toks"].add_(1)
        out, new = model_step(self.params, dict(self.state), inp["toks"])
        {COPY}
        return out

    def step(self, seqs, key):
        g = self._graph("decode")
        toks = np.zeros((4,), np.int32)
        g.stage(self._staging, {"toks": toks})
        return g.run(key)
'''
COPY_OK = "step_graph.copy_back(self.state, new)"


def _runner(copy=COPY_OK, old=None, new=None):
    src = RUNNER.replace("{COPY}", copy)
    if old is not None:
        assert old in src, old
        src = src.replace(old, new)
    return src


def test_registry_reads_the_fixture_runner():
    p = Project.from_sources({"runner.py": _runner()})
    reg = registry_of(p)
    # the kind is the builder's parameter here: the run site names it
    assert [(s.owner, list(s.kinds)) for s in reg.steps] == \
        [("Runner", ["<step>"])]
    assert list(reg.step_functions) == ["runner.py::Runner._body"]
    assert [(r.fn.qualname, r.kind) for r in reg.runs] == \
        [("Runner.step", "decode")]
    assert [f.qualname for f, _ in reg.copy_backs] == ["Runner._body"]


def test_registry_reads_the_ports_runner(tree):
    """The runner's four captured kinds and their step functions, its
    run sites, and the dispatches that stay eager: the whole-prompt wave,
    the standalone sample, the per-token oracle and the CoW copies."""
    sources, roots, _ = tree
    reg = registry_of(Project.from_sources(sources, roots=roots))
    (site,) = reg.steps
    assert {k: f.qualname for k, f in site.kinds.items()} == {
        "unified": "ModelRunner._unified_body",
        "chained": "ModelRunner._unified_body",
        "megastep": "ModelRunner._megastep_body",
        "chunk": "ModelRunner._chunk_body"}
    assert sorted((r.fn.qualname, r.kind) for r in reg.runs) == [
        ("ModelRunner._unified", None), ("ModelRunner.megastep", "megastep"),
        ("ModelRunner.prefill_chunk", "chunk")]
    assert sorted(f.qualname for f in reg.eager_dispatchers()) == [
        "ModelRunner.copy_cow", "ModelRunner.decode", "ModelRunner.prefill",
        "ModelRunner.sample"]


def test_r2_flags_state_not_copied_back():
    found = analyze_source(_runner("pass"), rules=("R2",))
    assert kinds(found) == ["capture.state-not-copied-back"]
    assert "`new`" in found[0].detail


def test_r2_quiet_on_whole_copy_back():
    assert analyze_source(_runner(), rules=("R2",)) == []


def test_r2_flags_rebound_state_entry():
    src = _runner('self.state["seq_lens"] = new["seq_lens"]')
    assert "capture.state-rebound" in kinds(
        analyze_source(src, rules=("R2",)))


def test_r2_flags_output_aliasing_a_static_input():
    src = _runner(old="        return out\n",
                  new="        return inp[\"toks\"].view(-1)\n")
    assert kinds(analyze_source(src, rules=("R2",))) == \
        ["capture.output-aliases-input"]


def test_r2_flags_a_lazy_allocation_a_step_reaches():
    src = _runner().replace("def model_step(params, state, toks):\n", '''
_SCRATCH = {}


def model_step(params, state, toks):
    if toks.shape not in _SCRATCH:
        _SCRATCH[toks.shape] = torch.empty(toks.shape, device="cuda")
''')
    assert kinds(analyze_source(src, rules=("R2",))) == ["capture.lazy-alloc"]


def test_r3_flags_varying_shape_staging():
    src = _runner(old="toks = np.zeros((4,), np.int32)",
                  new="n = len(seqs)\n        toks = np.zeros((n,), np.int32)")
    assert kinds(analyze_source(src, rules=("R3",))) == \
        ["variant.varying-shape.toks"]


def test_r3_quiet_on_fixed_shapes():
    assert analyze_source(_runner(), rules=("R3",)) == []


def test_r3_flags_unkeyed_branch():
    """A host value the step branches on that changes between dispatches
    (``sync_tables`` rebinds it) and is not in the variant key."""
    src = _runner(old="        if key[0]:",
                  new="        if self._tables is not None:")
    found = analyze_source(src, rules=("R3",))
    assert kinds(found) == ["variant.unkeyed-branch"]
    assert "self._tables" in found[0].detail


def test_r5_flags_device_branch():
    src = _runner(old="        if key[0]:", new="        if inp[\"toks\"].any():")
    found = analyze_source(src, rules=("R5",))
    assert kinds(found) == ["flow.device-branch"]
    assert "toks" in found[0].detail


def test_r5_quiet_on_static_and_metadata_branches():
    src = _runner(old="        if key[0]:", new='''        if inp["toks"].shape[0] > 2 and self.state is not None \\
                and "seq_lens" in self.state and key[0]:''')
    assert analyze_source(src, rules=("R5",)) == []


def test_r5_follows_device_values_into_callees():
    src = _runner().replace('''    state = dict(state)
''', '''    state = dict(state)
    if toks.max() > 3:
        toks = toks - 1
''')
    found = analyze_source(src, rules=("R5",))
    assert [(f.kind, f.qualname) for f in found] == \
        [("flow.device-branch", "model_step")]


# ------------------------------------------------------------------ R4

R4_WRAPPER = '''
import ctypes
from repro_torch.kernels import build


class Walk:
    name = "walk"

    def __init__(self, wide: bool = False):
        self.wide = wide
        self.launches = 0
        self._fn = None

    def _launcher(self):
        if self._fn is None:
            fn = getattr(build.load("walk"),
                         "walk_wide_launch" if self.wide else "walk_launch")
            nptr = 5 if self.wide else 4
            fn.argtypes = ([ctypes.c_void_p] * nptr + [ctypes.c_int] * 3
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, q, table, lens, out):
        ptrs = [q.data_ptr(), table.data_ptr(), lens.data_ptr(),
                out.data_ptr()]
        if self.wide:
            ptrs = ptrs + [out.data_ptr()]
        err = self._launcher()(*ptrs, q.shape[0], 4, 16, None)
        build.check_launch(self.name, err)
        self.launches += 1
        return out
'''

R4_CU = '''
__global__ void walk_kernel(const float* q, const int* block_table,
                            const int* seq_lens, float* out, int MB,
                            int BS) {
  const int b = blockIdx.x;
  const int seq_len = seq_lens[b];
  const int npages = (seq_len + BS - 1) / BS;   // live pages only
  for (int page = 0; page < npages; ++page) {
    const int blk = block_table[b * MB + page];
    out[b] += q[blk];
  }
}

extern "C" int walk_launch(const float* q, const int* block_table,
                           const int* seq_lens, float* out, int B, int MB,
                           int BS, void* stream) {
  walk_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(q, block_table, seq_lens,
                                                  out, MB, BS);
  return (int)cudaGetLastError();
}

extern "C" int walk_wide_launch(const float* q, const int* block_table,
                                const int* seq_lens, float* out,
                                float* extra, int B, int MB, int BS,
                                void* stream) {
  return 0;
}
'''


def _r4(py_old=None, py_new=None, cu_old=None, cu_new=None):
    py, cu = R4_WRAPPER, R4_CU
    if py_old is not None:
        assert py_old in py, py_old
        py = py.replace(py_old, py_new)
    if cu_old is not None:
        assert cu_old in cu, cu_old
        cu = cu.replace(cu_old, cu_new)
    return analyze_sources({"kernels/walk.py": py,
                            "kernels/csrc/walk.cu": cu}, rules=("R4",))


# each R4 kind: (a fault planted in the fixture, the finding it gives)
R4_PLANTS = {
    "page-walk-unbounded": (dict(cu_old="page < npages",
                                 cu_new="page < MB"),
                            "kernel.page-walk-unbounded"),
    "argtypes-arity": (dict(py_old="[ctypes.c_int] * 3",
                            py_new="[ctypes.c_int] * 2"),
                       "kernel.argtypes-arity"),
    "argtypes-type": (dict(py_old="[ctypes.c_int] * 3",
                           py_new="[ctypes.c_int] * 2 + [ctypes.c_float]"),
                      "kernel.argtypes-type"),
    "operand-count": (dict(py_old="q.shape[0], 4, 16, None",
                           py_new="q.shape[0], 4, None"),
                      "kernel.operand-count"),
    "unchecked-launch": (dict(py_old="        build.check_launch(self.name,"
                              " err)\n", py_new=""),
                         "kernel.unchecked-launch"),
}


@pytest.mark.parametrize("kind", list(R4_PLANTS))
def test_r4_flags_planted_fixture_fault(kind):
    edit, want = R4_PLANTS[kind]
    found = _r4(**edit)
    assert kinds(found) == [want], [f.render() for f in found]


def test_r4_fixture_passes_clean():
    assert _r4() == []


def test_r4_evaluates_each_value_of_a_wrapper_flag():
    """The binding and the call are evaluated for each value of the
    wrapper's bool flag: ``wide=True`` binds ``walk_wide_launch``, five
    pointers.  Six there is one too many for that entry only."""
    found = _r4(py_old="nptr = 5 if self.wide else 4",
                py_new="nptr = 6 if self.wide else 4")
    assert kinds(found) == ["kernel.argtypes-arity"]
    assert "`walk_wide_launch` (wide=True)" in found[0].detail


def test_r4_real_kernels_pass_clean(tree):
    """Every binding of the port matches its extern "C" entry, every
    launch is counted after its check, and every page walk of
    ``csrc/*.cu`` is bounded by the live length."""
    sources, roots, _ = tree
    assert analyze_project(Project.from_sources(sources, roots=roots),
                           rules=("R4",)) == []


# the planted faults on copies of the real wrappers and kernels
REAL_PLANTS = {
    "argtype-too-few": ("src/repro_torch/kernels/paged_attention.py",
                        "[ctypes.c_int] + [ctypes.c_void_p] * 9",
                        "[ctypes.c_int] + [ctypes.c_void_p] * 8",
                        ["kernel.argtypes-arity"]),
    "int-for-pointer": ("src/repro_torch/kernels/paged_attention.py",
                        "[ctypes.c_int] + [ctypes.c_void_p] * 9",
                        "[ctypes.c_int] * 2 + [ctypes.c_void_p] * 8",
                        ["kernel.argtypes-type"]),
    "int8-pointer-count": ("src/repro_torch/kernels/flash_attention.py",
                           "nptr = 12 if self.int8 else 10",
                           "nptr = 11 if self.int8 else 10",
                           ["kernel.argtypes-arity"]),
    "seq-len-dropped": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                        "min(min((sp + 1) * pps, MB) * BS, seq_len)",
                        "min((sp + 1) * pps, MB) * BS",
                        ["kernel.page-walk-unbounded"]),
    "launch-unchecked": ("src/repro_torch/kernels/time_scan.py",
                         "        build.check_launch(self.name, err)\n"
                         "        self.launches += 1\n"
                         "        return hs, h_last",
                         "        self.launches += 1\n"
                         "        return hs, h_last",
                         ["kernel.unchecked-launch"]),
}


@pytest.mark.parametrize("plant", list(REAL_PLANTS))
def test_r4_flags_fault_planted_in_the_real_sources(tree, plant):
    rel, old, new, want = REAL_PLANTS[plant]
    found = _planted(tree, rel, old, new, ("R4",))
    assert kinds(found) == want, [f.render() for f in found]


# ------------------------------------------- the planted copy-back faults

def test_static_planted_copy_back_fault(tree):
    """``test_planted_copy_back_fault_changes_the_tokens`` as an edit of
    the source: ``copy_back`` skipping ``seq_lens``."""
    found = _planted(tree, "src/repro_torch/serving/step_graph.py",
                     "        if k in state and t is not state[k]:",
                     '        if k != "seq_lens" and k in state '
                     "and t is not state[k]:", ("R2",))
    assert kinds(found) == ["capture.partial-copy-back"]
    assert found[0].qualname == "copy_back"


@pytest.mark.parametrize("key", ["lru_h", "rec_conv"])
def test_static_planted_recurrent_copy_back_fault(tree, key):
    """``test_planted_recurrent_copy_back_fault_changes_the_tokens`` as an
    edit of the source, at the megastep's copy-back."""
    found = _planted(
        tree, "src/repro_torch/serving/model_runner.py",
        "            inp[\"active\"], sp[\"counts\"] + t, key[2], self.rt)\n"
        "        step_graph.copy_back(self.state, new)",
        "            inp[\"active\"], sp[\"counts\"] + t, key[2], self.rt)\n"
        "        step_graph.copy_back(self.state, {k: v for k, v in "
        f"new.items() if k != {key!r}}})", ("R2",))
    assert [(f.kind, f.qualname) for f in found] == \
        [("capture.partial-copy-back", "ModelRunner._megastep_body")]


# -------------------------------------------------- keys and baseline

def test_allow_comment_suppresses_finding():
    src = R1_BAD.replace("return y.cpu()",
                         "return y.cpu()  # repro: allow[R1] planned readback")
    assert analyze_source(src, rules=("R1",)) == []


def test_allow_comment_needs_a_reason():
    src = R1_BAD.replace("return y.cpu()",
                         "return y.cpu()  # repro: allow[R1]")
    assert len(analyze_source(src, rules=("R1",))) == 1


def test_occurrence_numbering_disambiguates_identical_sites():
    src = """
import torch

def hot(x):
    a = torch.exp(x.cuda()).item()
    b = torch.exp(x.cuda()).item()
    return a, b
"""
    found = analyze_source(src, rules=("R1",))
    assert [f.occurrence for f in found] == [0, 1]
    assert len({f.key for f in found}) == 2


def test_finding_key_excludes_line_numbers():
    a = Finding("R1", "m.py", "f", "sync.x", "detail", line=10)
    b = Finding("R1", "m.py", "f", "sync.x", "detail", line=99)
    assert a.key == b.key


def test_finalize_occurrences_orders_by_source_position():
    raw = [Finding("R1", "m.py", "f", "k", "d", line=30),
           Finding("R1", "m.py", "f", "k", "d", line=10)]
    out = finalize_occurrences(raw)
    assert [(f.line, f.occurrence) for f in out] == [(10, 0), (30, 1)]


def test_baseline_diff_and_validate():
    f_known = Finding("R1", "m.py", "f", "k", "d", line=1)
    f_new = Finding("R2", "m.py", "g", "k2", "d", line=2)
    base = Baseline(entries={f_known.key: {"justification": "planned"},
                             "R9:gone.py:h:k:0": {"justification": "x"}})
    new, known, stale = base.diff([f_known, f_new])
    assert [f.key for f in new] == [f_new.key]
    assert [f.key for f in known] == [f_known.key]
    assert stale == ["R9:gone.py:h:k:0"]
    assert base.validate() == []
    base.entries[f_known.key]["justification"] = "  "
    assert base.validate() == [f_known.key]


def test_baseline_io_round_trip(tmp_path):
    path = tmp_path / "baseline.json"
    f = Finding("R1", "m.py", "f", "k", "d", line=1)
    write_baseline(path, [f])
    base = load_baseline(path)
    assert base.justification(f.key) == ""          # must be filled in
    base.entries[f.key]["justification"] = "because"
    write_baseline(path, [f], previous=base)
    assert load_baseline(path).justification(f.key) == "because"


def test_baseline_rejects_unknown_version(tmp_path):
    path = tmp_path / "baseline.json"
    path.write_text('{"version": 99, "findings": {}}')
    with pytest.raises(ValueError, match="version"):
        load_baseline(path)


def test_checked_in_baseline_is_justified():
    """Every entry names the planned sync or the warm-up it covers."""
    base = load_baseline(BASELINE)
    assert base.entries and base.validate() == []
    for key, entry in base.entries.items():
        assert len(entry["justification"]) > 80, key


# --------------------------------------------------------------- CLI

def _cli(*extra, root="src/repro_torch"):
    return main(["--repo", str(REPO), "--root", root, *extra])


SERVING = "src/repro_torch/serving"     # a smaller tree for the CLI cases


def test_cli_exits_zero_against_checked_in_baseline(capsys):
    assert _cli("--baseline", str(BASELINE)) == 0
    out = capsys.readouterr().out
    assert "0 new" in out and "0 unjustified" in out and "0 stale" in out


def test_cli_fails_without_baseline(capsys):
    assert _cli(root=SERVING) == 1
    assert "[NEW]" in capsys.readouterr().out


def test_cli_rejects_unknown_rule():
    assert _cli("--rules", "R1,R9") == 2


def test_cli_rejects_missing_root():
    assert main(["--repo", str(REPO), "--root", "no/such/dir"]) == 2


def test_cli_json_format(capsys):
    assert _cli("--baseline", str(BASELINE), "--rules", "R2,R4",
                "--format", "json") == 0
    out = json.loads(capsys.readouterr().out)
    assert out["rules"] == ["R2", "R4"] and out["new"] == []
    assert {f["rule"] for f in out["known"]} == {"R2"}


def test_cli_update_baseline_then_gate(tmp_path, capsys):
    """--update-baseline writes every current finding with an empty
    justification, and the gate then fails until they are filled in."""
    path = tmp_path / "baseline.json"
    assert _cli("--baseline", str(path), "--update-baseline",
                root=SERVING) == 0
    assert _cli("--baseline", str(path), root=SERVING) == 1
    assert "unjustified" in capsys.readouterr().out
    base = load_baseline(path)
    assert base.entries
    for entry in base.entries.values():
        entry["justification"] = "test"
    path.write_text(json.dumps({"version": 1, "findings": base.entries}))
    assert _cli("--baseline", str(path), root=SERVING) == 0


# ---------------------------------------------------------- the package

def test_checker_imports_only_the_standard_library():
    """The checker never imports torch, numpy, the JAX package, or any
    module of the port but its own."""
    stdlib = set(sys.stdlib_module_names) | {"__future__"}
    for path in sorted((REPO / "src" / "repro_torch" / "analysis")
                       .glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else \
                [node.module] if isinstance(node, ast.ImportFrom) else []
            for name in names:
                assert name.split(".")[0] in stdlib \
                    or name.startswith("repro_torch.analysis"), \
                    f"{path.name} imports {name}"


SYNTHETIC = {
    "pkg/engine.py": '''
from pkg import helpers as H
from pkg.helpers import tidy


class Runner:
    def go(self, x):
        return H.twice(x)


class Engine:
    def __init__(self):
        self.runner = Runner()

    def step(self):
        y = self.runner.go(1)
        y = tidy(y)  # repro: allow[R1] a planned call

        z = tidy(y)  # repro: allow[R1]
        return self._protected(lambda: H.twice(z))

    def _protected(self, fn):
        return fn()
''',
    "pkg/helpers.py": '''
def twice(x):
    return inner(x) + inner(x)


def inner(x):
    return x


def tidy(x):
    return x


def unused():
    return tidy(0)
'''}
ROOTS = ["pkg/engine.py::Engine.step"]


def _machinery(project_cls, graph_cls, fmod):
    """Keys, occurrences, allows, baseline diff / validation and the
    reachable set of one package's machinery on the synthetic tree."""
    p = project_cls.from_sources(SYNTHETIC, roots=ROOTS)
    raw = [fmod.Finding("R1", fn.module.rel, fn.qualname,
                        f"call.{call_name(c)}", "d", c.lineno)
           for fn in p.all_functions() for c in ast.walk(fn.node)
           if isinstance(c, ast.Call)]
    found = fmod.finalize_occurrences(raw)
    allowed = [p.is_allowed(f) for f in found]
    base = fmod.Baseline(entries={found[0].key: {"justification": "x"},
                                  found[1].key: {"justification": " "},
                                  "R1:gone.py:f:k:0": {"justification": "y"}})
    new, known, stale = base.diff(found)
    return {"keys": [f.key for f in found],
            "occurrences": [f.occurrence for f in found],
            "allowed": allowed,
            "diff": ([f.key for f in new], [f.key for f in known], stale),
            "validate": base.validate(),
            "reachable": sorted(graph_cls(p).reachable(p.roots))}


def test_parity_with_the_jax_checker_on_a_plain_python_tree():
    """The same plain-Python tree through ``repro.analysis`` and
    ``repro_torch.analysis``: equal finding keys, occurrence numbers,
    allow-comment handling, baseline diff and validation, and reachable
    set from the roots."""
    from repro_torch.analysis import findings as t_findings
    j = _machinery(JProject, JCallGraph, j_findings)
    t = _machinery(Project, CallGraph, t_findings)
    assert t == j
    assert sum(t["allowed"]) == 1 and len(t["reachable"]) == 6


def test_cli_runs_without_torch(tmp_path):
    """``python -m repro_torch.analysis`` starts without torch: the port's
    package imports it lazily."""
    import subprocess
    code = ("import sys; sys.modules['torch'] = None; "
            "from repro_torch.analysis.__main__ import main; "
            f"sys.exit(main(['--repo', {str(REPO)!r}, '--baseline', "
            f"{str(BASELINE)!r}, '--rules', 'R3,R4']))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(REPO / "src")},
                         timeout=120)
    assert res.returncode == 0, res.stderr


# ------------------------------------------- the runtime twin of R3

class CaptureSentinel:
    """The runtime counterpart of R3, as ``recompile_sentinel`` in
    ``tests/conftest.py`` is the JAX checker's: ``arm`` snapshots
    ``runner.graph_stats()`` (captures and variants of each kind) after
    warm-up; ``check`` fails if a later window captured anything new."""

    def arm(self, runner):
        self.runner = runner
        self.snap = self._stats()
        assert self.snap, "nothing captured in the warm-up"

    def _stats(self):
        return {k: (g["captures"], sorted(map(tuple, g["variants"])))
                for k, g in self.runner.graph_stats().items()}

    def check(self):
        now = self._stats()
        assert now == self.snap, f"captured in steady state: {self.snap} " \
                                 f"-> {now}"


def _serve_two_waves(cfg, kw, waves):
    from repro_torch.models import transformer as T
    from repro_torch.serving import LLM, SamplingParams
    params = T.init_params(cfg, 0, device="cpu")
    llm = LLM(cfg, params, device="cpu", **kw)
    sps = SamplingParams(max_tokens=8)
    rng = np.random.default_rng(0)
    draw = lambda lens: [rng.integers(1, cfg.vocab_size, n).tolist()
                         for n in lens]
    llm.generate(draw(waves[0]), sps)
    sentinel = CaptureSentinel()
    sentinel.arm(llm.engine.runner)
    outs = llm.generate(draw(waves[1]), sps)
    sentinel.check()
    assert all(len(o.token_ids) == 8 for o in outs)
    stats = llm.engine.runner.graph_stats()
    llm.close()
    return stats


def test_steady_state_wave_captures_nothing_new_dense():
    """The async chunked engine (the defaults) on reduced qwen2-1.5b: a
    second wave of other prompt lengths replays the graphs the first
    captured."""
    from repro_torch.configs.registry import get_reduced
    cfg = get_reduced("qwen2-1.5b", num_heads=4, num_kv_heads=2,
                      num_layers=2, dtype="float32")
    stats = _serve_two_waves(cfg, dict(max_slots=4, num_blocks=96,
                                       max_blocks_per_seq=12,
                                       max_num_batched_tokens=48),
                             [(70, 9, 33, 5), (41, 12, 88, 3, 20)])
    assert {"chained", "megastep"} <= set(stats)
    assert all(g["replays"] > 0 for g in stats.values())


def test_steady_state_wave_captures_nothing_new_ring():
    """A ring stack (reduced h2o-danube-3-4b, whole-prompt waves, the
    graphed megastep), prompts longer than the ring included."""
    from repro_torch.configs.registry import get_reduced
    cfg = get_reduced("h2o-danube-3-4b", num_heads=8, num_kv_heads=2,
                      head_dim=16, sliding_window=12, dtype="float32")
    stats = _serve_two_waves(cfg, dict(max_slots=3, num_blocks=24,
                                       max_blocks_per_seq=2,
                                       prefill_bucket=16),
                             [(9, 20, 40), (33, 5, 14)])
    assert set(stats) == {"megastep"}
    assert stats["megastep"]["replays"] > 0
