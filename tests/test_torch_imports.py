"""The port stands alone: no module of ``src/repro_torch``, none of
``chip_smoke.py``, ``chip_pair.py``, ``chip_faults.py`` and
``chip_b3_plans.py``, and no example of ``examples/repro_torch/``
imports JAX or any part of the JAX package, and the
entry points that default to the card (the bridge from the JAX package's
weights included) refuse to run on a host without CUDA instead of falling
back to the CPU."""
import ast
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Run this file on one torch intra-op thread.  With torch's default
    of a thread per core in each of several test processes sharing the
    same cores, every small op waits at a barrier for threads the other
    processes hold, and the file runs several times slower (ROADMAP C13,
    C15)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = sorted((ROOT / "examples" / "repro_torch").glob("*.py"))
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py", ROOT / "chip_pair.py",
       ROOT / "chip_faults.py", ROOT / "chip_b3_plans.py"]


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", FILES + EXAMPLES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax")]
    assert not bad, f"{path.name} imports {bad}"


def test_the_port_has_an_example_for_each_of_the_references():
    """Every script of ``examples/`` has a counterpart in
    ``examples/repro_torch/`` but ``multidevice_check.py``, which waits
    for the parallelism (ROADMAP A13); each exposes ``main(argv)``."""
    ref = {p.name for p in (ROOT / "examples").glob("*.py")}
    assert {p.name for p in EXAMPLES} == ref - {"multidevice_check.py"}
    for path in EXAMPLES:
        tree = ast.parse(path.read_text(), str(path))
        mains = [n for n in tree.body if isinstance(n, ast.FunctionDef)
                 and n.name == "main"]
        assert mains and [a.arg for a in mains[0].args.args] == ["argv"], \
            path.name


def test_cuda_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the CUDA default is valid here")
    from repro_torch.bridge import params_from_numpy
    from repro_torch.checkpoint.reader import restore_params
    from repro_torch.configs.registry import get_reduced
    from repro_torch.core.gptq import HessianAccumulator
    from repro_torch.core.kv_quant import make_kv_pool_quant
    from repro_torch.core.paged_cache import make_kv_pool
    from repro_torch.models import transformer as T
    from repro_torch.serving import LLM, ServingEngine
    cfg = get_reduced("qwen2-1.5b", num_heads=12, num_kv_heads=2)
    with pytest.raises(RuntimeError, match="cuda"):
        T.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="cuda"):
        LLM.load("qwen2-1.5b", reduced=True)
    with pytest.raises(RuntimeError, match="cuda"):
        LLM.load("qwen2-1.5b", quant="gptq-int4", reduced=True)
    for alloc in (make_kv_pool, make_kv_pool_quant):
        with pytest.raises(RuntimeError, match="cuda"):
            alloc(1, 2, 4, 1, 8)
        assert alloc(1, 2, 4, 1, 8, device="cpu")[0].device.type == "cpu"
    with pytest.raises(RuntimeError, match="cuda"):
        HessianAccumulator(8)
    with pytest.raises(RuntimeError, match="cuda"):
        restore_params("ckpt", T.init_params(cfg, device="meta"))
    params = T.init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(cfg, params)
    # the engine's defaults are the reference's (async pipelined step,
    # telemetry and guards on), with the card as the device and the
    # fixed-shape steps captured as CUDA graphs (the reference's jit)
    from repro.serving.engine import ServingEngine as JEngine
    ref = inspect.signature(JEngine).parameters
    sig = inspect.signature(ServingEngine).parameters
    assert set(sig) == set(ref) | {"device", "capture_graphs"}
    assert {k: sig[k].default for k in ref} == \
        {k: p.default for k, p in ref.items()}
    assert sig["device"].default == "cuda"
    assert sig["capture_graphs"].default is True
    assert inspect.signature(LLM.load).parameters[
        "capture_graphs"].default is True
    assert sig["enable_async_step"].default is True
    assert sig["enable_telemetry"].default is True
    assert sig["enable_guards"].default is True
    for kw in ({"enable_async_step": False}, {"enable_telemetry": False},
               {"enable_unified_step": False}):
        with pytest.raises(RuntimeError, match="cuda"):
            ServingEngine(cfg, params, **kw)
        with pytest.raises(RuntimeError, match="cuda"):
            LLM.load("qwen2-1.5b", reduced=True, **kw)
    tree = {"w": np.zeros((2, 3), np.float32), "layers": [np.ones(4)]}
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_numpy(tree)
    got = params_from_numpy(tree, device="cpu")
    assert got["w"].device.type == "cpu" and got["layers"][0].shape == (4,)


def test_unported_paths_refuse():
    """What is still unported is refused by name: a config of a family
    not ported yet (A11) and ``rt["prefill_chunk"]`` (A3).
    ``LLM.load(checkpoint=...)`` reads the reference's checkpoints (A1)
    and, as the reference, refuses a directory without a step.  The async
    step, the two-call and per-token oracles, fault injection and
    telemetry are served."""
    from repro_torch.configs.registry import get_config, get_reduced
    from repro_torch.models import transformer as T
    from repro_torch.serving import LLM, FaultInjector, ServingEngine
    with pytest.raises(NotImplementedError, match="A11"):
        get_config("kimi-k2-1t-a32b")
    # the RG-LRU hybrid is served, ring-only, by synchronous waves
    rcfg = get_reduced("recurrentgemma-2b", num_layers=3)
    assert get_config("recurrentgemma-2b").family == "hybrid"
    eng = ServingEngine(rcfg, T.init_params(rcfg, 0, device="cpu"),
                        device="cpu", num_blocks=8, max_blocks_per_seq=2)
    assert eng.scheduler.ring_only and not eng.chunked
    assert not eng.async_step
    # the sliding-window stack is served, through whole-prompt waves over
    # private rings
    dcfg = get_reduced("h2o-danube-3-4b")
    assert get_config("h2o-danube-3-4b").sliding_window == 8192
    eng = ServingEngine(dcfg, T.init_params(dcfg, 0, device="cpu"),
                        device="cpu", num_blocks=8, max_blocks_per_seq=2)
    assert eng.scheduler.ring_only and not eng.chunked
    assert not eng.async_step
    with pytest.raises(FileNotFoundError, match="no step_"):
        LLM.load("qwen2-1.5b", reduced=True, device="cpu",
                 checkpoint="ckpt")
    # gptq-int4 is served now: a CPU load calibrates on synthetic tokens
    llm = LLM.load("qwen2-1.5b", quant="gptq-int4", reduced=True,
                   device="cpu")
    assert "qweight" in llm.params["layers"][0]["mlp"]["w_down"]
    assert set(llm.load_s) == {"init", "calibration", "obq", "pack"}
    cfg = get_reduced("qwen2-1.5b", num_heads=12, num_kv_heads=2)
    params = T.init_params(cfg, 0, device="cpu")
    eng = ServingEngine(cfg, params, device="cpu")
    assert eng.async_step and eng.unified and eng.guards
    assert eng.tracer.enabled
    for kw in ({"enable_unified_step": False},
               {"enable_unified_step": False, "kv_cache_dtype": "int8"},
               {"use_fused": False}):
        eng = ServingEngine(cfg, params, device="cpu", **kw)
        assert not eng.unified and not eng.async_step
    eng = ServingEngine(cfg, params, device="cpu", enable_guards=False)
    assert "sampling_guard" not in eng.rt
    fi = FaultInjector()
    eng = ServingEngine(cfg, params, device="cpu", fault_injector=fi,
                        max_waiting=4, shed_policy="shed-oldest",
                        enable_telemetry=False)
    assert eng.faults is fi and eng.max_waiting == 4
    assert not eng.tracer.enabled
    # the chunked variant of whole-prompt prefill waits for A3
    st = T.make_decode_state(cfg, 1, 4, 2, device="cpu")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32),
             "ctx_lens": torch.full((1,), 4, dtype=torch.int32)}
    with pytest.raises(NotImplementedError, match="A3"):
        T.prefill(cfg, params, st, batch, rt={"prefill_chunk": 2})
    # int8 KV and whole-prompt prefill are served now, together too
    eng = ServingEngine(cfg, params, device="cpu", kv_cache_dtype="int8",
                        enable_chunked_prefill=False, num_blocks=8,
                        max_blocks_per_seq=2)
    assert eng.kv_cache_dtype == "int8" and not eng.chunked


def test_trainer_refuses_what_it_cannot_train(tmp_path):
    """The trainer's entry points: the new modules are in the import scan;
    the MoE, hybrid and Mamba families, refused until their backward ran
    on the card, now train (one CLI step each on the CPU, finite); an
    unported family (A11) and a production mesh (A13) are refused by
    name; and without a card the defaults raise instead of training on
    the CPU."""
    new = {"optim/adamw.py", "runtime/train_loop.py", "data/pipeline.py",
           "checkpoint/checkpointer.py", "launch/train.py"}
    scanned = {str(p.relative_to(ROOT / "src" / "repro_torch"))
               for p in FILES if "repro_torch" in p.parts}
    assert new <= scanned
    from repro_torch.configs.registry import get_reduced
    from repro_torch.launch import train
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime import train_loop
    for arch in ("qwen2-moe-a2.7b", "recurrentgemma-2b", "falcon-mamba-7b"):
        assert callable(train_loop.make_train_step(get_reduced(arch),
                                                   AdamWConfig()))
        losses = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                             "--steps", "1", "--batch", "2", "--seq", "16",
                             "--ckpt-dir", str(tmp_path / arch)])
        assert len(losses) == 1 and np.isfinite(losses[0]), (arch, losses)
    with pytest.raises(NotImplementedError, match="A11"):
        train.main(["--arch", "kimi-k2-1t-a32b", "--reduced", "--device",
                    "cpu", "--ckpt-dir", str(tmp_path)])
    cfg = get_reduced("qwen2-1.5b")
    for mesh in ("single", "multi"):
        with pytest.raises(NotImplementedError, match="A13"):
            train.main(["--arch", "qwen2-1.5b", "--reduced", "--mesh", mesh,
                        "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    for refused in (lambda: train_loop.make_train_step(cfg, AdamWConfig(),
                                                       ctx=object()),
                    lambda: train_loop.jit_train_step(cfg, AdamWConfig(),
                                                      object()),
                    lambda: train_loop.make_compressed_grad_fn(cfg,
                                                               object()),
                    lambda: train_loop.init_error_buffer(object(), {})):
        with pytest.raises(NotImplementedError, match="A13"):
            refused()
    if torch.cuda.is_available():
        return
    from repro_torch.bridge import opt_state_from_numpy
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLM
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--arch", "qwen2-1.5b", "--reduced", "--steps", "1",
                    "--ckpt-dir", str(tmp_path)])
    data = SyntheticLM(cfg, ShapeConfig("t", 8, 2, "train"))
    with pytest.raises(RuntimeError, match="cuda"):
        data.next_batch()
    assert data.next_batch(device="cpu")["tokens"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="cuda"):
        opt_state_from_numpy((np.int32(0), {}, {}))
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(1, {"t": {"w": torch.ones(2)}})
    with pytest.raises(RuntimeError, match="cuda"):
        ck.restore(1, {"t": {"w": torch.ones(2)}})
