"""The port stands alone: no module of ``src/repro_torch``, and neither
``chip_smoke.py`` nor ``chip_pair.py``, imports JAX or any part of the JAX
package, and the entry points that default to the card (the bridge from
the JAX package's weights included) refuse to run on a host without CUDA
instead of falling back to the CPU."""
import ast
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py", ROOT / "chip_pair.py"]


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax")]
    assert not bad, f"{path.name} imports {bad}"


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
    # telemetry and guards on), with the card as the device
    from repro.serving.engine import ServingEngine as JEngine
    ref = inspect.signature(JEngine).parameters
    sig = inspect.signature(ServingEngine).parameters
    assert set(sig) == set(ref) | {"device"}
    assert {k: sig[k].default for k in ref} == \
        {k: p.default for k, p in ref.items()}
    assert sig["device"].default == "cuda"
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
        get_config("falcon-mamba-7b")
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
