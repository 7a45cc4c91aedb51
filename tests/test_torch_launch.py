"""The port's serve CLI (``python -m repro_torch.launch.serve``) against the
JAX package's (``python -m repro.launch.serve``) on the CPU: both restore
the same reduced qwen2-1.5b from one JAX ``Checkpointer`` directory
(``--checkpoint``) and must print the same request lines, plain, under
``--stream`` and with ``--mha-baseline`` (a second directory of the MHA
shapes); the ``mode`` line and ``--metrics-out`` have the reference's
keys, ``--trace-out`` validates, ``--profile-dir`` writes a
``torch.profiler`` Chrome trace, ``--max-waiting 2 --shed-policy reject``
raises ``EngineOverloadedError`` in both (the port closing its engine),
and without ``--device`` the port's CLI raises on a host without a card.

The reference's CLI runs in process with ``sys.argv`` patched (JAX on the
CPU); the port's takes ``--device cpu``.  Both packages' reduced config
is patched to f32 activations (the CLIs take the config's dtype): in
bf16, XLA's CPU products and torch's round apart and flip a near-tie
after a few tokens, so the port's parity tests all compare in f32.
"""
import json
import sys

import jax
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer
from repro.configs.registry import get_reduced as j_get_reduced
from repro.launch import serve as j_serve
from repro.models import transformer as JT
from repro.serving import EngineOverloadedError as JOverloaded
from repro_torch.launch import serve
from repro_torch.obs.trace import validate_chrome_trace
from repro_torch.serving import LLM, EngineOverloadedError

ARCH = "qwen2-1.5b"
ARGS = ["--arch", ARCH, "--reduced", "--requests", "6", "--max-tokens", "6",
        "--quant", "rtn-int4"]


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch intra-op thread for this file's small ops (ROADMAP C13)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """One checkpoint of the reduced config's f32 params (seed 0), one of
    its MHA shapes (as many KV heads as query heads) for
    ``--mha-baseline``."""
    out = {}
    for name, kw in (("gqa", {}), ("mha", {"num_kv_heads": 4})):
        cfg = j_get_reduced(ARCH, **kw)
        assert cfg.num_heads == 4
        d = tmp_path_factory.mktemp(name)
        Checkpointer(str(d)).save(1, {"params": JT.init_params(
            cfg, jax.random.PRNGKey(0))})
        out[name] = str(d)
    return out


@pytest.fixture
def f32(monkeypatch):
    """Both packages' ``get_reduced`` (the registry's, which
    ``--mha-baseline`` reads, and the facade's) with f32 activations."""
    import repro.configs.registry as j_registry
    import repro.serving.llm as j_llm
    import repro_torch.configs.registry as registry
    import repro_torch.serving.llm as llm
    for mod, base in ((j_registry, j_registry.get_reduced),
                      (j_llm, j_registry.get_reduced),
                      (registry, registry.get_reduced),
                      (llm, registry.get_reduced)):
        monkeypatch.setattr(mod, "get_reduced",
                            lambda name, _b=base, **kw: _b(
                                name, **{"dtype": "float32", **kw}))


def _reference(args, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["repro.launch.serve", *args])
    j_serve.main()
    return capsys.readouterr().out


def _port(args, capsys):
    serve.main([*args, "--device", "cpu"])
    return capsys.readouterr().out


# what the port's ``report()`` has beyond the reference's (its chip runs
# read them)
PORT_REPORT_KEYS = {"ttft_p50_ms", "ttft_p99_ms", "finished", "gen_tokens",
                    "prompt_tokens", "device_dispatches", "work_steps"}
VARIANTS = {"plain": [], "stream": ["--stream", "--metrics-port", "0"],
            "mha": ["--mha-baseline"]}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_request_lines_match_the_reference(ckpts, f32, tmp_path, capsys,
                                           monkeypatch, variant):
    """The same checkpoint through both CLIs: the same request lines (the
    finished requests' tokens, or ``--stream``'s deltas), the ``mode``
    line's keys and label, ``--metrics-out``'s keys; ``--trace-out``
    validates; the port's ``--profile-dir`` holds a Chrome trace."""
    ck = ckpts["mha" if variant == "mha" else "gqa"]
    args = [*ARGS, "--checkpoint", ck, *VARIANTS[variant]]
    files = {}
    for side in ("ref", "port"):
        files[side] = {"metrics": tmp_path / f"{side}-metrics.json",
                       "trace": tmp_path / f"{side}-trace.json"}
    outs = {}
    for side in ("ref", "port"):
        extra = ["--metrics-out", str(files[side]["metrics"]),
                 "--trace-out", str(files[side]["trace"])]
        if side == "ref":
            outs[side] = serve.read_output(
                _reference([*args, *extra], capsys, monkeypatch))
        else:
            extra += ["--profile-dir", str(tmp_path / "profile")]
            outs[side] = serve.read_output(_port([*args, *extra], capsys))
    ref, got = outs["ref"], outs["port"]
    assert got["requests"] == ref["requests"]
    if variant == "stream":
        assert all("new" in r for r in got["requests"])
    else:
        assert len(got["requests"]) == 6
        assert all(r["finish_reason"] == "length" and len(r["tokens"]) == 6
                   for r in got["requests"])
    # the reference's keys, and the counts the port's report adds
    assert set(got["mode"]) - set(ref["mode"]) == PORT_REPORT_KEYS
    assert set(ref["mode"]) <= set(got["mode"])
    assert got["mode"]["prefill_compiles"] == ref["mode"]["prefill_compiles"]
    assert got["mode"]["mode"] == ref["mode"]["mode"] == \
        ("mha" if variant == "mha" else "opt-gqa") + "+rtn-int4"
    assert got["mode"]["kv_bytes_per_token"] == \
        ref["mode"]["kv_bytes_per_token"]
    assert (got["attribution"] is None) == (ref["attribution"] is None)
    if got["attribution"] is not None:
        assert set(got["attribution"]) == set(ref["attribution"])
    m_ref, m_got = (json.loads(files[s]["metrics"].read_text())
                    for s in ("ref", "port"))
    assert set(m_got) == set(m_ref)
    assert validate_chrome_trace(json.loads(
        files["port"]["trace"].read_text())) == []
    prof = json.loads((tmp_path / "profile" / "trace.json").read_text())
    assert prof["traceEvents"]


def test_mha_baseline_holds_six_times_the_kv_bytes(capsys):
    """Without a checkpoint (seeded weights) at qwen2-1.5b's full head
    counts (12 query heads over 2 KV heads, cut to 1 layer and d 64 by
    the reduced config's other fields), ``--mha-baseline`` serves 12 KV
    heads with prefix reuse off: the ``mode`` lines' KV bytes a token are
    6.0 apart, as the card's CLI phase holds at full size."""
    from repro_torch.configs import registry
    full = registry.get_reduced

    def reduced(name, **kw):
        return full(name, **{"num_heads": 12, "num_kv_heads": 2,
                             "num_layers": 1, **kw})
    args = ["--arch", ARCH, "--requests", "2", "--max-tokens", "2"]
    mp = pytest.MonkeyPatch()
    mp.setattr(registry, "get_reduced", reduced)
    mp.setattr("repro_torch.serving.llm.get_reduced", reduced)
    try:
        gqa = serve.read_output(_port(args, capsys))["mode"]
        mha = serve.read_output(_port([*args, "--mha-baseline"],
                                      capsys))["mode"]
    finally:
        mp.undo()
    assert mha["kv_bytes_per_token"] / gqa["kv_bytes_per_token"] == 6.0
    assert mha["blocks_reused"] == 0


def test_shed_policy_reject_raises_in_both(ckpts, f32, capsys,
                                           monkeypatch):
    """``--max-waiting 2 --shed-policy reject``: submitting all requests up
    front overflows the queue, so both CLIs raise EngineOverloadedError;
    the port's still closes its engine (``finally``)."""
    args = [*ARGS, "--checkpoint", ckpts["gqa"], "--max-waiting", "2",
            "--shed-policy", "reject"]
    with pytest.raises(JOverloaded):
        _reference(args, capsys, monkeypatch)
    closed = []
    real = LLM.close
    monkeypatch.setattr(LLM, "close",
                        lambda self: (closed.append(self), real(self))[1])
    with pytest.raises(EngineOverloadedError):
        _port(args, capsys)
    assert len(closed) == 1


def test_cli_defaults_to_the_card():
    """``--device`` defaults to ``cuda``: on a host without a card the CLI
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--requests", "1", "--max-tokens", "1"])
    assert serve._parser().get_default("device") == "cuda"
