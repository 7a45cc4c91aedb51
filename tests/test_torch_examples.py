"""The port's examples (``examples/repro_torch/``) and h2o-danube-3-4b
with ``gptq-int4`` against the JAX package on the CPU.

Danube: reduced h2o-danube-3-4b (2 layers, d_model 64, 4 heads of 16,
window 32) in f32 on bridged JAX params, calibrated on batches of 80
tokens, longer than the window, so the window shapes the Hessians.  The
port's ``gptq_quantize_model`` gives the JAX package's codes, scales,
zeros and ``g_idx`` bitwise; ``LLM.load(quant="gptq-int4")`` drains one
request token-exact against the JAX engine, and batched drains (every
ring wrapping) equal the reference's teacher-forced tokens (ROADMAP C11:
the JAX engine's batched rings alias, so it is no oracle there).

Examples: each port example with ``--device cpu`` runs the JAX example's
own reduced config and gives its numbers where they are deterministic:
``quickstart``'s tokens (greedy and seeded sampled rows) on bridged
params and explicit calibration tokens, ``quantize_model``'s proxy
losses (and its whole-model drift on bridged params), and
``convert_mha_to_gqa``'s groups; both packages' ``get_reduced`` patched
to f32 where a model is served (bf16 rounds apart between XLA:CPU and
torch and flips near-ties).  ``train_small`` trains on the CPU and
writes its checkpoint.
"""
import importlib.util
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving.llm as j_llm_mod
from repro.configs.base import QuantConfig as JQuantConfig
from repro.configs.registry import get_reduced as j_get_reduced
from repro.models import transformer as JT
from repro.models.quantize import gptq_quantize_model as j_gptq_model
from repro.serving import LLM as JLLM
from repro.serving import SamplingParams as JSP
import repro_torch.serving.llm as llm_mod
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import QuantConfig
from repro_torch.configs.registry import get_reduced
from repro_torch.models import transformer as T
from repro_torch.models.quantize import (calibration_hessians,
                                         gptq_quantize_model)
from repro_torch.serving import LLM, SamplingParams


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
GS = 32


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _load(path: Path, name: str):
    """An example script as a module (examples/ is not a package)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _port(name):
    return _load(ROOT / "examples" / "repro_torch" / f"{name}.py",
                 f"torch_example_{name}")


def _ref(name):
    return _load(ROOT / "examples" / f"{name}.py", f"jax_example_{name}")


def _f32(get):
    return lambda name, **kw: get(name, **{"dtype": "float32", **kw})


# ------------------------------------------------------ danube gptq-int4

DANUBE = "h2o-danube-3-4b"
CALIB_LEN = 80                  # > the reduced window of 32


@pytest.fixture(scope="module")
def danube():
    jcfg = j_get_reduced(DANUBE, dtype="float32")
    cfg = get_reduced(DANUBE, dtype="float32")
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    calib = [{"tokens": rng.integers(0, cfg.vocab_size, (2, CALIB_LEN))
              .astype(np.int32)} for _ in range(3)]
    jq = j_gptq_model(jcfg, params, calib, JQuantConfig(bits=4, group_size=GS))
    return jcfg, cfg, params, calib, jq


def test_danube_calibration_is_longer_than_its_window(danube):
    """The window shapes the calibration: the same replay with the window
    wider than the batches gives layer 1 another attention-input
    Hessian."""
    _, cfg, params, calib, _ = danube
    assert cfg.sliding_window < CALIB_LEN and cfg.num_layers == 2
    bridged = params_from_numpy(_np(params), device="cpu")
    windowed = calibration_hessians(cfg, bridged, calib)
    wide = calibration_hessians(cfg.replace(sliding_window=4 * CALIB_LEN),
                                bridged, calib)
    assert torch.equal(windowed[0][0].h, wide[0][0].h)
    assert not torch.allclose(windowed[1][0].h, wide[1][0].h, rtol=1e-4,
                              atol=0)


def test_danube_gptq_codes_bitwise_jax(danube):
    jcfg, cfg, params, calib, jq = danube
    got = gptq_quantize_model(cfg, params_from_numpy(_np(params),
                                                     device="cpu"),
                              calib, QuantConfig(bits=4, group_size=GS))
    want = _np(jq)
    n = 0
    for block in ("attn", "mlp"):
        for name, w in want["layers"][block].items():
            t = got["layers"][block][name]
            if not isinstance(w, dict):
                np.testing.assert_array_equal(t.numpy(), w, err_msg=name)
                continue
            n += 1
            for key in ("qweight", "scales", "zeros", "g_idx"):
                np.testing.assert_array_equal(t[key].numpy(), w[key],
                                              err_msg=f"{name}/{key}")
    assert n == 7


def _teacher_forced(jcfg, params, prompts, max_tokens):
    """The reference's greedy tokens without its engine: argmax of
    ``JT.forward`` over the prompt plus the tokens so far, one token at a
    time (right-padded to one width, so one trace serves every step)."""
    width = max(len(p) for p in prompts) + max_tokens
    fwd = jax.jit(lambda toks: JT.forward(jcfg, params, {"tokens": toks}))
    seqs = [list(p) for p in prompts]
    out = [[] for _ in prompts]
    for _ in range(max_tokens):
        buf = np.zeros((len(seqs), width), np.int32)
        for i, s in enumerate(seqs):
            buf[i, :len(s)] = s
        logits = np.asarray(fwd(jnp.asarray(buf)))
        for i, s in enumerate(seqs):
            t = int(np.argmax(logits[i, len(s) - 1]))
            s.append(t)
            out[i].append(t)
    return out


ENGINE_KW = dict(max_slots=3, num_blocks=24, max_blocks_per_seq=2,
                 prefill_bucket=16, enable_async_step=False)


def _port_gptq_llm(danube, monkeypatch, **kw):
    """``LLM.load`` of reduced danube with ``gptq-int4`` on the CPU: the
    port's init hands back the JAX package's params, bridged."""
    jcfg, cfg, params, calib, _ = danube
    bridged = params_from_numpy(_np(params), device="cpu")
    monkeypatch.setattr(T, "init_params", lambda c, seed, dev, **k: bridged)
    return LLM.load(DANUBE, quant="gptq-int4", reduced=True,
                    overrides={"dtype": "float32"}, seed=0,
                    calib_batches=calib, device="cpu", **kw)


def test_danube_gptq_single_drain_matches_jax_engine(danube, monkeypatch):
    """One request alone over a 32-slot ring: a prompt of 32 tokens fills
    its ring at admission, so the JAX engine's table has no padding to
    alias onto (a shorter prompt's ring aliases block 0 from position 16
    on, which a window of 32 does not survive: C11), and 40 new tokens
    pass the window and wrap the ring.  The port gives the JAX engine's
    tokens, and teacher forcing's."""
    jcfg, cfg, params, calib, jq = danube
    prompt = np.random.default_rng(11).integers(1, cfg.vocab_size,
                                                32).tolist()
    jllm = JLLM.load(DANUBE, quant="gptq-int4", reduced=True,
                     overrides={"dtype": "float32"}, seed=0,
                     calib_batches=calib, **ENGINE_KW)
    want = jllm.generate([prompt], JSP(max_tokens=40))[0].token_ids
    llm = _port_gptq_llm(danube, monkeypatch, **ENGINE_KW)
    assert llm.engine.scheduler.ring_only and not llm.engine.chunked
    got = llm.generate([prompt], SamplingParams(max_tokens=40))[0]
    assert got.token_ids == want
    assert want == _teacher_forced(jcfg, jq, [prompt], 40)[0]
    llm.close()


@pytest.mark.parametrize("lens", [(9, 9), (5, 9, 20)],
                         ids=["equal", "ragged"])
def test_danube_gptq_batched_drain_matches_teacher_forcing(danube,
                                                           monkeypatch,
                                                           lens):
    """Prompts served together, 40 greedy tokens each over 32-slot rings
    (every ring wraps, every sequence passes the window), against the
    reference's teacher-forced tokens on its own GPTQ artifact."""
    jcfg, cfg, params, calib, jq = danube
    rng = np.random.default_rng(sum(lens))
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]
    want = _teacher_forced(jcfg, jq, prompts, 40)
    llm = _port_gptq_llm(danube, monkeypatch, **ENGINE_KW)
    got = llm.generate(prompts, SamplingParams(max_tokens=40))
    assert [o.token_ids for o in got] == want
    assert llm.engine.alloc.audit()["live_blocks"] == 0
    llm.close()


# -------------------------------------------------------------- examples

EXAMPLES = ("quickstart", "serve_batched", "quantize_model",
            "convert_mha_to_gqa", "train_small")


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_refuses_a_host_without_a_card(name):
    """Every example runs on the card by default: without one it raises
    before it loads anything."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the CUDA default is valid here")
    mod = _port(name)
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main([] if name != "train_small" else ["--steps", "1"])


def _calib_tokens(vocab):
    rng = np.random.default_rng(5)
    return [{"tokens": rng.integers(0, vocab, (2, 32)).astype(np.int32)}
            for _ in range(2)]


def test_quickstart_tokens_match_jax_example(monkeypatch):
    """Both quickstarts on the same weights (the JAX example's init,
    bridged) and the same calibration tokens: the same tokens for every
    request, greedy and sampled."""
    monkeypatch.setattr(j_llm_mod, "get_reduced", _f32(j_get_reduced))
    monkeypatch.setattr(llm_mod, "get_reduced", _f32(get_reduced))
    jcfg = j_get_reduced("qwen2-1.5b", num_layers=4, dtype="float32")
    calib = _calib_tokens(jcfg.vocab_size)
    monkeypatch.setattr(j_llm_mod, "_synthetic_calib",
                        lambda cfg, key: calib)
    seen = []
    generate = JLLM.generate

    def record(self, prompts, sps=None):
        outs = generate(self, prompts, sps)
        seen.append([o.token_ids for o in outs])
        return outs
    monkeypatch.setattr(JLLM, "generate", record)
    _ref("quickstart").main()
    bridged = params_from_numpy(_np(JT.init_params(
        jcfg, jax.random.PRNGKey(0))), device="cpu")
    monkeypatch.setattr(T, "init_params", lambda c, seed, dev, **k: bridged)
    got = _port("quickstart").run("cpu", calib_batches=calib)
    assert got["config"] == "qwen2-1.5b" and got["layers"] == 4
    assert got["tokens"] == seen[0]
    assert set(got["finish_reasons"]) == {"length"}
    assert got["report"]["finished"] == 8
    assert got["report"]["blocks_reused"] > 0


def test_serve_batched_streams_every_request():
    """The JAX example's traffic on its config: every request admitted
    and finished, the streamed events counted, the pool drained."""
    got = _port("serve_batched").main(["--device", "cpu"])
    assert got["config"] == "qwen1.5-0.5b" and got["layers"] == 4
    assert got["finished"] == 24 and got["rejected"] == 0
    assert got["first_tokens_seen"] == 24
    assert got["events"] > 24
    assert all(len(t) >= 1 for t in got["tokens"].values())
    assert got["report"]["finished"] == 24


def _numbers(line):
    return [float(x) for x in re.findall(r"-?\d+\.\d+", line)]


def test_quantize_model_matches_jax_example(capsys, monkeypatch):
    """The single layer's GPTQ and RTN proxy losses (numpy data, float64
    OBQ) as the JAX example prints them, to its digits and within 1e-12;
    the whole model's drift on the JAX example's weights and
    calibration tokens, in f32, within 1e-3."""
    ref = _ref("quantize_model")
    monkeypatch.setattr(ref, "get_reduced", _f32(j_get_reduced))
    ref.main()
    printed = capsys.readouterr().out.splitlines()
    jcfg = j_get_reduced("qwen2-1.5b", num_layers=2, dtype="float32")
    key = jax.random.PRNGKey(0)
    params = params_from_numpy(_np(JT.init_params(jcfg, key)), device="cpu")
    calib = [{"tokens": np.asarray(jax.random.randint(
        jax.random.fold_in(key, i), (2, 32), 0, jcfg.vocab_size))}
        for i in range(4)]
    port = _port("quantize_model")
    monkeypatch.setattr(port, "get_reduced", _f32(get_reduced))
    got = port.run("cpu", params=params, calib=calib)
    assert got["config"] == "qwen2-1.5b" and got["layers"] == 2
    for bits in (4, 3):
        line = next(s for s in printed if s.strip().startswith(f"int{bits}:"))
        eg, er = _numbers(line)[:2]
        mine = got["single"][bits]
        assert f"{mine['gptq']:.5f}" == f"{eg:.5f}"
        assert f"{mine['rtn']:.5f}" == f"{er:.5f}"
        assert mine["gptq"] < mine["rtn"]
    for name in ("gptq", "rtn"):
        line = next(s for s in printed if s.strip().startswith(f"{name}:"))
        drift, agree = _numbers(line)
        assert abs(got["model"][name]["mean_abs_drift"] - drift) <= 1e-3
        assert abs(got["model"][name]["top1_agree"] - agree) <= 0.02


def test_convert_mha_to_gqa_groups_match_jax_example(capsys):
    """The JAX example's MHA weights and calibration tokens through the
    port's conversion: the same groups and similarities as it prints,
    the merged shapes, and the attention after the merge finite."""
    ref = _ref("convert_mha_to_gqa")
    ref.main()
    printed = capsys.readouterr().out.splitlines()
    jcfg = j_get_reduced("qwen1.5-0.5b", num_layers=2, num_kv_heads=4,
                         num_heads=8)
    key = jax.random.PRNGKey(0)
    mha = jcfg.replace(num_kv_heads=jcfg.num_heads)
    params = params_from_numpy(_np(JT.init_params(mha, key)), device="cpu")
    toks = np.asarray(jax.random.randint(key, (4, 64), 0, jcfg.vocab_size))
    got = _port("convert_mha_to_gqa").run("cpu", params=params, tokens=toks)
    groups = next(s for s in printed if s.startswith("groups"))
    assert str(got["groups"]) == groups.split(": ", 1)[1]
    sims = next(s for s in printed if s.startswith("intra-group"))
    assert [f"{got['intra_sim']:.3f}", f"{got['inter_sim']:.3f}"] == \
        [f"{v:.3f}" for v in _numbers(sims)]
    assert got["wk"] == got["wv"] == [jcfg.d_model, 4,
                                      jcfg.resolved_head_dim]
    assert got["kv_share"] == 0.5
    assert np.isfinite(got["attention_rel_diff"])


def test_train_small_trains_and_saves(tmp_path):
    """The JAX example's model (reduced qwen2-1.5b at d_model 384, 6
    layers, batches of 8 x 128) on the CPU: finite losses that fall, and
    the final checkpoint written.  The first steps run at the warmup's
    learning rate (3e-6, 6e-6, 9e-6, ...): over three steps on this seed
    the loss still rises (5.6324 -> 5.6408), over six it falls."""
    losses = _port("train_small").main(["--device", "cpu", "--steps", "6",
                                        "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert (tmp_path / "step_00000006" / "manifest.json").exists()
