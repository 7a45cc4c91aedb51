"""The port's audio encoder (hubert-xlarge: the reference's
``audio_frames`` frontend, a frame projection in place of the token
embedding, then 48 bidirectional layers with layernorm, ALiBi and a GELU
MLP, and 504 frame labels) against the JAX package on the CPU, on the
same bridged params and the same numpy frames.

Layernorm against ``repro.models.layers.apply_norm`` in f32 and bf16;
``T.forward`` on frames at 5e-5 (f32), dense and ``rtn-int4`` (RTN's
tree bitwise the reference's); the frontend's rows in bf16 within one
bf16 step; ``gptq_quantize_model`` on ``frames`` calibration batches,
codes bitwise the reference's; the reference's checkpoint leaves
``frontend_proj`` and layernorm's ``b`` read back bitwise and kept f32
under a cast; the serving entry points refused by name (an encoder has
no decode, as in the reference).

Non-causal ALiBi: the reference disagrees with itself (ROADMAP C3).  Its
oracle ``grouped_attention``, which its CPU forward runs, biases a score
by ``slope * |q_pos - k_pos|``; its Pallas ``_fa_kernel`` by ``slope *
max(q_pos - k_pos, 0)``.  The port holds to the oracle: its plain
version here and its CUDA kernel on the card subtract ``|q_pos -
k_pos|``, so the forward is compared with the reference's CPU route.
``test_flash_attention_d80_vs_pallas_kernel`` pins where the two part:
the port agrees with the Pallas kernel (in interpret mode) when causal,
with or without ALiBi, and when not causal without it; not causal with
ALiBi it agrees with the oracle and differs from the Pallas kernel in
every query row that has a later key, and in no other.

Model: reduced hubert-xlarge (2 layers, d_model 64, 4 / 4 heads of dim
16), f32 activations.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer
from repro.configs.base import QuantConfig as JQuantConfig
from repro.core.alibi import alibi_slopes as j_alibi
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.configs.registry import get_reduced as j_get_reduced
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.quantize import gptq_quantize_model as j_gptq_model
from repro.models.quantize import quantize_params_rtn as j_rtn
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import reader
from repro_torch.configs.base import QuantConfig
from repro_torch.configs.registry import get_config, get_reduced
from repro_torch.core.alibi import alibi_slopes
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.quantize import (gptq_quantize_model,
                                         quantize_params_rtn)
from repro_torch.serving import LLM

ARCH = "hubert-xlarge"
OVR = {"dtype": "float32"}
LOGIT_TOL = 5e-5
GS = 32


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch intra-op thread for this file's small ops (ROADMAP
    C13)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def hubert():
    jcfg, cfg = j_get_reduced(ARCH, **OVR), get_reduced(ARCH, **OVR)
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, params, params_from_numpy(_np(params), device="cpu")


def _frames(cfg, B, S, seed):
    """Frame embeddings at the reference data pipeline's scale (x 0.1)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, cfg.d_model)) * 0.1).astype(np.float32)


def _flat(tree, path=""):
    """{dotted path: leaf} of a nested dict."""
    if not isinstance(tree, dict):
        return {path: tree}
    return {k: v for key, sub in tree.items()
            for k, v in _flat(sub, f"{path}.{key}").items()}


def _close(t, j, tol, err=""):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=0, err_msg=err)


def test_registry_hubert_is_an_encoder():
    """The full config as the reference has it (48 layers, d 1280, 16 / 16
    heads of dim 80, GELU 5120, layernorm, ALiBi, 504 labels), 0.947 B
    parameters by count of the leaves; layernorm's bias beside
    each weight, the frontend's [d, d] projection, no chunked prefill."""
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.num_layers, cfg.d_model, cfg.num_heads,
            cfg.num_kv_heads, cfg.resolved_head_dim, cfg.d_ff,
            cfg.vocab_size, cfg.norm, cfg.pos_emb, cfg.act, cfg.frontend,
            cfg.is_encoder) == \
        ("audio", 48, 1280, 16, 16, 80, 5120, 504, "layernorm", "alibi",
         "gelu", "audio_frames", True)
    assert not T.supports_chunked_prefill(cfg)
    meta = T.init_params(cfg, device="meta")
    assert set(meta) == {"embed", "final_norm", "head", "frontend_proj",
                         "layers"}
    assert tuple(meta["frontend_proj"].shape) == (1280, 1280)
    assert set(meta["layers"]["attn_norm"]) == {"w", "b"}
    assert set(meta["layers"]["mlp"]) == {"w_up", "w_down"}
    n = sum(t.numel() for t in T._leaves(meta))
    assert 0.94e9 < n < 0.95e9


@pytest.mark.parametrize("causal,alibi", [(True, True), (False, False),
                                          (False, True)],
                         ids=["causal-alibi", "noncausal", "noncausal-alibi"])
def test_flash_attention_d80_vs_pallas_kernel(causal, alibi):
    """The static attention at hubert's head dim 80 (G = 1) in f32 against
    the reference's Pallas ``_fa_kernel`` in interpret mode and its oracle
    ``flash_attention_ref``.  The only case where the two references part
    is not causal with ALiBi (ROADMAP C3): the port follows the oracle
    there, and its output differs from the Pallas kernel's in every query
    row with a later key (whose bias the kernel drops) and matches it in
    the last row, which has none."""
    rng = np.random.default_rng(80)
    B, S, H, D = 2, 12, 4, 80
    q, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32)
               for _ in range(3))
    out = ops.flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        alibi_slopes(H) if alibi else None, causal=causal).numpy()
    sl = j_alibi(H) if alibi else None
    pal = np.asarray(j_flash(q, k, v, sl, causal=causal, block_q=8,
                             block_k=8, interpret=True))
    orc = np.asarray(jref.flash_attention_ref(q, k, v, alibi_slopes=sl,
                                              causal=causal))
    np.testing.assert_allclose(out, orc, atol=LOGIT_TOL, rtol=0)
    row_diff = np.abs(out - pal).max(axis=(0, 2, 3))          # [S]
    if causal or not alibi:
        assert row_diff.max() <= LOGIT_TOL
    else:
        assert row_diff[-1] <= LOGIT_TOL
        assert (row_diff[:-1] > 100 * LOGIT_TOL).all(), row_diff


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    """Mean and biased variance in f32, ``w`` and ``b`` applied to the f32
    value before the cast; bitwise in f32 up to the sums' order, within
    one step of the dtype in bf16."""
    rng = np.random.default_rng(2)
    x = rng.normal(1.0, 2.0, (3, 7, 64)).astype(np.float32)
    w = rng.normal(1.0, 0.1, 64).astype(np.float32)
    b = rng.normal(0.0, 0.5, 64).astype(np.float32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = JL.apply_norm({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                         jnp.asarray(x).astype(jd), "layernorm", 1e-6)
    got = L.apply_norm({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                       torch.from_numpy(x).to(getattr(torch, dtype)),
                       "layernorm", 1e-6)
    assert got.dtype == getattr(torch, dtype)
    # bf16's step at |y| < 8 is 2^-5
    _close(got, np.asarray(want, np.float32),
           1e-5 if dtype == "float32" else 2 ** -5)
    assert set(L.norm_init(64, "layernorm")) == {"w", "b"}
    assert set(L.norm_init(64, "rmsnorm")) == {"w"}


@pytest.mark.parametrize("quant", ["dense", "rtn-int4"])
def test_forward_on_frames_matches_jax(hubert, quant):
    """The encoder's logits [B, S, 504] over frames (bidirectional, ALiBi
    by |q_pos - k_pos|, the reference's CPU oracle) at 5e-5; RTN's tree
    bitwise the reference's (``frontend_proj`` and ``head`` stay dense,
    as its QUANT_TARGETS leave them out)."""
    jcfg, cfg, params, bridged = hubert
    if quant == "rtn-int4":
        params = j_rtn(params, jcfg, group_size=GS)
        mine = quantize_params_rtn(bridged, cfg, group_size=GS)
        bridged = params_from_numpy(_np(params), device="cpu")
        flat = _flat(bridged)
        assert set(_flat(mine)) == set(flat)
        for k, v in _flat(mine).items():
            assert torch.equal(v, flat[k]), k
        assert not isinstance(mine["frontend_proj"], dict)
        assert isinstance(mine["layers"]["mlp"]["w_up"], dict)
    frames = _frames(cfg, 2, 37, 3)
    want = JT.forward(jcfg, params, {"frames": jnp.asarray(frames)})
    with torch.no_grad():
        got = T.forward(cfg, bridged, {"frames": frames})
    assert got.shape == (2, 37, cfg.vocab_size)
    _close(got, want, LOGIT_TOL)


def test_frames_frontend_matches_jax_in_bf16(hubert):
    """The frontend in the served dtype: f32 frames times the f32
    ``frontend_proj`` (kept f32 by ``cast_params``), cast to bf16 after,
    as the reference; within one bf16 step of its rows."""
    jcfg, cfg, params, bridged = hubert
    frames = _frames(cfg, 2, 9, 4)
    want = JT._embed_inputs(jcfg.replace(dtype="bfloat16"), params,
                            {"frames": jnp.asarray(frames)}, None, {})
    p = T.cast_params(bridged, torch.bfloat16)
    assert p["frontend_proj"].dtype == torch.float32
    assert p["layers"]["attn_norm"]["b"].dtype == torch.float32
    got = T._embed_inputs(cfg.replace(dtype="bfloat16"), p,
                          {"frames": frames})
    assert got.dtype == torch.bfloat16
    w = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), w, rtol=2 ** -7,
                               atol=1e-6)


def test_gptq_on_frames_matches_jax(hubert):
    """GPTQ calibrated on ``frames`` batches through the encoder (its GELU
    MLP has ``w_up`` alone, which shares the MLP input's Hessian): every
    code, scale, zero and ``g_idx`` bitwise the reference's."""
    jcfg, cfg, params, bridged = hubert
    calib = [{"frames": _frames(cfg, 2, 24, s)} for s in (5, 6)]
    want = _np(j_gptq_model(jcfg, params, [jax.tree.map(jnp.asarray, b)
                                           for b in calib],
                            JQuantConfig(bits=4, group_size=GS)))
    got = gptq_quantize_model(cfg, bridged, calib,
                              QuantConfig(bits=4, group_size=GS))
    n = 0
    for block in ("attn", "mlp"):
        assert set(got["layers"][block]) == set(want["layers"][block])
        for name, w in want["layers"][block].items():
            if not isinstance(w, dict):
                continue
            for key in ("qweight", "scales", "zeros", "g_idx"):
                np.testing.assert_array_equal(
                    got["layers"][block][name][key].numpy(), w[key],
                    err_msg=f"{name}/{key}")
            n += 1
    assert n == 6
    np.testing.assert_array_equal(got["frontend_proj"].numpy(),
                                  want["frontend_proj"])


def test_checkpoint_leaves_cross_over(hubert, tmp_path):
    """The reference's ``Checkpointer`` writes the encoder; the port's
    reader gives ``frontend_proj`` and every layernorm ``b`` back bitwise,
    and a bf16 restore keeps both f32 (as ``cast_params``)."""
    jcfg, cfg, params, _ = hubert
    Checkpointer(str(tmp_path)).save(1, {"params": params})
    tmpl = T.init_params(cfg, device="meta")
    got = reader.restore_params(str(tmp_path), tmpl, device="cpu")
    want = _np(params)
    np.testing.assert_array_equal(got["frontend_proj"].numpy(),
                                  want["frontend_proj"])
    for norm in ("attn_norm", "mlp_norm"):
        np.testing.assert_array_equal(got["layers"][norm]["b"].numpy(),
                                      want["layers"][norm]["b"])
    np.testing.assert_array_equal(got["final_norm"]["b"].numpy(),
                                  want["final_norm"]["b"])
    cast = reader.restore_params(str(tmp_path), tmpl, device="cpu",
                                 dtype=torch.bfloat16)
    assert cast["frontend_proj"].dtype == torch.float32
    assert cast["layers"]["mlp_norm"]["b"].dtype == torch.float32
    assert cast["layers"]["attn"]["wq"].dtype == torch.bfloat16


def test_serving_an_encoder_is_refused_by_name(hubert):
    """An encoder has no decode, in the reference as here: the decode
    state, prefill and ``LLM.load`` raise, naming the config, before
    anything is drawn (the decode step and the prefill chunk need the
    state that ``make_decode_state`` refuses to build)."""
    _, cfg, _, bridged = hubert
    match = "hubert-xlarge is an encoder"
    with pytest.raises(NotImplementedError, match=match):
        T.make_decode_state(cfg, 2, 8, 2, device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        T.prefill(cfg, bridged, {}, {"tokens": torch.zeros((1, 4)),
                                     "ctx_lens": torch.ones(1)})
    for quant in (None, "rtn-int4", "gptq-int4"):
        with pytest.raises(NotImplementedError, match=match):
            LLM.load(ARCH, quant=quant, reduced=True, device="cpu")
