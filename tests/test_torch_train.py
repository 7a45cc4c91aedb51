"""The port's trainer against the JAX package's on the CPU, on the same
numpy inputs and bridged params: ``loss_fn`` (dense GQA and MHA, a
sliding window, a vision prefix, audio frames), per-leaf gradients and
the rematerialised forward, ``flash_attention``'s gradients and its
autograd rule, AdamW and its schedule, the train step with one and two
microbatches, ``SyntheticLM``, the checkpoint writer (files, manifest,
restores across the two packages), the ``Supervisor`` and the train CLI.

Tolerances: losses 1e-5 relative in f32 (2e-2 with bf16 activations,
where the two frameworks round at other places); gradients 1e-4 of each
leaf's largest |g|; AdamW 1e-6 relative (of each leaf's largest entry);
the train step's 3-step update (params after minus before) within 1e-2
of the reference's in norm: Adam's first steps take each gradient entry
to about +-1, so an entry whose gradient is within f32 noise of zero
may step the other way (measured 2.0e-3).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import AsyncCheckpointer as JAsync
from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs.base import ShapeConfig as JShape
from repro.configs.registry import get_reduced as j_get_reduced
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.kernels import ops as jops
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.runtime.train_loop import make_train_step as j_make_train_step
from repro_torch.bridge import (opt_state_from_numpy, opt_state_to_numpy,
                                params_from_numpy, params_to_numpy)
from repro_torch.checkpoint.checkpointer import (AsyncCheckpointer,
                                                 Checkpointer)
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_reduced
from repro_torch.core.alibi import alibi_slopes
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.launch import train as cli
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as A
from repro_torch.runtime.fault import PreemptionError, Supervisor
from repro_torch.runtime.train_loop import make_train_step


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

LOSS_REL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_REL = 1e-4
ADAM_REL = 1e-6
STEP_UPDATE_REL = 1e-2
# (arch, config overrides): a window shorter than the sequence bites
ARCHS = {"qwen2-1.5b": {}, "qwen1.5-0.5b": {},
         "h2o-danube-3-4b": {"sliding_window": 6},
         "llava-next-mistral-7b": {}, "hubert-xlarge": {}}
TRAINED = ("qwen2-1.5b", "h2o-danube-3-4b", "llava-next-mistral-7b",
           "hubert-xlarge")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _configs(arch, dtype="float32"):
    kw = dict(ARCHS[arch], dtype=dtype)
    return j_get_reduced(arch, **kw), get_reduced(arch, **kw)


def _batch(cfg, B=2, S=12, seed=1):
    rng = np.random.default_rng(seed)
    if cfg.is_encoder:
        return {"frames": rng.standard_normal((B, S, cfg.d_model))
                .astype(np.float32),
                "labels": rng.integers(0, cfg.vocab_size, (B, S))
                .astype(np.int32)}
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S + 1))
         .astype(np.int32)}
    if cfg.frontend == "vision_patches":
        b["vision_embeds"] = (rng.standard_normal(
            (B, cfg.num_prefix_embeds, cfg.d_model)) * 0.1).astype(np.float32)
    return b


@pytest.fixture(scope="module")
def jax_params():
    """The JAX package's f32 init of each reduced arch, as numpy."""
    out = {}
    for arch in ARCHS:
        jcfg, _ = _configs(arch)
        out[arch] = _np(JT.init_params(jcfg, jax.random.PRNGKey(0)))
    return out


def _port_params(npp):
    return T.unstack_layers(params_from_numpy(npp, device="cpu"))


def _grads(cfg, params, batch):
    leaves = A.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = T.loss_fn(cfg, params, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    g = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if d is None else d
              for p, d in zip(leaves, g))
    return loss.detach(), A.tree_map(lambda _: next(it), params)


# ------------------------------------------------------------------ loss
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_loss_matches_jax(jax_params, arch, dtype):
    jcfg, cfg = _configs(arch, dtype)
    batch = _batch(cfg)
    want = float(JT.loss_fn(jcfg, jax.tree.map(jnp.asarray, jax_params[arch]),
                            {k: jnp.asarray(v) for k, v in batch.items()}))
    with torch.no_grad():
        got = float(T.loss_fn(cfg, _port_params(jax_params[arch]),
                              {k: torch.from_numpy(v)
                               for k, v in batch.items()}))
    assert abs(got - want) <= LOSS_REL[dtype] * abs(want), (got, want)


def test_loss_mask_weights_the_mean(jax_params):
    jcfg, cfg = _configs("qwen2-1.5b")
    batch = _batch(cfg)
    batch["loss_mask"] = (np.arange(12)[None] % 3 != 0).astype(
        np.float32).repeat(2, 0)
    want = float(JT.loss_fn(jcfg, jax.tree.map(jnp.asarray,
                                               jax_params["qwen2-1.5b"]),
                            {k: jnp.asarray(v) for k, v in batch.items()}))
    with torch.no_grad():
        got = float(T.loss_fn(cfg, _port_params(jax_params["qwen2-1.5b"]),
                              batch))
    assert abs(got - want) <= LOSS_REL["float32"] * abs(want)


# ------------------------------------------------------------- gradients
@pytest.mark.parametrize("arch", TRAINED)
def test_grads_match_jax(jax_params, arch):
    """Every leaf's gradient (the encoder's unused embedding included,
    zeros in both) within GRAD_REL of the leaf's largest |g|."""
    jcfg, cfg = _configs(arch)
    batch = _batch(cfg)
    jg = jax.grad(lambda p: JT.loss_fn(
        jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}))(
        jax.tree.map(jnp.asarray, jax_params[arch]))
    _, g = _grads(cfg, _port_params(jax_params[arch]), batch)
    want, got = _flat(jg), _flat(params_to_numpy(g))
    assert want.keys() == got.keys()
    for k in want:
        scale = max(np.abs(want[k]).max(), 1e-30)
        assert np.abs(got[k] - want[k]).max() <= GRAD_REL * scale, k


def test_remat_gives_the_plain_grads(jax_params, monkeypatch):
    """The forward under grad runs each layer through
    ``torch.utils.checkpoint``; the same loss without it gives bitwise
    the same gradients."""
    _, cfg = _configs("qwen2-1.5b")
    batch = _batch(cfg)
    calls = []
    real = T.checkpoint

    def counted(fn, *a, **kw):
        calls.append(1)
        return real(fn, *a, **kw)

    monkeypatch.setattr(T, "checkpoint", counted)
    l1, g1 = _grads(cfg, _port_params(jax_params["qwen2-1.5b"]), batch)
    assert len(calls) == cfg.num_layers
    monkeypatch.setattr(T, "checkpoint", lambda fn, *a, **kw: fn(*a))
    l2, g2 = _grads(cfg, _port_params(jax_params["qwen2-1.5b"]), batch)
    assert torch.equal(l1, l2)
    for a, b in zip(A.tree_leaves(g1), A.tree_leaves(g2)):
        assert torch.equal(a, b)
    # no grad: the plain loop, no checkpoint
    calls.clear()
    monkeypatch.setattr(T, "checkpoint", counted)
    with torch.no_grad():
        T.forward(cfg, _port_params(jax_params["qwen2-1.5b"]),
                  {"tokens": torch.from_numpy(batch["tokens"])})
    assert not calls


# -------------------------------------------------------- flash attention
FLASH_CASES = {"causal": {}, "not causal": {"causal": False},
               "window 5": {"sliding_window": 5},
               "ALiBi": {"alibi_slopes": True},
               "not causal ALiBi": {"causal": False, "alibi_slopes": True},
               "q_offset 4, window 6": {"q_offset": 4, "sliding_window": 6}}


def _flash_inputs(kw, seed=0):
    rng = np.random.default_rng(seed)
    sq = 8 if kw.get("q_offset") else 12
    shapes = ((2, sq, 6, 16), (2, 12, 2, 16), (2, 12, 2, 16), (2, sq, 6, 16))
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in shapes)
    kw = dict(kw)
    if kw.pop("alibi_slopes", False):
        kw["alibi_slopes"] = np.asarray(alibi_slopes(6, "cpu"))
    return q, k, v, do, kw


def _torch_kw(kw):
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_grads_match_jax(case):
    """dq, dk, dv of the port's ``ops.flash_attention`` (the plain version
    on the CPU) against ``jax.vjp`` of the reference's XLA path."""
    q, k, v, do, kw = _flash_inputs(FLASH_CASES[case])
    slopes = kw.pop("alibi_slopes", None)
    out, vjp = jax.vjp(lambda a, b, c: jops.flash_attention(
        a, b, c, None if slopes is None else jnp.asarray(slopes),
        use_pallas=False, **kw), *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o = ops.flash_attention(*ts, None if slopes is None
                            else torch.from_numpy(slopes), **kw)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(out),
                               rtol=1e-5, atol=1e-5)
    got = torch.autograd.grad(o, ts, torch.from_numpy(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_fn_backward_is_the_plain_autograd(case,
                                                           monkeypatch):
    """``FlashAttentionFn`` with its kernel replaced by the plain version
    (the kernel runs on the card only): one counted launch a forward, and
    dq, dk, dv bitwise the plain version's autograd, also when only some
    inputs require grad.  ``ops.flash_attention`` routes a CUDA call that
    autograd records through it (``_on_cuda`` patched here)."""
    q, k, v, do, kw = _flash_inputs(FLASH_CASES[case], seed=2)
    kw = _torch_kw(kw)
    launches = []

    def kernel(q_, k_, v_, slopes=None, **kw_):
        launches.append(1)
        assert not torch.is_grad_enabled()
        return ref.flash_attention_ref(q_, k_, v_, alibi_slopes=slopes,
                                       **kw_)

    monkeypatch.setattr(fa, "flash_attention", kernel)
    monkeypatch.setattr(ops, "_flash", kernel)
    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    slopes = kw.pop("alibi_slopes", None)
    for needs in ((True, True, True), (False, True, False)):
        ts = [torch.from_numpy(a).requires_grad_(n)
              for a, n in zip((q, k, v), needs)]
        o = ops.flash_attention(*ts, slopes, **kw)
        assert o.grad_fn is not None and len(launches) == 1
        launches.clear()
        got = torch.autograd.grad(o, [t for t in ts if t.requires_grad],
                                  torch.from_numpy(do))
        want_o = ref.flash_attention_ref(*ts, alibi_slopes=slopes, **kw)
        want = torch.autograd.grad(want_o, [t for t in ts
                                            if t.requires_grad],
                                   torch.from_numpy(do))
        assert not launches
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    with torch.no_grad():                   # serving: the kernel alone
        o = ops.flash_attention(*ts, slopes, **kw)
    assert o.grad_fn is None and len(launches) == 1


def test_serving_kernels_refuse_autograd(monkeypatch):
    """On the card every kernel but the static attention raises when
    autograd would record its call, instead of returning an output
    without a grad_fn (``_on_cuda`` patched, the kernels replaced by a
    marker); under no_grad each launches."""
    launched = []
    marker = lambda *a, **kw: launched.append(1) or a[0]
    for name in ("_paged", "_paged_quant", "flash_attention_chunk",
                 "flash_attention_chunk_int8", "gptq_matmul",
                 "_selective_scan", "_linear_scan"):
        monkeypatch.setattr(ops, name, marker)
    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    x = torch.ones(2, 4, requires_grad=True)
    z = torch.zeros(2, 4)
    int4 = {"qweight": torch.zeros(1, 4, dtype=torch.int32),
            "scales": torch.ones(1, 4), "zeros": torch.zeros(1, 4)}
    calls = {
        "paged_attention": lambda a: ops.paged_attention(a, z, z, z, z),
        "paged_attention_quant": lambda a: ops.paged_attention_quant(
            a, z, z, z, z, z, z),
        "flash_attention_chunk": lambda a: ops.chunk_prefill_attention(
            a, z[None], z[None], None, None, 0, z, z, z, z, z),
        "gptq_matmul": lambda a: ops.quant_matmul(a, int4),
        "selective_scan": lambda a: ops.selective_scan(a, z, z, z, z, z),
        "linear_scan": lambda a: ops.linear_scan(a, z, z)}
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=name):
            call(x)
        with torch.no_grad():
            call(x)
        call(z)                            # nothing requires grad
    assert len(launched) == 2 * len(calls)


# ------------------------------------------------------------------ AdamW
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax(moment_dtype):
    """5 steps of ``apply_updates`` on the same params and gradients (one
    step with a gradient norm above the clip): params, mu, nu,
    ``grad_norm`` and ``lr`` within ADAM_REL; the port's tree holds a
    per-layer list, the reference's the stacked leaf."""
    rng = np.random.default_rng(0)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=6,
               moment_dtype=moment_dtype)
    jcfg, pcfg = JA.AdamWConfig(**cfg), A.AdamWConfig(**cfg)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
          "layers": {"w": rng.standard_normal((2, 5, 3)).astype(np.float32)}}
    jp = jax.tree.map(jnp.asarray, p0)
    jst = JA.init_opt_state(jp, jcfg)
    pp = T.unstack_layers(params_from_numpy(p0, device="cpu"))
    pst = A.init_opt_state(pp, pcfg)
    # the bf16 moments round the same f32 values: keep clipping (whose
    # scale sums in another order) to the f32 run
    big = 3.0 if moment_dtype == "float32" else 0.5
    for i in range(5):
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.05
                                    * (big if i == 2 else 1.0))
                         .astype(np.float32), p0)
        jp, jst, jm = JA.apply_updates(jp, jax.tree.map(jnp.asarray, g),
                                       jst, jcfg)
        gp = T.unstack_layers(params_from_numpy(g, device="cpu"))
        pp, pst, pm = A.apply_updates(pp, gp, pst, pcfg)
        for k in ("grad_norm", "lr"):
            assert abs(float(pm[k]) - float(jm[k])) \
                <= ADAM_REL * abs(float(jm[k])), (i, k)
        step, mu, nu = opt_state_to_numpy(pst)
        assert int(step) == int(jst.step) == i + 1
        for want, got in ((jp, params_to_numpy(pp)),
                          (jax.tree.map(lambda a: np.asarray(
                              a.astype(jnp.float32)), jst.mu), mu),
                          (jax.tree.map(lambda a: np.asarray(
                              a.astype(jnp.float32)), jst.nu), nu)):
            for k, w in _flat(want).items():
                np.testing.assert_allclose(
                    _flat(got)[k], w, rtol=ADAM_REL,
                    atol=ADAM_REL * np.abs(w).max())
    assert pst.mu["a"].dtype == getattr(torch, moment_dtype)


def test_lr_schedule_matches_jax():
    for cfg in ({"warmup_steps": 3, "total_steps": 10},
                {"warmup_steps": 100, "total_steps": 10000}):
        for s in (0, 1, 2, 3, 5, 9, 10, 50, 99, 100, 5000, 10000, 12000):
            want = float(JA.lr_at(JA.AdamWConfig(**cfg), jnp.int32(s)))
            got = float(A.lr_at(A.AdamWConfig(**cfg),
                                torch.tensor(s, dtype=torch.int32)))
            assert abs(got - want) <= ADAM_REL * want, (cfg, s)


def test_opt_state_bridge_round_trip(jax_params):
    jcfg, _ = _configs("qwen2-1.5b")
    jst = JA.init_opt_state(jax.tree.map(jnp.asarray,
                                         jax_params["qwen2-1.5b"]),
                            JA.AdamWConfig())
    jst = JA.OptState(jnp.int32(7), *jax.tree.map(
        lambda a: a + 0.5, (jst.mu, jst.nu)))
    st = opt_state_from_numpy(_np(jst), device="cpu")
    assert isinstance(st, A.OptState) and int(st.step) == 7
    back = opt_state_to_numpy(st)
    for w, g in zip(jax.tree.leaves(_np(jst)), jax.tree.leaves(back)):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------- train step
@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_matches_jax(jax_params, micro):
    """3 steps of ``make_train_step`` against the reference's
    (``ctx=None``) from the same params, on the same batches: losses
    within LOSS_REL, each leaf's 3-step update within STEP_UPDATE_REL of
    the reference's in norm."""
    jcfg, cfg = _configs("qwen2-1.5b")
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    rng = np.random.default_rng(1)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (4, 17))
                .astype(np.int32)} for _ in range(3)]
    npp = jax_params["qwen2-1.5b"]
    jstep = jax.jit(j_make_train_step(jcfg, JA.AdamWConfig(**kw), None,
                                      None, micro))
    jp = jax.tree.map(jnp.asarray, npp)
    jo = JA.init_opt_state(jp, JA.AdamWConfig(**kw))
    step = make_train_step(cfg, A.AdamWConfig(**kw), num_microbatches=micro)
    pp = _port_params(npp)
    po = A.init_opt_state(pp, A.AdamWConfig(**kw))
    for b in batches:
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        pp, po, pm = step(pp, po, b)
        assert abs(float(pm["loss"]) - float(jm["loss"])) \
            <= LOSS_REL["float32"] * float(jm["loss"])
    p0, want, got = _flat(npp), _flat(jp), _flat(params_to_numpy(pp))
    for k in p0:
        dw, dg = want[k] - p0[k], got[k] - p0[k]
        assert np.linalg.norm(dg - dw) <= STEP_UPDATE_REL \
            * np.linalg.norm(dw), k
    assert int(po.step) == 3


@pytest.mark.parametrize("arch", TRAINED)
def test_repeated_batch_loss_descends(jax_params, arch):
    """As ``tests/test_arch_smoke.py``: three steps on one batch, each
    loss below the first, for every trained family."""
    _, cfg = _configs(arch)
    opt = A.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    step = make_train_step(cfg, opt)
    p = _port_params(jax_params[arch])
    o = A.init_opt_state(p, opt)
    batch = _batch(cfg)
    losses = []
    for _ in range(3):
        p, o, m = step(p, o, batch)
        losses.append(float(m["loss"]))
        assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0], losses


def test_train_step_refuses_stacked_params(jax_params):
    _, cfg = _configs("qwen2-1.5b")
    opt = A.AdamWConfig()
    stacked = params_from_numpy(jax_params["qwen2-1.5b"], device="cpu")
    step = make_train_step(cfg, opt)
    with pytest.raises(ValueError, match="unstack_layers"):
        step(stacked, A.init_opt_state(stacked, opt), _batch(cfg))
    np.testing.assert_array_equal(
        params_to_numpy(T.unstack_layers(stacked))["layers"]["mlp"]["w_up"],
        jax_params["qwen2-1.5b"]["layers"]["mlp"]["w_up"])


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "llava-next-mistral-7b",
                                  "hubert-xlarge"])
def test_synthetic_lm_is_the_reference_stream(arch):
    jcfg, cfg = _configs(arch)
    j = JSyntheticLM(jcfg, JShape("t", 16, 4, "train"), seed=3)
    p = SyntheticLM(cfg, ShapeConfig("t", 16, 4, "train"), seed=3)
    for _ in range(3):
        want, got = j.next_batch(), p.next_batch("cpu")
        assert want.keys() == got.keys()
        for k in want:
            assert got[k].dtype == getattr(torch, str(want[k].dtype))
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    st = p.state()
    assert st == j.state() == {"step": 3, "seed": 3}
    nxt = p.next_batch("cpu")
    q = SyntheticLM(cfg, ShapeConfig("t", 16, 4, "train"))
    q.restore(st)
    for k, v in q.next_batch("cpu").items():
        assert torch.equal(v, nxt[k])


# ------------------------------------------------------------ checkpoints
def _trees(npp, moment_dtype="float32"):
    p = _port_params(npp)
    return {"params": p,
            "opt": A.init_opt_state(p, A.AdamWConfig(
                moment_dtype=moment_dtype))._replace(
                step=torch.tensor(5, dtype=torch.int32))}


def test_port_checkpoint_is_the_reference_format(jax_params, tmp_path):
    """The same params and optimizer state saved by both writers: the
    same file names and manifest; the reference's ``restore`` reads the
    port's f32 checkpoint bitwise, and the port reads the reference's
    into its per-layer layout bitwise."""
    npp = jax_params["qwen2-1.5b"]
    trees = _trees(npp)
    for leaf in A.tree_leaves(trees["opt"].mu):
        leaf.add_(0.25)
    extra = {"data": {"step": 5, "seed": 0}}
    Checkpointer(str(tmp_path / "port")).save(5, trees, extra=extra)
    step, mu, nu = opt_state_to_numpy(trees["opt"])
    jtrees = {"params": jax.tree.map(jnp.asarray, npp),
              "opt": JA.OptState(jnp.int32(step), *jax.tree.map(
                  jnp.asarray, (mu, nu)))}
    JCheckpointer(str(tmp_path / "jax")).save(5, jtrees, extra=extra)
    dp, dj = tmp_path / "port" / "step_00000005", \
        tmp_path / "jax" / "step_00000005"
    assert sorted(os.listdir(dp)) == sorted(os.listdir(dj))
    assert json.loads((dp / "manifest.json").read_text()) \
        == json.loads((dj / "manifest.json").read_text())
    got, ex = JCheckpointer(str(tmp_path / "port")).restore(5, jtrees)
    assert ex == extra
    for w, g in zip(jax.tree.leaves(jtrees), jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    back, ex = Checkpointer(str(tmp_path / "jax")).restore(
        5, trees, device="cpu")
    assert ex == extra and isinstance(back["opt"], A.OptState)
    assert isinstance(back["params"]["layers"], list)
    for w, g in zip(A.tree_leaves(trees), A.tree_leaves(back)):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_bf16_checkpoint_port_to_port(jax_params, tmp_path):
    """bf16 leaves (here the moments) are written as ``|V2`` words, which
    the reference cannot read back (ROADMAP C10): port to port only."""
    trees = _trees(jax_params["qwen2-1.5b"], "bfloat16")
    for leaf in A.tree_leaves(trees["opt"].nu):
        leaf.add_(0.123)
    ck = Checkpointer(str(tmp_path))
    ck.save(5, trees)
    arr = np.load(tmp_path / "step_00000005" / "opt.nu.embed.npy")
    assert arr.dtype.kind == "V" and arr.dtype.itemsize == 2
    back, _ = ck.restore(5, trees, device="cpu")
    for w, g in zip(A.tree_leaves(trees), A.tree_leaves(back)):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_checkpoint_gc_and_async(tmp_path):
    ck = Checkpointer(str(tmp_path / "gc"), keep=2)
    x = {"w": torch.ones(3)}
    for s in (1, 2, 3, 4):
        ck.save(s, {"t": x})
    assert ck.all_steps() == [3, 4] and ck.latest_step() == 4
    ack = AsyncCheckpointer(str(tmp_path / "async"))
    x = {"w": torch.arange(5.0), "layers": [{"v": torch.ones(2)},
                                            {"v": torch.zeros(2)}]}
    ack.save_async(3, {"t": x})
    x["w"].add_(100.0)                # after the call: not in the file
    ack.wait()
    back, _ = ack.restore(3, {"t": x}, device="cpu")
    assert torch.equal(back["t"]["w"], torch.arange(5.0))
    assert torch.equal(back["t"]["layers"][1]["v"], torch.zeros(2))
    assert np.load(tmp_path / "async" / "step_00000003" /
                   "t.layers.v.npy").shape == (2, 2)
    # a JAX AsyncCheckpointer's files read back by the port
    j = JAsync(str(tmp_path / "jasync"))
    j.save_async(2, {"t": {"w": jnp.arange(4.0)}})
    j.wait()
    back, _ = Checkpointer(str(tmp_path / "jasync")).restore(
        2, {"t": {"w": torch.zeros(4)}}, device="cpu")
    assert torch.equal(back["t"]["w"], torch.arange(4.0))


# --------------------------------------------------- Supervisor and CLI
def test_supervisor_recovers_like_an_uninterrupted_run(tmp_path):
    """The reference's supervision scenario on the port's state: a
    failure before step 7 restores step 5 and ends where an uninterrupted
    run ends, no step lost or doubled."""
    def run(directory, fail_at):
        ck = Checkpointer(str(directory))

        def step_fn(step, st):
            st = dict(st)
            st["trees"] = {"v": {"x": st["trees"]["v"]["x"] * 1.5 + step}}
            return st

        def restore_fn(last):
            trees, extra = ck.restore(last, {"v": {"x": torch.zeros(())}},
                                      device="cpu")
            return {"step": last, "trees": trees, "extra": extra}

        failed = {"done": False}

        def fail_hook(step):
            if step == fail_at and not failed["done"]:
                failed["done"] = True
                raise PreemptionError("node lost")

        sup = Supervisor(checkpointer=ck, save_every=5)
        final = sup.run(total_steps=12,
                        state={"step": 0,
                               "trees": {"v": {"x": torch.ones(())}},
                               "extra": {}},
                        step_fn=step_fn, restore_fn=restore_fn,
                        fail_hook=fail_hook)
        return sup, final

    sup, final = run(tmp_path / "a", 7)
    ref_sup, ref_final = run(tmp_path / "b", -1)
    assert sup.restarts == 1 and ref_sup.restarts == 0
    assert final["step"] == 12
    assert torch.equal(final["trees"]["v"]["x"], ref_final["trees"]["v"]["x"])
    assert [h["event"] for h in sup.history].count("restart") == 1


def test_train_cli_survives_a_failure_and_resumes(tmp_path):
    """``launch.train.main`` on the CPU: a run with a failure injected
    before step 7 (restored from step 5; steps 5 and 6 run again) gives
    an uninterrupted run's losses, and ``--resume`` continues a shorter
    run to the same losses; its final checkpoint equals the
    uninterrupted run's bitwise."""
    base = ["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--save-every", "5"]
    plain = cli.main([*base, "--steps", "9",
                      "--ckpt-dir", str(tmp_path / "plain")])
    failed = cli.main([*base, "--steps", "9", "--fail-at-step", "7",
                       "--ckpt-dir", str(tmp_path / "failed")])
    assert len(plain) == 9 and failed == plain[:7] + plain[5:]
    first = cli.main([*base, "--steps", "5",
                      "--ckpt-dir", str(tmp_path / "resumed")])
    rest = cli.main([*base, "--steps", "9", "--resume",
                     "--ckpt-dir", str(tmp_path / "resumed")])
    assert first + rest == plain
    for d in ("failed", "resumed"):
        for f in os.listdir(tmp_path / "plain" / "step_00000009"):
            a = tmp_path / "plain" / "step_00000009" / f
            b = tmp_path / d / "step_00000009" / f
            if f.endswith(".npy"):
                np.testing.assert_array_equal(np.load(b), np.load(a))
