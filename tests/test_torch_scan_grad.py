"""Gradients of the time scans and of the routed experts, the trainer's
new paths for the MoE, hybrid and Mamba families, on the CPU against the
JAX package on the same numpy inputs:

(a) the plain backward versions ``linear_scan_bwd_ref`` and
    ``selective_scan_bwd_ref`` (the backward kernels' yardsticks) against
    float64 autograd of the plain forwards, from a nonzero h0 and with a
    nonzero ``g_hlast``;
(b) both against ``jax.vjp`` of the reference's scan steps (its
    ``_chunked_time_scan`` over the RG-LRU's and the Mamba-1 step), and
    autograd of the port's ``_rglru_scan`` / ``_ssm_inner`` against
    ``jax.vjp`` of the reference's;
(c) the autograd rules ``LinearScanFn`` and ``SelectiveScanFn`` with
    ``_on_cuda`` patched (the CUDA routing runs on the CPU) and the kernel
    launches patched to the plain forward and backward versions: autograd
    of the plain composition, one backward launch a call, a mask refused
    under autograd, and the serving kernels alone under ``no_grad``;
(d) the MoE layer's gradients against ``jax.grad`` of the reference's
    ``moe_apply`` (f32), with an expert that receives no token getting an
    exact zero, and the dispatch gather bitwise the old one.

Tolerances: float64 1e-10 of each output's largest entry; f32 against the
reference 1e-5 of each output's largest entry (the two frameworks sum in
other orders); the patched autograd rules 1e-5 in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced as j_get_reduced
from repro.models import moe as JM
from repro.models import ssm as JS
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import get_reduced
from repro_torch.kernels import ops, ref, time_scan
from repro_torch.models import moe as M
from repro_torch.models import ssm as PS


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Run this file on one torch intra-op thread (ROADMAP C13, C15)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


F64_REL = 1e-10
JAX_REL = 1e-5
FN_REL = 1e-5
S_CASES = (1, 16, 37)     # one step, one checkpoint chunk, a ragged one


def _close(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{what}: {err:.3e} over {scale:.3e}"


def _linear_inputs(S, dtype=np.float64, seed=0, Bt=2, w=6):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.99, (Bt, S, w))
    g = rng.standard_normal((Bt, S, w))
    h0 = rng.standard_normal((Bt, w))
    ghs = rng.standard_normal((Bt, S, w))
    ghl = rng.standard_normal((Bt, w))
    return [x.astype(dtype) for x in (a, g, h0, ghs, ghl)]


def _selective_inputs(S, dtype=np.float64, seed=0, Bt=2, din=5, N=4):
    rng = np.random.default_rng(seed)
    dt = rng.uniform(0.01, 0.5, (Bt, S, din))
    u = rng.standard_normal((Bt, S, din))
    B = rng.standard_normal((Bt, S, N))
    C = rng.standard_normal((Bt, S, N))
    A = -rng.uniform(0.2, 2.0, (din, N))
    h0 = rng.standard_normal((Bt, din, N))
    gy = rng.standard_normal((Bt, S, din))
    ghl = rng.standard_normal((Bt, din, N))
    return [x.astype(dtype) for x in (dt, u, B, C, A, h0, gy, ghl)]


def _t(arrays, grad=False):
    return [torch.from_numpy(x).requires_grad_(grad) for x in arrays]


# ------------------------------------------------- (a) float64 autograd
@pytest.mark.parametrize("S", S_CASES)
@pytest.mark.parametrize("with_hlast", [True, False])
def test_linear_scan_bwd_ref_is_float64_autograd(S, with_hlast):
    a, g, h0, ghs, ghl = _linear_inputs(S)
    ins = _t((a, g, h0), grad=True)
    hs, h_last = ref.linear_scan_ref(*ins)
    outs, cots = [hs], [torch.from_numpy(ghs)]
    if with_hlast:
        outs.append(h_last)
        cots.append(torch.from_numpy(ghl))
    want = torch.autograd.grad(outs, ins, cots)
    got = ref.linear_scan_bwd_ref(
        *_t((a,)), hs.detach(), *_t((h0, ghs)),
        torch.from_numpy(ghl) if with_hlast else None)
    for name, gg, w in zip(("ga", "gg", "gh0"), got, want):
        _close(gg, w, F64_REL, name)


@pytest.mark.parametrize("S", S_CASES)
@pytest.mark.parametrize("with_hlast", [True, False])
def test_selective_scan_bwd_ref_is_float64_autograd(S, with_hlast):
    dt, u, B, C, A, h0, gy, ghl = _selective_inputs(S)
    ins = _t((dt, u, B, C, A, h0), grad=True)
    y, h_last = ref.selective_scan_ref(*ins)
    outs, cots = [y], [torch.from_numpy(gy)]
    if with_hlast:
        outs.append(h_last)
        cots.append(torch.from_numpy(ghl))
    want = torch.autograd.grad(outs, ins, cots)
    got = ref.selective_scan_bwd_ref(
        *_t((dt, u, B, C, A, h0, gy)),
        torch.from_numpy(ghl) if with_hlast else None)
    for name, gg, w in zip(("gdt", "gu", "gB", "gC", "gA", "gh0"), got, want):
        _close(gg, w, F64_REL, name)


# ------------------------------------------------ (b) the reference's vjp
def _tm(x):
    return x.transpose(1, 0, 2)


def _j_linear(a, g, h0):
    """The reference's RG-LRU scan over (a, g): its ``_chunked_time_scan``
    with ``_rglru_scan``'s step."""
    def step(h, x_t):
        a_t, g_t = x_t
        h = a_t * h + g_t
        return h, h

    h, hs = JS._chunked_time_scan(step, h0, (_tm(a), _tm(g)), JS.CHUNK)
    return _tm(hs), h


def _j_selective(dt, u, B, C, A, h0):
    """The reference's Mamba-1 scan: its ``_chunked_time_scan`` with
    ``_ssm_inner``'s step."""
    def step(h, x_t):
        dt_t, u_t, b_t, c_t = x_t
        da = jnp.exp(dt_t[..., None] * A[None])
        h = da * h + (dt_t * u_t)[..., None] * b_t[:, None, :]
        return h, jnp.einsum("bdn,bn->bd", h, c_t)

    h, ys = JS._chunked_time_scan(step, h0, tuple(map(_tm, (dt, u, B, C))),
                                  JS.CHUNK)
    return _tm(ys), h


@pytest.mark.parametrize("S", S_CASES)
def test_linear_scan_bwd_ref_matches_jax_vjp(S):
    a, g, h0, ghs, ghl = _linear_inputs(S, np.float32, seed=1)
    _, vjp = jax.vjp(_j_linear, *map(jnp.asarray, (a, g, h0)))
    want = vjp((jnp.asarray(ghs), jnp.asarray(ghl)))
    hs, _ = ref.linear_scan_ref(*_t((a, g, h0)))
    got = ref.linear_scan_bwd_ref(torch.from_numpy(a), hs,
                                  *_t((h0, ghs, ghl)))
    for name, gg, w in zip(("ga", "gg", "gh0"), got, want):
        _close(gg, w, JAX_REL, name)


@pytest.mark.parametrize("S", S_CASES)
def test_selective_scan_bwd_ref_matches_jax_vjp(S):
    dt, u, B, C, A, h0, gy, ghl = _selective_inputs(S, np.float32, seed=1)
    _, vjp = jax.vjp(_j_selective, *map(jnp.asarray, (dt, u, B, C, A, h0)))
    want = vjp((jnp.asarray(gy), jnp.asarray(ghl)))
    got = ref.selective_scan_bwd_ref(*_t((dt, u, B, C, A, h0, gy, ghl)))
    for name, gg, w in zip(("gdt", "gu", "gB", "gC", "gA", "gh0"), got, want):
        _close(gg, w, JAX_REL, name)


def _cfgs(arch, **kw):
    kw.setdefault("dtype", "float32")
    return j_get_reduced(arch, **kw), get_reduced(arch, **kw)


def _mixer(arch, init, S=13, Bt=2, seed=3):
    """The reference's init of one mixer of ``arch`` (f32) and numpy
    inputs of its width: (jcfg, cfg, numpy params, x [Bt, S, w], z or None,
    h0, the output's cotangent)."""
    jcfg, cfg = _cfgs(arch)
    p = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    if arch == "falcon-mamba-7b":
        din = cfg.ssm_expand * cfg.d_model
        x = rng.standard_normal((Bt, S, din)).astype(np.float32)
        z = rng.standard_normal((Bt, S, din)).astype(np.float32)
        h0 = rng.standard_normal((Bt, din, cfg.ssm_state)).astype(np.float32)
        cot = rng.standard_normal((Bt, S, din)).astype(np.float32)
        return jcfg, cfg, p, x, z, h0, cot
    w = cfg.lru_width or cfg.d_model
    x = rng.standard_normal((Bt, S, w)).astype(np.float32)
    h0 = rng.standard_normal((Bt, w)).astype(np.float32)
    cot = rng.standard_normal((Bt, S, w)).astype(np.float32)
    return jcfg, cfg, p, x, None, h0, cot


def _j_rglru_grads(p, x, h0, cot):
    out, vjp = jax.vjp(lambda pp, u, h: JS._rglru_scan(pp, u, h)[0],
                       jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                       jnp.asarray(h0))
    return out, vjp(jnp.asarray(cot))


def _port_grads(fn, p, xs, cot):
    """Autograd of ``fn(params, *xs)``'s first output against ``cot``:
    (output, {param: grad}, [grad of each x])."""
    tp = {k: v.requires_grad_(True)
          for k, v in params_from_numpy(p, device="cpu").items()}
    tx = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    out = fn(tp, *tx)[0]
    g = torch.autograd.grad(out, list(tp.values()) + tx,
                            torch.from_numpy(cot), allow_unused=True)
    gp = {k: (torch.zeros_like(v) if d is None else d)
          for (k, v), d in zip(tp.items(), g)}
    return out.detach(), gp, list(g[len(tp):])


def test_rglru_scan_autograd_matches_jax_vjp():
    """The old failure is gone: autograd through ``ops.linear_scan`` on the
    CPU (the plain ``linear_scan_ref``, once ``addcmul(..., out=)``, which
    autograd refused) gives ``jax.vjp`` of the reference's ``_rglru_scan``
    (its gates, decay and scan) for every leaf, the input and h0."""
    _, _, p, x, _, h0, cot = _mixer("recurrentgemma-2b", JS.rglru_init)
    want_out, (jp, jx, jh) = _j_rglru_grads(p, x, h0, cot)
    out, gp, (gx, gh) = _port_grads(PS._rglru_scan, p, (x, h0), cot)
    _close(out, want_out, JAX_REL, "hs")
    for k in p:
        _close(gp[k], jp[k], JAX_REL, k)
    _close(gx, jx, JAX_REL, "u")
    _close(gh, jh, JAX_REL, "h0")


def test_ssm_inner_autograd_matches_jax_vjp():
    """Autograd of the port's ``_ssm_inner`` on the CPU (the plain
    ``ssm_scan_ref``) against ``jax.vjp`` of the reference's: every leaf
    it reads, xc, z and h0."""
    jcfg, cfg, p, x, z, h0, cot = _mixer("falcon-mamba-7b", JS.ssm_init)
    out, vjp = jax.vjp(lambda pp, a, b, h: JS._ssm_inner(jcfg, pp, a, b, h)[0],
                       jax.tree.map(jnp.asarray, p), *map(jnp.asarray,
                                                          (x, z, h0)))
    jp, *jxs = vjp(jnp.asarray(cot))
    got, gp, gxs = _port_grads(lambda pp, a, b, h: PS._ssm_inner(
        cfg, pp, a, b, h), p, (x, z, h0), cot)
    _close(got, out, JAX_REL, "y")
    for k in p:
        _close(gp[k], jp[k], JAX_REL, k)
    for name, g, w in zip(("xc", "z", "h0"), gxs, jxs):
        _close(g, w, JAX_REL, name)


def test_linear_scan_ref_forward_is_the_addcmul_loop():
    """The differentiable ``linear_scan_ref`` gives bitwise what its
    ``out=`` form gave (every CPU serving test of the hybrid reads it)."""
    a, g, h0, _, _ = _linear_inputs(37, np.float32, seed=4, Bt=3, w=50)
    a, g, h0 = _t((a, g, h0))
    a_t, g_t = a.transpose(0, 1).contiguous(), g.transpose(0, 1).contiguous()
    hs_old = torch.empty_like(a_t)
    h = h0
    for t in range(a_t.shape[0]):
        torch.addcmul(g_t[t], a_t[t], h, out=hs_old[t])
        h = hs_old[t]
    hs, h_last = ref.linear_scan_ref(a, g, h0)
    assert torch.equal(hs, hs_old.transpose(0, 1))
    assert torch.equal(h_last, h)


# ------------------------------------------- (c) the autograd rules
class _PlainScans:
    """Stands in for the time-scan kernel wrappers: each call runs the
    plain version and is recorded (forward kernels under the autograd
    rules must run with grad disabled)."""

    name = "scans"

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        assert not torch.is_grad_enabled()
        kind = "linear" if len(args) == 3 else "selective"
        self.calls.append(kind)
        return (ref.linear_scan_ref if kind == "linear"
                else ref.selective_scan_ref)(*args)

    def fused(self, *args):
        self.calls.append("fused")
        return ref.ssm_scan_ref(*args)

    def backward(self, *args):
        kind = "linear_bwd" if len(args) == 5 else "selective_bwd"
        self.calls.append(kind)
        return (ref.linear_scan_bwd_ref if kind == "linear_bwd"
                else ref.selective_scan_bwd_ref)(*args)


@pytest.fixture
def plain_kernels(monkeypatch):
    fake = _PlainScans()
    for mod, name in ((time_scan, "linear_scan"),
                      (time_scan, "selective_scan"),
                      (ops, "_linear_scan"), (ops, "_selective_scan")):
        monkeypatch.setattr(mod, name, fake)
    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    return fake


def _grads_of(outs, ins, cots):
    return torch.autograd.grad(outs, [t for t in ins if t.requires_grad],
                               cots, allow_unused=True)


@pytest.mark.parametrize("S", S_CASES)
def test_linear_scan_fn_gives_the_plain_autograd(plain_kernels, S):
    a, g, h0, ghs, ghl = _linear_inputs(S, np.float32, seed=5)
    cots = [torch.from_numpy(ghs), torch.from_numpy(ghl)]
    for needs in ((True, True, True), (True, True, False)):
        ins = [t.requires_grad_(n) for t, n in zip(_t((a, g, h0)), needs)]
        outs = ops.linear_scan(*ins)
        assert type(outs[0].grad_fn).__name__ == "LinearScanFnBackward"
        assert plain_kernels.calls == ["linear"]
        got = _grads_of(outs, ins, cots)
        assert plain_kernels.calls == ["linear", "linear_bwd"]
        plain_kernels.calls.clear()
        want = _grads_of(ref.linear_scan_ref(*ins), ins, cots)
        for gg, w in zip(got, want):
            _close(gg, w, FN_REL, "linear_scan")
    # hs alone receives a gradient (h_last unused): one backward all the same
    ins = _t((a, g, h0), grad=True)
    hs, _ = ops.linear_scan(*ins)
    got = torch.autograd.grad(hs, ins, cots[0])
    want = torch.autograd.grad(ref.linear_scan_ref(*ins)[0], ins, cots[0])
    assert plain_kernels.calls == ["linear", "linear_bwd"]
    for gg, w in zip(got, want):
        _close(gg, w, FN_REL, "linear_scan, hs alone")


@pytest.mark.parametrize("S", S_CASES)
def test_selective_scan_fn_gives_the_plain_autograd(plain_kernels, S):
    dt, u, B, C, A, h0, gy, ghl = _selective_inputs(S, np.float32, seed=6)
    ins = _t((dt, u, B, C, A, h0), grad=True)
    cots = [torch.from_numpy(gy), torch.from_numpy(ghl)]
    outs = ops.selective_scan(*ins)
    assert type(outs[0].grad_fn).__name__ == "SelectiveScanFnBackward"
    got = torch.autograd.grad(outs, ins, cots)
    assert plain_kernels.calls == ["selective", "selective_bwd"]
    want = torch.autograd.grad(ref.selective_scan_ref(*ins), ins, cots)
    for name, gg, w in zip(("dt", "u", "B", "C", "A", "h0"), got, want):
        _close(gg, w, FN_REL, name)


def test_ssm_scan_under_autograd_is_the_plain_composition(plain_kernels):
    """``ops.ssm_scan`` recorded on the card: the plain version's torch ops
    around ``SelectiveScanFn`` (one scan launch, one backward launch); every
    input's gradient is autograd's of ``ssm_scan_ref``; B, C and z as
    column views, as ``_ssm_inner`` passes them; a mask raises by name."""
    rng = np.random.default_rng(7)
    Bt, S, din, N = 2, 11, 8, 4
    xs = {"dt_lin": (Bt, S, din), "dt_bias": (din,), "xc": (Bt, S, din),
          "dbc": (Bt, S, 2 * N + 3), "z": (Bt, S, din), "A_log": (din, N),
          "D": (din,), "h0": (Bt, din, N)}
    arrays = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in xs.items()}
    gy = torch.from_numpy(rng.standard_normal((Bt, S, din))
                          .astype(np.float32))

    def call(fn, ts):
        B_, C_ = ts["dbc"][..., 3:3 + N], ts["dbc"][..., 3 + N:]
        return fn(ts["dt_lin"], ts["dt_bias"], ts["xc"], B_, C_, ts["z"],
                  ts["A_log"], ts["D"], ts["h0"])

    ts = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in arrays.items()}
    y, h = call(ops.ssm_scan, ts)
    got = torch.autograd.grad(y, list(ts.values()), gy)
    assert plain_kernels.calls == ["selective", "selective_bwd"]
    want = torch.autograd.grad(call(ref.ssm_scan_ref, ts)[0],
                               list(ts.values()), gy)
    for name, gg, w in zip(ts, got, want):
        _close(gg, w, FN_REL, name)
    mask = torch.ones(Bt, S, dtype=torch.bool)
    with pytest.raises(RuntimeError, match="ssm_scan: a mask"):
        ops.ssm_scan(ts["dt_lin"], ts["dt_bias"], ts["xc"],
                     ts["dbc"][..., 3:3 + N], ts["dbc"][..., 3 + N:],
                     ts["z"], ts["A_log"], ts["D"], ts["h0"], mask)


def test_scans_under_no_grad_launch_the_serving_kernels(plain_kernels):
    """Under ``no_grad`` (serving) each entry launches exactly what it did
    before the autograd rules: the fused mixer core, the scan alone, the
    linear scan; no backward, no ``grad_fn``."""
    dt, u, B, C, A, h0, _, _ = _t(_selective_inputs(5, np.float32),
                                  grad=True)
    a, g, hl0, _, _ = _t(_linear_inputs(5, np.float32), grad=True)
    with torch.no_grad():
        outs = [ops.selective_scan(dt, u, B, C, A, h0),
                ops.ssm_scan(dt, A[:, 0], u, B, C, u, A, A[:, 0], h0),
                ops.linear_scan(a, g, hl0)]
    assert plain_kernels.calls == ["selective", "fused", "linear"]
    assert all(o.grad_fn is None for pair in outs for o in pair)


# -------------------------------------------------------------- (d) MoE
MOE = "qwen2-moe-a2.7b"
EMPTY_EXPERT = 2


def _moe_case(T=10, seed=0):
    """Reduced qwen2-moe's FFN (the reference's init) and tokens x [1, T,
    d] whose feature 0 is 4 while the router weighs it -100 for expert
    EMPTY_EXPERT: that expert's logit is ~ -400 for every token, so it
    receives none."""
    jcfg, cfg = _cfgs(MOE)
    p = jax.tree.map(np.asarray, JM.moe_init(jax.random.PRNGKey(seed), jcfg))
    p["router"] = p["router"].copy()
    p["router"][0, EMPTY_EXPERT] = -100.0
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, T, cfg.d_model)).astype(np.float32)
    x[..., 0] = 4.0
    cot = rng.standard_normal(x.shape).astype(np.float32)
    return jcfg, cfg, p, x, cot


def test_moe_grads_match_jax_and_an_empty_expert_gets_zero():
    jcfg, cfg, p, x, cot = _moe_case()
    ids, _ = M._route(cfg, params_from_numpy(p, device="cpu"),
                      torch.from_numpy(x[0]))
    assert EMPTY_EXPERT not in ids.tolist()
    out, vjp = jax.vjp(lambda pp, xx: JM.moe_apply(jcfg, pp, xx, None),
                       jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    jp, jx = vjp(jnp.asarray(cot))
    got, gp, (gx,) = _port_grads(lambda pp, xx: (M.moe_apply(cfg, pp, xx),),
                                 p, (x,), cot)
    _close(got, out, JAX_REL, "y")
    for k in p:
        _close(gp[k], jp[k], JAX_REL, k)
    _close(gx, jx, JAX_REL, "x")
    for k in ("we_gate", "we_up", "we_down"):
        assert torch.count_nonzero(gp[k][EMPTY_EXPERT]) == 0, k
        assert not np.asarray(jp[k][EMPTY_EXPERT]).any(), k
        assert all(torch.count_nonzero(gp[k][e]) > 0
                   for e in range(cfg.num_experts) if e != EMPTY_EXPERT), k


def test_moe_dispatch_gather_is_the_old_gather():
    """``dispatch_rows`` (through the sort's permutation) gives bitwise the
    old ``x2.index_select(0, order // k)``, for top-k 1, 2 and 4."""
    rng = np.random.default_rng(1)
    for T, k, E in ((7, 1, 3), (12, 2, 4), (9, 4, 8)):
        x2 = torch.from_numpy(rng.standard_normal((T, 16)).astype(np.float32))
        ids = torch.from_numpy(rng.integers(0, E, T * k))
        order = torch.argsort(ids, stable=True)
        assert torch.equal(M.dispatch_rows(x2, order, k),
                           x2.index_select(0, order // k))


def test_moe_backward_repeats_bitwise():
    """Two backward passes of the routed experts agree bit for bit."""
    _, cfg, p, x, cot = _moe_case(T=16, seed=2)
    runs = [_port_grads(lambda pp, xx: (M.moe_apply(cfg, pp, xx),), p, (x,),
                        cot) for _ in range(2)]
    for k in p:
        assert torch.equal(runs[0][1][k], runs[1][1][k]), k
    assert torch.equal(runs[0][2][0], runs[1][2][0])
