"""The port's GPTQ (``repro_torch.core.gptq``) against the JAX package's
numpy reference on the CPU, on the same numpy inputs: OBQ codes, scales,
zeros and ``g_idx`` bitwise equal (act_order on and off, symmetric, a dead
input, ``in`` not a multiple of the block, group sizes 32 and 128), the
identity-Hessian closed form equal to the reference's loop, one loop over
weights concatenated by their shared Hessian equal to one loop each, the
streamed Hessian and the proxy loss within 1e-12, the int4 pack equal to
the reference's, and GPTQ below RTN under the Hessian loss."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.base import QuantConfig as JQuantConfig
from repro.core import gptq as jg
from repro.core.quant import make_quant_params as j_make_quant_params
from repro_torch.configs.base import QuantConfig
from repro_torch.core import gptq as g
from repro_torch.core.quant import make_quant_params


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

REL = 1e-12


def _problem(rng, din=64, dout=32, n=512, dead=()):
    x = rng.normal(size=(n, din)) * (1 + 3 * rng.random(din))
    x[:, list(dead)] = 0.0
    w = rng.normal(size=(din, dout))
    return x, w, 2 * x.T @ x / n


def _assert_same_artifact(got: g.QuantizedTensor, want: jg.QuantizedTensor):
    np.testing.assert_array_equal(got.q.numpy(), want.q)
    assert got.q.dtype == torch.uint8
    np.testing.assert_array_equal(got.scales.numpy(), want.scales)
    np.testing.assert_array_equal(got.zeros.numpy(), want.zeros)
    np.testing.assert_array_equal(got.g_idx.numpy(), want.g_idx)
    assert got.scales.dtype == got.zeros.dtype == torch.float32
    assert got.g_idx.dtype == torch.int32 and got.bits == want.bits


# (din, dout, QuantConfig fields, dead inputs)
OBQ_CASES = {
    "act_order": (64, 32, dict(group_size=32), ()),
    "no_act_order": (64, 32, dict(group_size=32, act_order=False), ()),
    "sym": (64, 32, dict(group_size=32, sym=True), ()),
    "dead_input": (96, 24, dict(group_size=32), (5, 40)),
    "din_not_multiple_of_block": (200, 16, dict(group_size=32), ()),
    "small_blocks_ragged_group": (100, 16, dict(group_size=32,
                                                block_size=24), (7,)),
    "gs128": (256, 16, dict(group_size=128), ()),
    "gs128_sym_no_act_order": (300, 12, dict(group_size=128, sym=True,
                                             act_order=False), (0,)),
}


@pytest.mark.parametrize("case", list(OBQ_CASES))
def test_gptq_quantize_bitwise_vs_reference(rng, case):
    din, dout, kw, dead = OBQ_CASES[case]
    _, w, h = _problem(rng, din, dout, dead=dead)
    want = jg.gptq_quantize(w, h, JQuantConfig(**kw))
    got = g.gptq_quantize(w, h, QuantConfig(**kw))
    _assert_same_artifact(got, want)
    # torch inputs on the CPU take the same path
    again = g.gptq_quantize(torch.from_numpy(w), torch.from_numpy(h),
                            QuantConfig(**kw))
    assert torch.equal(again.q, got.q)


@pytest.mark.parametrize("kw", [dict(group_size=32),
                                dict(group_size=32, act_order=False),
                                dict(group_size=128, sym=True)],
                         ids=["act_order", "no_act_order", "gs128_sym"])
def test_identity_hessian_closed_form_equals_reference_loop(rng, kw):
    """hessian=None: the port's closed form against the reference's column
    loop (whose feedback terms are exact zeros), and RTN alike."""
    w = rng.normal(size=(200, 24))
    _assert_same_artifact(g.gptq_quantize(w, None, QuantConfig(**kw)),
                          jg.gptq_quantize(w, None, JQuantConfig(**kw)))
    _assert_same_artifact(g.rtn_quantize(w, QuantConfig(**kw)),
                          jg.rtn_quantize(w, JQuantConfig(**kw)))


@pytest.mark.parametrize("hessian", [True, False], ids=["H", "identity"])
def test_shared_hessian_concatenation_equals_per_weight(rng, hessian):
    """Weights that share an input (wq/wk/wv, w_gate/w_up) may run through
    one loop concatenated along the output axis."""
    _, w, h = _problem(rng, 96, 40, dead=(3,))
    h = h if hessian else None
    cfg = QuantConfig(group_size=32, block_size=40)
    parts = (w[:, :24], w[:, 24:32], w[:, 32:])
    whole = g.gptq_quantize(np.concatenate(parts, 1), h, cfg)
    c0 = 0
    for p in parts:
        one = g.gptq_quantize(p, h, cfg)
        c1 = c0 + p.shape[1]
        assert torch.equal(whole.q[:, c0:c1], one.q)
        assert torch.equal(whole.scales[:, c0:c1], one.scales)
        assert torch.equal(whole.zeros[:, c0:c1], one.zeros)
        c0 = c1


def test_hessian_accumulator_streams_like_reference(rng):
    x = rng.normal(size=(3, 40, 16)).astype(np.float32)
    want = jg.HessianAccumulator(16)
    got = g.HessianAccumulator(16, device="cpu")
    once = g.HessianAccumulator(16, device="cpu")
    for b in x:
        want.update(b)
        got.update(torch.from_numpy(b))
    once.update(x.reshape(-1, 16))
    scale = np.abs(want.h).max()
    assert np.abs(got.h.numpy() - want.h).max() <= REL * scale
    assert np.abs(once.h.numpy() - want.h).max() <= REL * scale
    assert got.n == want.n == 120 and got.h.dtype == torch.float64


@pytest.mark.parametrize("hessian", [True, False], ids=["H", "mse"])
def test_quant_error_matches_reference(rng, hessian):
    _, w, h = _problem(rng)
    cfg = dict(group_size=32)
    want_qt = jg.gptq_quantize(w, h, JQuantConfig(**cfg))
    got_qt = g.gptq_quantize(w, h, QuantConfig(**cfg))
    hh = h if hessian else None
    want = jg.quant_error(w, want_qt, hh)
    got = g.quant_error(w, got_qt, hh)
    assert abs(got - want) <= REL * abs(want)
    np.testing.assert_array_equal(got_qt.dequant().numpy(),
                                  want_qt.dequant())


def test_make_quant_params_packs_like_reference(rng):
    _, w, h = _problem(rng, 64, 24)
    cfg = dict(group_size=32)
    want = j_make_quant_params(jg.gptq_quantize(w, h, JQuantConfig(**cfg)))
    got = make_quant_params(g.gptq_quantize(w, h, QuantConfig(**cfg)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
        assert got[k].numpy().dtype == np.asarray(want[k]).dtype, k


def test_make_quant_params_refuses_ragged_groups(rng):
    """The int4 matmul kernel reads group k // group_size: a short last
    group (in % group_size != 0) cannot be served."""
    _, w, h = _problem(rng, 48, 8)
    qt = g.gptq_quantize(w, h, QuantConfig(group_size=32))
    with pytest.raises(ValueError, match="contiguous whole groups"):
        make_quant_params(qt)


def test_gptq_beats_rtn_under_hessian_loss(rng):
    _, w, h = _problem(rng)
    cfg = QuantConfig(bits=4, group_size=32)
    e_gptq = g.quant_error(w, g.gptq_quantize(w, h, cfg), h)
    e_rtn = g.quant_error(w, g.rtn_quantize(w, cfg), h)
    assert e_gptq < e_rtn
    # and the error-feedback loop really ran: the codes differ from RTN's
    off = dataclasses.replace(cfg, act_order=False)
    assert not torch.equal(g.gptq_quantize(w, h, off).q,
                           g.rtn_quantize(w, cfg).q)
