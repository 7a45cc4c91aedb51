"""The port's checkpoint reader (``repro_torch.checkpoint.reader``) on
checkpoints that the JAX package's ``Checkpointer`` writes into a tmp
dir: every leaf bitwise equal to what was saved (f32 trees of reduced
qwen2-1.5b and reduced qwen2-moe, and a bf16-cast tree, which numpy
stores as ``|V2`` words), ``LLM.load(checkpoint=...)`` draining greedy
token-exact against the JAX ``LLM`` on the same directory (the
quantization after the restore included), the latest step chosen, and a
missing step, leaf or shape refused.  Reduced configs, f32 activations.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer
from repro.configs.registry import get_reduced as j_get_reduced
from repro.models import transformer as JT
from repro.serving import LLM as JLLM
from repro.serving import SamplingParams as JSP
from repro_torch.checkpoint import reader
from repro_torch.configs.registry import get_reduced
from repro_torch.models import transformer as T
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

OVR = {"dtype": "float32"}
ENGINE_KW = dict(max_slots=3, num_blocks=48, max_blocks_per_seq=8,
                 max_num_batched_tokens=24, enable_async_step=False)
CASES = {"qwen2-1.5b": ("qwen2-1.5b", None),
         "qwen2-moe": ("qwen2-moe-a2.7b", None),
         "qwen2-1.5b-bf16": ("qwen2-1.5b", jnp.bfloat16)}


def _write(path, arch, cast=None, step=3, seed=0):
    params = JT.init_params(j_get_reduced(arch, **OVR),
                            jax.random.PRNGKey(seed))
    if cast is not None:
        params = jax.tree.map(lambda x: x.astype(cast), params)
    Checkpointer(str(path)).save(step, {"params": params},
                                 extra={"note": arch})
    return params


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    out = {}
    for name, (arch, cast) in CASES.items():
        d = tmp_path_factory.mktemp(name)
        out[name] = (str(d), arch, _write(d, arch, cast))
    return out


def _template(arch):
    return T.init_params(get_reduced(arch, **OVR), device="meta")


@pytest.mark.parametrize("name", list(CASES))
def test_leaves_bitwise_equal(ckpts, name):
    d, arch, params = ckpts[name]
    step = reader.latest_step(d)
    assert step == 3
    trees, extra = reader.restore(d, step, {"params": _template(arch)},
                                  device="cpu")
    assert extra == {"note": arch}
    want = jax.tree_util.tree_leaves_with_path(params)
    got = dict((jax.tree_util.keystr(k), v) for k, v in
                jax.tree_util.tree_leaves_with_path(trees["params"]))
    assert len(got) == len(want)
    for k, w in want:
        t = got[jax.tree_util.keystr(k)]
        w = np.asarray(w)
        if w.dtype == jnp.bfloat16:
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          w.view(np.int16))
        else:
            assert t.numpy().dtype == w.dtype
            np.testing.assert_array_equal(t.numpy(), w)
    if name.endswith("bf16"):
        # numpy alone reads the leaves as 2-byte void words
        f = os.path.join(d, "step_00000003", "params.embed.npy")
        assert np.load(f).dtype.str == "|V2"


@pytest.mark.parametrize("slice_bytes", [None, 700],
                         ids=["whole-leaves", "sliced"])
def test_restore_casts_as_it_loads(ckpts, monkeypatch, slice_bytes):
    """``dtype`` casts every weight but the norms, as ``cast_params``;
    leaves copied in slices of a few rows (700 bytes: one row of a layer
    stack, several rows of the embedding) come out the same."""
    d, arch, saved = ckpts["qwen2-moe"]
    if slice_bytes is not None:
        monkeypatch.setattr(reader, "_SLICE_BYTES", slice_bytes)
    tmpl = _template(arch)
    plain = reader.restore_params(d, tmpl, device="cpu")
    np.testing.assert_array_equal(plain["embed"].numpy(),
                                  np.asarray(saved["embed"]))
    np.testing.assert_array_equal(
        plain["layers"]["moe"]["we_down"].numpy(),
        np.asarray(saved["layers"]["moe"]["we_down"]))
    cast = reader.restore_params(d, tmpl, device="cpu",
                                 dtype=torch.bfloat16)
    for a, b in zip(T._leaves(cast),
                    T._leaves(T.cast_params(plain, torch.bfloat16))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert cast["final_norm"]["w"].dtype == torch.float32


@pytest.mark.parametrize("name,quant", [("qwen2-1.5b", "rtn-int4"),
                                        ("qwen2-moe", None),
                                        ("qwen2-1.5b-bf16", None)])
def test_llm_load_checkpoint_drains_token_exact_vs_jax(ckpts, name, quant):
    """The bf16 tree is compared with a JAX ``LLM`` built on the saved
    params: the reference's own restore cannot read its bf16 leaves back
    (``jnp.asarray`` refuses numpy's ``|V2``; ROADMAP C10)."""
    d, arch, saved = ckpts[name]
    rng = np.random.default_rng(4)
    prompts = [list(rng.integers(1, 250, n)) for n in (30, 12, 45)]
    mts = (8, 5, 10)
    kw = dict(quant=quant, checkpoint=d, reduced=True, overrides=OVR,
              **ENGINE_KW)
    jllm = (JLLM(j_get_reduced(arch, **OVR), saved, **ENGINE_KW)
            if name.endswith("bf16") else JLLM.load(arch, **kw))
    want = jllm.generate(prompts, [JSP(max_tokens=m) for m in mts])
    llm = LLM.load(arch, device="cpu", **kw)
    got = llm.generate(prompts, [SamplingParams(max_tokens=m) for m in mts])
    assert [o.token_ids for o in got] == [o.token_ids for o in want]
    assert set(llm.load_s) == {"restore"}
    # a seeded load is another model: the checkpoint was really read
    seeded = LLM.load(arch, device="cpu", seed=1,
                      **{k: v for k, v in kw.items() if k != "checkpoint"})
    other = seeded.generate(prompts, [SamplingParams(max_tokens=m)
                                      for m in mts])
    assert [o.token_ids for o in other] != [o.token_ids for o in got]


def test_latest_step_is_restored(tmp_path):
    _write(tmp_path, "qwen2-1.5b", step=1, seed=0)
    newer = _write(tmp_path, "qwen2-1.5b", step=12, seed=5)
    assert reader.all_steps(str(tmp_path)) == [1, 12]
    got = reader.restore_params(str(tmp_path), _template("qwen2-1.5b"),
                                device="cpu")
    np.testing.assert_array_equal(got["embed"].numpy(),
                                  np.asarray(newer["embed"]))


def test_missing_step_leaf_or_shape_raises(tmp_path, ckpts):
    with pytest.raises(FileNotFoundError, match="no step_"):
        LLM.load("qwen2-1.5b", reduced=True, device="cpu",
                 checkpoint=str(tmp_path / "absent"))
    assert not (tmp_path / "absent").exists()   # a reader creates nothing
    with pytest.raises(FileNotFoundError, match="no step_"):
        reader.restore_params(str(tmp_path), _template("qwen2-1.5b"),
                              device="cpu")
    d = tmp_path / "ckpt"
    _write(d, "qwen2-1.5b")
    # a config of other widths does not fit the leaves
    wide = T.init_params(get_reduced("qwen2-1.5b", d_ff=256), device="meta")
    with pytest.raises(ValueError, match="shape"):
        reader.restore_params(str(d), wide, device="cpu")
    # a config of another family asks for leaves the checkpoint lacks
    with pytest.raises(FileNotFoundError, match="has no leaf"):
        reader.restore_params(str(d), _template("qwen2-moe-a2.7b"),
                              device="cpu")
    os.remove(d / "step_00000003" / "params.layers.attn.wq.npy")
    with pytest.raises(FileNotFoundError, match="layers.attn.wq"):
        reader.restore_params(str(d), _template("qwen2-1.5b"),
                              device="cpu")
