"""End-to-end training entry point with fault tolerance, the port's
counterpart of the JAX package's ``launch/train.py`` (its flags, defaults
and logged lines).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --steps 8 --batch 8 --seq 512 --save-every 8 --ckpt-dir DIR
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --reduced --device cpu --steps 20 --fail-at-step 7 --save-every 5
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch falcon-mamba-7b --layers 32 --steps 4 --batch 8 --seq 512

Every ported family trains: the dense and sliding-window decoders, the
MoE decoder (qwen2-moe-a2.7b), the RG-LRU hybrid (recurrentgemma-2b), the
Mamba-1 stack (falcon-mamba-7b), the vision-prefixed decoder and the
audio encoder.  ``--layers`` cuts the depth (f32 master weights, their
gradient and two AdamW moments take 16 bytes a parameter: on one 80 GB
card qwen2-moe runs 4 of its 24 layers, falcon-mamba 32 of its 64).

It trains on the card (``--device cuda``, the default; raises on a host
without one); ``--device cpu`` runs the plain reference path.  f32
master weights from ``T.init_params(cfg, 0)``, activations in the
config's dtype, AdamW, ``SyntheticLM`` batches, a checkpoint every
``--save-every`` steps and at the end (the reference's format), and the
``Supervisor``: ``--fail-at-step N`` injects one ``PreemptionError``
before step N, after which the run restores the latest checkpoint and
goes on.  ``--resume`` starts from the latest checkpoint in
``--ckpt-dir``.  One device only: ``--mesh`` takes ``local``; the
production meshes wait for ROADMAP A13.

``main(argv)`` takes the argument list (``sys.argv[1:]`` when None) and
returns the loss of every step it ran, in order (a step re-run after a
restore appears again).  Each step is also logged at DEBUG level on the
``repro_torch.train`` logger with its seconds (to the loss's read-back),
and each save on ``repro_torch.checkpoint`` with its bytes and seconds.
"""
from __future__ import annotations

import argparse
import logging
import os
import tempfile
import time
from typing import Any, List, Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_config, get_reduced
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamWConfig, init_opt_state, tree_map
from repro_torch.runtime.fault import PreemptionError, Supervisor
from repro_torch.runtime.train_loop import make_train_step

log = logging.getLogger("repro_torch.train")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the trainer runs: the card (default; raises "
                         "without one) or 'cpu' for the plain reference "
                         "path")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", choices=["local", "single", "multi"],
                    default="local",
                    help="only 'local' (one device); the production meshes "
                         "wait for ROADMAP A13")
    ap.add_argument("--d-model", type=int, default=0,
                    help="override reduced width (e.g. ~100M model)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--fail-at-step", type=int, default=-1,
                    help="inject a failure once (tests checkpoint-restart)")
    return ap


def _meta(tree: Any) -> Any:
    """The same tree of ``meta`` tensors: a restore template that holds no
    memory."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    args = _parser().parse_args(argv)
    if args.mesh != "local":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the production meshes are not ported yet "
            "(ROADMAP A13: parallelism); the port trains on one device "
            "(--mesh local)")
    dev = resolve_device(args.device)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.d_model:
        cfg = cfg.replace(d_model=args.d_model,
                          head_dim=args.d_model // cfg.num_heads)
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)

    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    data = SyntheticLM(cfg, shape)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps)
    step_fn = make_train_step(cfg, opt_cfg,
                              num_microbatches=args.microbatches)

    params = T.unstack_layers(T.init_params(cfg, 0, device=dev))
    opt_state = init_opt_state(params, opt_cfg)

    ckpt = Checkpointer(args.ckpt_dir)
    sup = Supervisor(checkpointer=ckpt, save_every=args.save_every)

    start = 0
    if args.resume and ckpt.latest_step() is not None:
        trees, extra = ckpt.restore(ckpt.latest_step(),
                                    {"params": _meta(params),
                                     "opt": _meta(opt_state)}, device=dev)
        params, opt_state = trees["params"], trees["opt"]
        data.restore(extra["data"])
        start = int(ckpt.latest_step())
        log.info("resumed from step %d", start)

    state = {"step": start,
             "trees": {"params": params, "opt": opt_state},
             "extra": {"data": data.state()}}
    del params, opt_state
    injected = {"done": False}

    def fail_hook(step):
        if args.fail_at_step >= 0 and step == args.fail_at_step \
                and not injected["done"]:
            injected["done"] = True
            raise PreemptionError(f"injected failure at step {step}")

    losses: List[float] = []

    def do_step(step, st):
        batch = data.next_batch(dev)
        p, o = st["trees"]["params"], st["trees"]["opt"]
        t0 = time.perf_counter()
        p, o, m = step_fn(p, o, batch)
        loss = float(m["loss"])
        dt = time.perf_counter() - t0
        losses.append(loss)
        if step % 10 == 0:
            log.info("step %5d loss %.4f gnorm %.3f lr %.2e (%.3fs)",
                     step, loss, float(m["grad_norm"]), float(m["lr"]), dt)
        log.debug("step %d loss %.6f seconds %.6f", step, loss, dt)
        st["trees"] = {"params": p, "opt": o}
        st["extra"] = {"data": data.state()}
        return st

    def restore_fn(last_step):
        tmpl = _meta(state["trees"])
        state["trees"] = None          # free the failed run's tensors first
        trees, extra = ckpt.restore(last_step, tmpl, device=dev)
        data.restore(extra["data"])
        state.update(step=last_step, trees=trees,
                     extra={"data": data.state()})
        return state

    sup.run(total_steps=args.steps, state=state, step_fn=do_step,
            restore_fn=restore_fn, fail_hook=fail_hook)
    if losses:
        log.info("done. first loss %.4f -> last loss %.4f (restarts: %d)",
                 losses[0], losses[-1], sup.restarts)
    return losses


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
