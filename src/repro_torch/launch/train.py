"""The trainer — port of ``repro/launch/train.py`` on one device:
model init -> data pipeline (``ShardedBatcher`` + ``Prefetcher``) -> train
step (loss, its gradient, AdamW in place) -> ``CheckpointManager`` (async,
atomic, keep-K, resume) -> ``StragglerWatchdog``.

CLI (the card unless ``--device cpu``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch ce-tiny --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --arch ce-tiny --device cpu \\
        --steps 20 --save-every 10 --ckpt-dir DIR

A second run with the same ``--ckpt-dir`` and more ``--steps`` resumes at
the last checkpoint; on the card the resumed run ends with the bits of an
uninterrupted one (every op of the step is deterministic there).  The
default checkpoint directory lies under the temporary directory.

A checkpoint holds the state in the reference's layout (the layers
stacked, under its leaf paths: ``params/layers/attn/wq``,
``opt/.mu/layers/...``), so either package's trainer resumes the other's
(:func:`checkpoint_tree`, :func:`state_from_checkpoint`).
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile
import time

import numpy as np
import torch

from .. import convert
from ..checkpoint import CheckpointManager
from ..configs import registry
from ..data.loader import Prefetcher, ShardedBatcher
from ..device import resolve_device
from ..distributed.fault_tolerance import StragglerWatchdog
from ..models import transformer
from ..training import optimizer
from . import steps

log = logging.getLogger("repro_torch.train")


def make_lm_train_step(cfg, opt_cfg):
    """``step(params, opt_state, batch)``: the mean next-token NLL of
    ``batch["tokens"]`` (B, L) over positions 1..L-1, its gradient and one
    AdamW update in place; returns (params, opt_state, {"loss",
    "grad_norm", "lr"})."""
    def loss_fn(params, batch):
        h, _ = transformer.encode(params, batch["tokens"], cfg)
        logits = transformer.lm_logits(params, h[:, :-1], cfg)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, batch["tokens"][:, 1:, None].long())
        return nll.mean()

    return steps.train_step(loss_fn, opt_cfg)


def checkpoint_tree(state: dict) -> dict:
    """The LM training state {"params", "opt"} in the reference's layout:
    the params' and both moments' ``layers`` stacked on a leading axis."""
    opt = state["opt"]
    return {"params": convert.stack_layers(state["params"]),
            "opt": opt._replace(mu=convert.stack_layers(opt.mu),
                                nu=convert.stack_layers(opt.nu))}


def state_from_checkpoint(tree: dict) -> dict:
    """:func:`checkpoint_tree`'s inverse, the params requiring grad."""
    opt = tree["opt"]
    return {"params": steps.require_grad(convert.unstack_layers(tree["params"])),
            "opt": opt._replace(mu=convert.unstack_layers(opt.mu),
                                nu=convert.unstack_layers(opt.nu))}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="ce-tiny")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_ckpt"))
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    if args.arch != "ce-tiny":
        raise SystemExit("train.py drives the ce-tiny LM; see steps.py for DLRM")
    dev = resolve_device(args.device)
    cfg = registry.CE_TINY
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = steps.require_grad(transformer.init_lm(cfg, gen))
    opt_cfg = optimizer.AdamWConfig(lr=3e-4, total_steps=args.steps)
    opt_state = optimizer.init_adamw(params)
    step_fn = make_lm_train_step(cfg, opt_cfg)

    # synthetic token stream via the deterministic sharded batcher
    n_docs = 4096
    rng = np.random.default_rng(0)
    docs = rng.integers(4, cfg.vocab_size, size=(n_docs, args.seq)).astype(np.int32)
    batcher = ShardedBatcher(n_docs, args.batch, seed=0)

    mgr = CheckpointManager(args.ckpt_dir, save_every=args.save_every, keep=2)
    watchdog = StragglerWatchdog(
        on_straggler=lambda st: log.warning("straggler: step %d %.2fs", st.step, st.seconds)
    )
    start, tree = mgr.resume(checkpoint_tree({"params": params, "opt": opt_state}), dev)
    if start:
        state = state_from_checkpoint(tree)
        params, opt_state = state["params"], state["opt"]
    if start:
        log.info("resumed from checkpoint at step %d", start)
    prefetch = Prefetcher(
        lambda s: {"tokens": torch.from_numpy(docs[batcher.batch_indices(s)])}, depth=2,
        start_step=start)

    t_start = time.time()
    try:
        for step, batch in prefetch:
            if step >= args.steps:
                break
            t0 = time.monotonic()
            batch = {k: v.to(dev) for k, v in batch.items()}
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])         # waits for the step
            watchdog.observe(step, time.monotonic() - t0)
            mgr.maybe_save(step + 1,
                           lambda: checkpoint_tree({"params": params, "opt": opt_state}))
            if step % 10 == 0 or step == args.steps - 1:
                log.info("step %d loss %.4f gnorm %.3f lr %.2e", step, loss,
                         float(metrics["grad_norm"]), float(metrics["lr"]))
    finally:
        prefetch.close()
        mgr.ckpt.wait()
    log.info("done: %d steps in %.1fs", max(0, args.steps - start), time.time() - t_start)


if __name__ == "__main__":
    main()
