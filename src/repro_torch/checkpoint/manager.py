"""Checkpoint manager: keep-policy, resume, and failure-recovery loop — port
of ``repro/checkpoint/manager.py``.

- ``maybe_save`` every N steps + keep-last-K garbage collection;
- ``latest`` / ``resume`` for cold restart (returns step 0 and the given
  state when no checkpoint exists — one code path for fresh and resumed
  jobs);
- ``run_with_recovery`` drives a train loop and, on a step failure,
  restores the last checkpoint and continues.

The port's train steps update their state in place, so a step that fails
half way leaves a torn state behind: recovery always restores a
checkpoint, and a failure before the first one restarts from a state the
caller must not have handed to a step (``run_with_recovery`` refuses to
go on from a torn state: with no checkpoint to restore it re-raises).
"""

from __future__ import annotations

import logging
import os
import shutil
from typing import Any, Callable, Optional, Tuple

import torch.distributed as dist

from .checkpointer import Checkpointer

log = logging.getLogger(__name__)


class CheckpointManager:
    def __init__(self, directory: str, save_every: int = 100, keep: int = 3,
                 async_save: bool = True):
        self.ckpt = Checkpointer(directory, async_save=async_save)
        self.save_every = save_every
        self.keep = keep

    def maybe_save(self, step: int, state: Any, specs=None, mesh=None) -> bool:
        """Save ``state`` at every ``save_every``-th step; ``state`` may be
        a callable that builds it, called only on those steps.  With
        ``mesh``, ``state`` is this rank's pieces and ``specs`` their tree
        of ``Sharding``: every rank calls this, and the save is sharded
        (``Checkpointer.save_pieces``) and synchronous."""
        if step % self.save_every != 0:
            return False
        state = state() if callable(state) else state
        if mesh is not None:
            self.ckpt.save_pieces(step, state, specs)
            if dist.get_rank() == 0:
                self._gc()
            return True
        self.ckpt.save(step, state, specs)
        self._gc()
        return True

    def _gc(self) -> None:
        steps = self.ckpt.available_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.ckpt.dir, f"step_{s}"), ignore_errors=True)

    def latest(self) -> Optional[int]:
        steps = self.ckpt.available_steps()
        return steps[-1] if steps else None

    def resume(self, like: Any, device=None, mesh=None) -> Tuple[int, Any]:
        """(start_step, state): ``like`` itself when starting cold, else the
        latest checkpoint in ``like``'s structure on ``device`` (default:
        the card); with ``mesh``, this rank's pieces of it re-placed on
        ``mesh`` (``Checkpointer.restore(mesh=)``), ``like`` at the leaves'
        whole shapes."""
        last = self.latest()
        if last is None:
            return 0, like
        self.ckpt.wait()
        return last, self.ckpt.restore(last, device, like=like, mesh=mesh)

    def run_with_recovery(self, step_fn: Callable[[int, Any], Any], state: Any,
                          n_steps: int, specs=None, device=None, mesh=None,
                          max_restarts: int = 3) -> Any:
        """Drive a training loop; on an exception, restore the last
        checkpoint and go on (node-failure recovery).
        ``step_fn(step, state) -> state``.  With ``mesh``, ``state`` is this
        rank's pieces and ``specs`` their shardings (saves are sharded, a
        restore re-places them on ``mesh``); a step that fails on one rank
        must fail on every rank, as a collective's failure does."""
        like = state
        if mesh is not None:
            import torch

            from ..tree import tree_map

            like = tree_map(lambda x, sh: torch.empty(
                sh.whole_shape(x.shape), dtype=x.dtype,
                device="meta").requires_grad_(x.requires_grad), state, specs)
        start, restored = self.resume(like, device, mesh)
        state = state if start == 0 else restored
        restarts = 0
        step = start
        while step < n_steps:
            try:
                state = step_fn(step, state)
                step += 1
                self.maybe_save(step, state, specs, mesh)
            except Exception as e:  # noqa: BLE001 — any step failure
                restarts += 1
                if restarts > max_restarts or self.latest() is None:
                    raise
                log.warning("step %d failed (%s); restoring last checkpoint", step, e)
                self.ckpt.wait()
                step, state = self.resume(like, device, mesh)
        self.ckpt.wait()
        return state
