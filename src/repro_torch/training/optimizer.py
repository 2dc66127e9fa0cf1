"""AdamW, its cosine schedule and the gradient utilities — port of
``repro/training/optimizer.py``.

Parameters, gradients and moments are trees of tensors (``repro_torch.tree``:
dicts, lists and ``AdamWState``).  ``adamw_update`` follows the reference's
order of operations leaf by leaf (clip, then the moments, the bias
corrections, the decoupled decay and the step) in fp32, and applies it in
place under ``torch.no_grad()``: the parameters, ``mu`` and ``nu`` are
overwritten, where the reference returns new arrays (at DLRM's 2^22-row
tables one copy of the state is 12.8 GB).  ``torch.optim.AdamW`` is not
used: it orders the decay and epsilon differently, so its bits differ.
``step`` is a 0-d int32 tensor on the parameters' device, as the
reference's is a 0-d int32 array.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..tree import leaves, tree_map, unflatten_like


class AdamWState(NamedTuple):
    step: torch.Tensor        # 0-d int32
    mu: Any
    nu: Any


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``cfg.lr``, then a cosine down to ``min_lr_frac`` of
    it at ``total_steps``; fp32, on the step's device."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def init_adamw(params) -> AdamWState:
    """Step 0 and fp32 zero moments shaped like ``params``."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    dev = leaves(params)[0].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      tree_map(zeros, params), tree_map(zeros, params))


def global_norm(tree, shardings=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's fp32 sum of squares, in flattening
    order.  With ``shardings`` (a tree of ``distributed.sharding.Sharding``
    shaped like ``tree``, whose leaves are this rank's pieces), summed over
    the mesh with each piece counted once, however many ranks hold it
    (``distributed.fsdp.norm_sq``)."""
    if shardings is not None:
        from ..distributed.fsdp import norm_sq

        return torch.sqrt(norm_sq(tree, shardings))
    total = None
    for x in leaves(tree):
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, shardings=None):
    """Scale every leaf in place by ``min(1, max_norm / (norm + 1e-9))``;
    returns (grads, norm).  ``shardings``: as :func:`global_norm`."""
    norm = global_norm(grads, shardings)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for g in leaves(grads):
        g.mul_(scale)
    return grads, norm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state: AdamWState,
                 grad_transform: Optional[Callable] = None, shardings=None):
    """One AdamW step, in place: ``params``, ``state.mu`` and ``state.nu``
    are overwritten (and ``grads`` scaled by the clip).  Returns ``(params,
    AdamWState(step + 1, mu, nu), {"grad_norm", "lr"})``.
    ``grad_transform`` hooks a gradient compression (applied first).  Over a
    mesh, ``params``, ``grads`` and the moments are this rank's pieces and
    ``shardings`` their leaves' shardings: the update is elementwise, and
    the clip's norm counts every piece once (:func:`global_norm`)."""
    if grad_transform is not None:
        grads = grad_transform(grads)
    grads = tree_map(lambda g: g if g.dtype == torch.float32 else g.float(), grads)
    if cfg.clip_norm > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, shardings)
    else:
        gnorm = global_norm(grads, shardings)
    step = state.step + 1
    lr = cosine_schedule(cfg, step)
    stepf = step.float()
    b1c = 1 - torch.pow(cfg.b1, stepf)
    b2c = 1 - torch.pow(cfg.b2, stepf)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.mu), leaves(state.nu)):
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_((g * (1 - cfg.b2)).mul_(g))
        upd = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
        pf = p if p.dtype == torch.float32 else p.float()
        if cfg.weight_decay:      # the reference adds 0 * p at weight_decay 0
            upd.add_(pf * cfg.weight_decay)
        upd.mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(upd)
        else:
            p.copy_(pf - upd)
    return params, AdamWState(step.to(torch.int32), state.mu, state.nu), \
        {"grad_norm": gnorm, "lr": lr}


def accumulate_grads(loss_fn: Callable, params, microbatches, n_micro: int):
    """Mean gradient and loss over ``n_micro`` microbatches stacked on the
    leading axis of every leaf of ``microbatches``; the fp32 sums run in
    microbatch order from zero, as the reference's ``lax.scan`` does.
    ``loss_fn(params, mb)`` returns a scalar; the params' leaves must
    require grad."""
    ps = leaves(params)
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in ps]
    acc_l = torch.zeros((), dtype=torch.float32, device=ps[0].device)
    for i in range(n_micro):
        mb = tree_map(lambda x: x[i], microbatches)
        loss = loss_fn(params, mb)
        gs = torch.autograd.grad(loss, ps, allow_unused=True)
        with torch.no_grad():
            for a, g in zip(acc, gs):
                if g is not None:         # a leaf the loss does not read adds 0
                    a.add_(g.float())
            acc_l = acc_l + loss.detach()
    scale = 1.0 / n_micro
    with torch.no_grad():
        grads = [a.mul_(scale) for a in acc]
    return unflatten_like(params, grads), acc_l * scale
