"""Training over a mesh: sharded parameters and AdamW state, and the
differentiable collectives the sharded train steps are written in.

Storage follows ``tree_specs`` (``distributed/sharding.py``): each rank
keeps its piece of every parameter leaf and of both AdamW moments
(:func:`shard_tree`, or a family init's ``place`` hook, which keeps only
the piece of each leaf it draws), ZeRO style.  A dense leaf is
all-gathered where a step uses it (:func:`gather`), and the adjoint of that
gather reduce-scatters its gradient back into the piece; after the
backward, :func:`sync_grads` sums each piece's gradient over the mesh
dimensions the leaf is replicated on.  The AdamW update is elementwise, so
it runs on the pieces as it runs on whole leaves; the clip's global norm
counts each piece once (``optimizer.global_norm(shardings=)``), so a
replicated leaf is not counted once per rank.

The reference leaves the compute layout of its sharded steps to GSPMD; this
gather-on-use reading of its storage specs is the port's.  Two layouts
compute on shards instead, as the reference's own code lays them out:
NequIP's receiver-partitioned, channel-parallel interaction block
(``models/gnn/nequip.py::make_sharded_interact``) and DLRM's row-sharded
tables (``launch/steps.py``).

The collectives: every rank of a mesh runs the same step, so the loss a
rank backpropagates is its share of the whole step's loss (its local loss
over the world size, :func:`world_size`), and each collective's adjoint is
exact — ``all_gather`` and ``reduce_scatter`` (a sum) are each other's,
``all_reduce`` (a sum) its own — so the pieces' summed gradients are the
one-device step's.  ``reduce_scatter`` is an ``all_to_all_single`` and a
local sum in rank order (gloo on CUDA tensors has no reduce-scatter), so
two runs give the same bits.  Each counts its call and the bytes this
rank hands it in ``collectives.collective_calls`` / ``collective_bytes``;
the all-gather is ``collectives._all_gather``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from ..tree import leaves, tree_map, unflatten_like
from .collectives import _all_gather, _count
from .sharding import Sharding, mesh_dims


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _reduce_scatter_raw(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = _size(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split over {n} ranks")
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty_like(xt)
    dist.all_to_all_single(out, xt, group=group)
    _count(xt)
    blocks = out.view(n, xt.shape[0] // n, *xt.shape[1:])
    acc = blocks[0].clone()
    for j in range(1, n):                 # rank order: the same bits every run
        acc += blocks[j]
    return acc.movedim(0, dim)


def _all_reduce_raw(x: torch.Tensor, group) -> torch.Tensor:
    if _size(group) == 1:
        return x
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    _count(y)
    return y


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(group, x, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_raw(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter_raw(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(ctx.group, g, ctx.dim), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_raw(g, ctx.group), None


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along ``dim`` in group
    order; differentiable (its adjoint is :func:`reduce_scatter`)."""
    if _size(group) == 1:
        return x
    return _AllGather.apply(x, group, dim)


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum of ``x`` over ``group``, this rank's block of ``dim`` (cut
    into the group's size, in group order); differentiable."""
    if _size(group) == 1:
        return x
    return _ReduceScatter.apply(x, group, dim)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` on every rank; differentiable."""
    if _size(group) == 1:
        return x
    return _AllReduce.apply(x, group)


def world_size(mesh) -> int:
    n = 1
    for s in mesh_dims(mesh).values():
        n *= s
    return n


def mesh_group(mesh, axes: Sequence[str]):
    """The process group over ``axes`` of ``mesh`` (None for no axes or a
    single rank)."""
    from .collectives import _dims_group

    axes = tuple(a for a in axes if mesh_dims(mesh)[a] > 1)
    if not axes:
        return None
    return _dims_group(mesh, axes)


def gather(piece: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """The whole leaf from this rank's piece, differentiable: its gradient
    comes back reduce-scattered over the leaf's sharded dimensions (sum it
    over the replicated ones with :func:`sync_grads`)."""
    x = piece
    for d in range(len(sharding.spec)):
        if sharding.parts(d) > 1:
            x = all_gather(x, mesh_group(sharding.mesh, sharding.dim_axes(d)), d)
    return x


def shard_tree(tree, shardings):
    """Each leaf's piece (a contiguous copy), the structure kept."""
    return tree_map(lambda x, s: s.local(x).contiguous().clone(), tree, shardings)


def sync_grads(pieces, shardings) -> list:
    """Each piece's gradient (zeros where a leaf got none) summed over the
    mesh dimensions its leaf is replicated on: one ``all_reduce`` per
    group of such dimensions, over the gradients concatenated in leaf
    order.  Returns the gradients in leaf order."""
    ps, ss = leaves(pieces), leaves(shardings)
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in ps]
    buckets = {}
    for i, s in enumerate(ss):
        buckets.setdefault(s.replicated_axes, []).append(i)
    mesh = ss[0].mesh if ss else None
    for axes, idx in buckets.items():
        group = mesh_group(mesh, axes)
        if group is None:
            continue
        flat = torch.cat([grads[i].reshape(-1).float() for i in idx])
        flat = _all_reduce_raw(flat, group)
        off = 0
        for i in idx:
            n = grads[i].numel()
            grads[i] = flat[off:off + n].view_as(grads[i]).to(grads[i].dtype)
            off += n
    return grads


def sharded_value_and_grad(loss_fn: Callable, shardings, mesh):
    """``vg(pieces, batch) -> (loss, grads)``: ``loss_fn(pieces, batch)`` is
    this rank's loss (the mean over its batch shard, or the whole step's
    loss where every rank computes it); its share (over the world size) is
    backpropagated and each piece's gradient summed over the dimensions its
    leaf is replicated on (:func:`sync_grads`).  ``loss`` is the mean of
    the ranks' losses, ``grads`` this rank's pieces of the one-device
    step's gradients; the pieces' ``.grad`` are left None."""
    world = world_size(mesh)
    everyone = mesh_group(mesh, mesh.mesh_dim_names)

    def vg(pieces, batch):
        for p in leaves(pieces):
            p.grad = None
        loss = loss_fn(pieces, batch)
        (loss / world).backward()
        grads = unflatten_like(pieces, sync_grads(pieces, shardings))
        for p in leaves(pieces):
            p.grad = None
        return _all_reduce_raw(loss.detach().reshape(1), everyone)[0] / world, grads

    return vg


def sharded_adamw_step(loss_fn: Callable, opt_cfg, shardings, mesh):
    """``step(pieces, opt_state, batch) -> (pieces, opt_state, {"loss",
    "grad_norm", "lr"})``: :func:`sharded_value_and_grad`, then the clip by
    the global norm over every piece once and AdamW on the pieces in
    place.  ``step.value_and_grad`` is the first half alone and
    ``step.apply(pieces, grads, opt_state)`` the second."""
    from ..training import optimizer

    vg = sharded_value_and_grad(loss_fn, shardings, mesh)

    def apply(pieces, grads, opt_state):
        return optimizer.adamw_update(opt_cfg, pieces, grads, opt_state, shardings=shardings)

    def step(pieces, opt_state, batch):
        loss, grads = vg(pieces, batch)
        pieces, opt_state, metrics = apply(pieces, grads, opt_state)
        return pieces, opt_state, {"loss": loss, **metrics}

    step.value_and_grad, step.apply = vg, apply
    return step


def norm_sq(tree, shardings: Optional[object] = None) -> torch.Tensor:
    """The fp32 sum of squares of every leaf in flattening order; with
    ``shardings``, of every piece on the first rank that holds it
    (``Sharding.is_writer``) and then summed over the mesh, so a leaf
    replicated on several ranks counts once."""
    total = None
    ls = leaves(tree)
    ss = leaves(shardings) if shardings is not None else [None] * len(ls)
    for x, s in zip(ls, ss):
        if s is not None and not s.is_writer():
            sq = torch.zeros((), dtype=torch.float32, device=x.device)
        else:
            sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    if shardings is not None and ss:
        mesh = ss[0].mesh
        total = _all_reduce_raw(total.reshape(1), mesh_group(mesh, mesh.mesh_dim_names))[0]
    return total
