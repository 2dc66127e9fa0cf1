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
one-device step's.  ``reduce_scatter`` is an ``all_to_all_single`` in the
input's dtype and a local fp32 sum in rank order, cast back once (gloo on
CUDA tensors has no reduce-scatter), so two runs give the same bits and a
bf16 sum over any number of ranks rounds once.  Each counts its call and the bytes this
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
    acc = blocks[0].to(torch.float32, copy=True)
    for j in range(1, n):                 # rank order: the same bits every run
        acc += blocks[j]
    return acc.to(x.dtype).movedim(0, dim)


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


def gather(piece: torch.Tensor, sharding: Sharding, keep: Sequence[str] = ()) -> torch.Tensor:
    """The whole leaf from this rank's piece, differentiable: its gradient
    comes back reduce-scattered over the leaf's sharded dimensions (sum it
    over the replicated ones with :func:`sync_grads`).  A dimension split
    over a mesh dimension in ``keep`` stays this rank's piece (the
    tensor-parallel layer gathers only over ``data``, ``keep=("model",)``);
    a tensor dimension split over kept and other mesh dimensions at once
    raises."""
    x = piece
    for d in range(len(sharding.spec)):
        axes = sharding.dim_axes(d)
        if sharding.parts(d) == 1 or not set(axes) - set(keep):
            continue
        if set(axes) & set(keep):
            raise ValueError(f"dimension {d} of {sharding.spec} mixes kept mesh dimensions "
                             f"{tuple(keep)} with others")
        x = all_gather(x, mesh_group(sharding.mesh, axes), d)
    return x


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``x`` over ``group``, without a gradient."""
    if _size(group) == 1:
        return x.detach()
    y = x.detach().contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    _count(y)
    return y


def all_to_all(x: torch.Tensor, group, split_dim: int, cat_dim: int) -> torch.Tensor:
    """``x`` cut into the group's size along ``split_dim``, block j sent to
    rank j, the blocks received concatenated along ``cat_dim`` in rank
    order (a layout change, e.g. heads to sequence); without a gradient."""
    n = _size(group)
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"dimension {split_dim} of {tuple(x.shape)} does not split over "
                         f"{n} ranks")
    xt = x.detach().movedim(split_dim, 0).contiguous()
    out = torch.empty_like(xt)
    dist.all_to_all_single(out, xt, group=group)
    _count(xt)
    blocks = out.view(n, xt.shape[0] // n, *xt.shape[1:]).movedim(1, split_dim + 1)
    return torch.cat(list(blocks), dim=cat_dim)


def shard_tree(tree, shardings):
    """Each leaf's piece (a contiguous copy), the structure kept."""
    return tree_map(lambda x, s: s.local(x).contiguous().clone(), tree, shardings)


SYNC_BUCKET = 1 << 26      # fp32 elements an all-reduce of sync_grads carries, at most


def sync_grads(pieces, shardings, grads: Optional[list] = None) -> list:
    """Each piece's gradient (``grads`` in leaf order, else the pieces'
    ``.grad``, zeros where a leaf got none) summed over the mesh
    dimensions its leaf is replicated on, in fp32: per group of such
    dimensions, the gradients concatenated in leaf order and all-reduced
    in buckets of at most ``SYNC_BUCKET`` elements (a larger leaf alone),
    so the fp32 copies of a bf16 model stay small.  Returns the gradients
    in leaf order, each in its own dtype."""
    ps, ss = leaves(pieces), leaves(shardings)
    if grads is None:
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in ps]
    grads = list(grads)
    groups = {}
    for i, s in enumerate(ss):
        groups.setdefault(s.replicated_axes, []).append(i)
    mesh = ss[0].mesh if ss else None
    for axes, idx in groups.items():
        group = mesh_group(mesh, axes)
        if group is None:
            continue
        buckets, size = [[]], 0
        for i in idx:
            if buckets[-1] and size + grads[i].numel() > SYNC_BUCKET:
                buckets.append([])
                size = 0
            buckets[-1].append(i)
            size += grads[i].numel()
        for bucket in buckets:
            flat = _all_reduce_raw(torch.cat([grads[i].reshape(-1).float() for i in bucket]),
                                   group)
            off = 0
            for i in bucket:
                n = grads[i].numel()
                grads[i] = flat[off:off + n].view_as(grads[i]).to(grads[i].dtype)
                off += n
    return grads


def sharded_value_and_grad(loss_fn: Callable, shardings, mesh, n_micro: int = 1):
    """``vg(pieces, batch) -> (loss, grads)``: ``loss_fn(pieces, batch)`` is
    this rank's loss (the mean over its batch shard, or the whole step's
    loss where every rank computes it); its share (over the world size) is
    backpropagated and each piece's gradient summed over the dimensions its
    leaf is replicated on (:func:`sync_grads`).  ``loss`` is the mean of
    the ranks' losses, ``grads`` this rank's pieces of the one-device
    step's gradients; the pieces' ``.grad`` are left None.  With
    ``n_micro`` > 1 each rank's batch is cut into that many microbatches
    along every leaf's leading axis and ``optimizer.accumulate_grads``
    adds their gradients in fp32 in microbatch order, as the reference
    does (``grads`` are then fp32 whatever the model's dtype); one
    :func:`sync_grads` follows, and the loss is the microbatches' mean."""
    from ..training import optimizer

    world = world_size(mesh)
    everyone = mesh_group(mesh, mesh.mesh_dim_names)

    def vg(pieces, batch):
        ps = leaves(pieces)
        for p in ps:
            p.grad = None
        if n_micro == 1:
            loss = loss_fn(pieces, batch)
            (loss / world).backward()
            grads = sync_grads(pieces, shardings)
            for p in ps:
                p.grad = None
        else:
            micro = tree_map(
                lambda x: x.reshape((n_micro, x.shape[0] // n_micro) + x.shape[1:]), batch)
            acc, loss = optimizer.accumulate_grads(
                lambda p, mb: loss_fn(p, mb) / world, pieces, micro, n_micro)
            grads = sync_grads(pieces, shardings, leaves(acc))
            loss = loss * world
        loss = _all_reduce_raw(loss.detach().reshape(1), everyone)[0] / world
        return loss, unflatten_like(pieces, grads)

    return vg


def sharded_adamw_step(loss_fn: Callable, opt_cfg, shardings, mesh, n_micro: int = 1):
    """``step(pieces, opt_state, batch) -> (pieces, opt_state, {"loss",
    "grad_norm", "lr"})``: :func:`sharded_value_and_grad` (over ``n_micro``
    microbatches), then the clip by the global norm over every piece once
    and AdamW on the pieces in place.  ``step.value_and_grad`` is the first
    half alone and ``step.apply(pieces, grads, opt_state)`` the second."""
    from ..training import optimizer

    vg = sharded_value_and_grad(loss_fn, shardings, mesh, n_micro)

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
