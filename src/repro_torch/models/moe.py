"""Mixture-of-experts FFN with top-k routing — port of the single-device
path of ``repro/models/moe.py`` (``moe_init``, ``_route``, ``_capacity``,
``_expert_ffn``, ``_dispatch_compute_combine``, ``moe_apply_local``).

Sort-based dispatch with static shapes: the (token, choice) assignments
are sorted by expert (stably, so arrival order persists within an
expert), each expert takes its first ``capacity`` assignments into a
fixed (E, C, d) buffer and drops the rest (the GShard policy), the experts
run as batched SwiGLU products, and each token sums its kept slots.

Three places where a plain PyTorch translation would change the
reference's function, and what the port does instead:

- routing ties: ``lax.top_k`` gives a tie to the lower expert id;
  ``torch.topk`` does not keep that order, so routing selects through the
  port's index-stable ``select.stable_topk``;
- dispatch: ``jnp.argsort(stable=True)`` is ``torch.sort(stable=True)``,
  so the same assignments fill the same slots and the same ones drop;
- combine: the reference's ``segment_sum`` would be ``index_add_``, whose
  float atomics on the card change the bits from run to run.  Each token
  instead gathers its ``top_k`` slots and adds them in ascending slot
  order (ascending expert id), in fp32, then casts once: deterministic,
  and within fp32 rounding of the reference (which adds the same terms in
  slot order).

The expert-parallel path (``make_moe_fn`` / ``moe_apply_ep``) splits the
experts over a mesh dimension, one process per rank (``expert_slice``
gives each rank its experts).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..configs.base import MoEConfig
from ..distributed import fsdp
from ..distributed.collectives import _dims_group
from ..distributed.sharding import check_mesh_device
from ..kernels.approx_topk.select import stable_topk
from . import layers


def moe_init(generator: torch.Generator, d_model: int, cfg: MoEConfig,
             dtype=torch.float32) -> dict:
    """The reference's shapes and scales (the router in fp32), the port's
    own draws."""
    params = {
        "router": layers.dense_init(generator, (d_model, cfg.n_experts)),
        "wg": layers.dense_init(generator, (cfg.n_experts, d_model, cfg.d_expert), dtype=dtype),
        "wu": layers.dense_init(generator, (cfg.n_experts, d_model, cfg.d_expert), dtype=dtype),
        "wd": layers.dense_init(generator, (cfg.n_experts, cfg.d_expert, d_model), dtype=dtype),
    }
    if cfg.n_shared_experts:
        params["shared"] = layers.mlp_init(generator, d_model,
                                           cfg.d_expert * cfg.n_shared_experts, "swiglu", dtype)
    return params


def moe_specs(cfg: MoEConfig) -> dict:
    """The logical axes of :func:`moe_init`'s leaves (the reference's)."""
    specs = {"router": ("embed", "expert"), "wg": ("expert", "embed", "mlp"),
             "wu": ("expert", "embed", "mlp"), "wd": ("expert", "mlp", "embed")}
    if cfg.n_shared_experts:
        specs["shared"] = layers.mlp_specs("swiglu")
    return specs


def _route(params, x: torch.Tensor, cfg: MoEConfig, logits=None):
    """Top-k routing -> (experts (T, k) int64, normalized weights (T, k)
    fp32, the GShard aux loss E * sum_e(frac_tokens_e * mean_prob_e) over
    primary experts); ``logits`` (T, E) when the caller has them."""
    if logits is None:
        logits = x.float() @ params["router"].float()            # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = stable_topk(probs, cfg.top_k)                 # ties -> lower id
    top_p = top_p / (top_p.sum(-1, keepdim=True) + 1e-9)
    frac = torch.bincount(top_e[:, 0].long(), minlength=cfg.n_experts).float() / x.shape[0]
    aux = cfg.n_experts * torch.sum(frac * probs.mean(0))
    return top_e.long(), top_p, aux


def _capacity(t: int, cfg: MoEConfig, factor: float = 1.25) -> int:
    c = int(t * cfg.top_k / cfg.n_experts * factor) + 1
    return max(4, (c + 3) // 4 * 4)


def _expert_ffn(wg, wu, wd, xin: torch.Tensor) -> torch.Tensor:
    """Batched SwiGLU over (E, C, d) with (E, d, f) / (E, f, d) weights."""
    return torch.bmm(F.silu(torch.bmm(xin, wg)) * torch.bmm(xin, wu), wd)


def _dispatch_compute_combine(x: torch.Tensor, top_e: torch.Tensor, top_p: torch.Tensor,
                              wg, wu, wd, capacity: int, expert_offset: int = 0) -> torch.Tensor:
    """Sort-based dispatch over the experts ``wg`` holds, global ids
    ``expert_offset ..`` (all of them on one device): static shapes,
    assignments past an expert's ``capacity`` dropped, assignments to
    another rank's experts left to that rank.  Returns the (T, d) sum of
    this rank's expert outputs in fp32."""
    t, d = x.shape
    k = top_e.shape[1]
    n_exp = wg.shape[0]
    n_slots = n_exp * capacity
    dev = x.device
    e_flat = top_e.reshape(-1) - expert_offset                    # (T*k,) local ids
    # another rank's experts sort into one bucket past the local ones, so
    # each local expert's assignments keep their arrival positions
    e_flat = torch.where((e_flat >= 0) & (e_flat < n_exp), e_flat, n_exp)
    order = torch.sort(e_flat, stable=True).indices               # by (expert, arrival)
    e_sorted = e_flat[order]
    counts = torch.bincount(e_sorted, minlength=n_exp + 1)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * k, device=dev) - starts[e_sorted]
    keep = (pos < capacity) & (e_sorted < n_exp)
    slot_sorted = torch.where(keep, e_sorted * capacity + pos, n_slots)
    # each assignment's slot (n_slots: dropped), back in (token, choice) order
    slot = torch.empty_like(slot_sorted).scatter_(0, order, slot_sorted).reshape(t, k)
    tok = torch.arange(t, device=dev).repeat_interleave(k)
    slot_tok = torch.zeros(n_slots + 1, dtype=torch.long, device=dev)
    slot_tok[slot.reshape(-1)] = tok                              # kept slots are unique
    xin = x[slot_tok[:n_slots]]                                   # empty slots: token 0
    out = _expert_ffn(wg, wu, wd, xin.reshape(n_exp, capacity, d)).reshape(n_slots, d)
    out = torch.cat([out, out.new_zeros(1, d)])                   # row n_slots: a drop
    # each token's slots in ascending order (drops, all n_slots, last), the
    # weight product in x's dtype as the reference's, the sum in fp32
    rank = torch.argsort(slot, dim=1, stable=True)
    slot = torch.gather(slot, 1, rank)
    w = torch.gather(top_p, 1, rank).to(x.dtype)
    y = torch.zeros((t, d), dtype=torch.float32, device=dev)
    for j in range(k):
        y += (out[slot[:, j]] * w[:, j:j + 1]).float()
    return y


def moe_apply_local(params, x: torch.Tensor, cfg: MoEConfig, capacity_factor: float = None):
    """Single-device MoE: x (T, d) -> ((T, d), aux loss).  The capacity
    depends on T, so which assignments drop depends on how many tokens one
    call sees (a 1-token decode step drops differently than a prefill)."""
    t, _ = x.shape
    top_e, top_p, aux = _route(params, x, cfg)
    cap = _capacity(t, cfg, capacity_factor or cfg.capacity_factor)
    y = _dispatch_compute_combine(x, top_e, top_p, params["wg"], params["wu"], params["wd"],
                                  cap).to(x.dtype)
    if "shared" in params:
        y = y + layers.mlp_apply(params["shared"], x, "swiglu")
    return y, aux


def expert_slice(params, mesh, ep_axis: str = "model") -> dict:
    """This rank's part of MoE ``params`` for ``make_moe_fn``: the experts
    ``wg`` / ``wu`` / ``wd`` split evenly over ``ep_axis`` (rank i of the
    dimension holds experts [i * E / n, (i + 1) * E / n)), the router and
    the shared experts whole."""
    group = _dims_group(mesh, (ep_axis,))
    n, r = dist.get_world_size(group), dist.get_rank(group)
    e = params["wg"].shape[0]
    if e % n:
        raise ValueError(f"{e} experts do not split over {n} ranks of '{ep_axis}'")
    lo, hi = r * e // n, (r + 1) * e // n
    return {k: (v[lo:hi].clone() if k in ("wg", "wu", "wd") else v) for k, v in params.items()}


def make_moe_fn(mesh, cfg: MoEConfig, batch_axes, ep_axis: str = "model",
                capacity_factor: float = None, scatter_tokens: bool = False, device=None):
    """The expert-parallel MoE for ``transformer._ffn``:
    ``moe_fn(params, x, order=None) -> (y, aux)`` with this rank's experts
    (``expert_slice``, or its pieces under ``tree_specs``) and its tokens x
    (T_local, d): tokens split over ``batch_axes`` (the caller hands each
    rank its rows) and whole over ``ep_axis``, so dispatch needs no
    collective.  Each rank runs its experts on the tokens routed to them,
    and the combine is one all-reduce over ``ep_axis`` (y (T_local, d));
    with ``scatter_tokens`` it is a reduce-scatter, y is this rank's block
    of T_local / n_ep token rows (row-major over ``ep_axis``, in ``order``
    when given: a permutation of the rows, ``transformer.seq_order``, so
    that the blocks are the residual's sequence chunks), and whole shared
    experts run once on that block.  Routing and capacity see the rows in
    their own order either way.  ``aux`` (per data group, GShard's
    definition) is averaged over every mesh dimension.  Every collective is
    differentiable (``distributed.fsdp``), so the MoE trains.

    Pieces split over ``ep_axis`` beyond the experts (``tree_specs`` puts
    the router's expert columns and the shared experts' hidden columns on
    ``model``) are used in place: the router's logits are all-gathered,
    and the shared experts' partial sums join the combine.

    The local path adds a token's slots in ascending slot order; the
    combine adds the ranks' partial sums in rank order, so y equals the
    single-device MoE to fp32 rounding, not bit for bit.  The partial sums
    are fp32 and y is cast to x's dtype once.  ``device`` is the card
    unless the caller passes ``"cpu"`` (the device rule)."""
    check_mesh_device(mesh, device)
    ep_group = _dims_group(mesh, (ep_axis,))
    all_group = _dims_group(mesh, tuple(mesh.mesh_dim_names))
    n_ep, ep_rank = dist.get_world_size(ep_group), dist.get_rank(ep_group)
    n_all = dist.get_world_size(all_group)

    def moe_fn(params, x, order=None):
        y, aux = moe_apply_ep(params, x, cfg, ep_group, ep_rank, n_ep, capacity_factor,
                              scatter_tokens, order)
        return y, fsdp.all_reduce(aux.reshape(1), all_group)[0] / n_all

    moe_fn.scatter_tokens = scatter_tokens
    return moe_fn


def moe_apply_ep(params, x: torch.Tensor, cfg: MoEConfig, ep_group, ep_rank: int, n_ep: int,
                 capacity_factor: float = None, scatter_tokens: bool = False, order=None):
    """The expert-parallel body on one rank: its experts (global ids from
    ``ep_rank * E_local``) over its tokens x (T_local, d), combined over
    ``ep_group`` -> (y, this data group's aux)."""
    t, d = x.shape
    logits = None
    if params["router"].shape[1] != cfg.n_experts:     # the rank's expert columns
        logits = fsdp.all_gather(x.float() @ params["router"].float(), ep_group, 1)
    top_e, top_p, aux = _route(params, x, cfg, logits)
    cap = _capacity(t, cfg, capacity_factor or cfg.capacity_factor)
    y = _dispatch_compute_combine(x, top_e, top_p, params["wg"], params["wu"], params["wd"],
                                  cap, expert_offset=ep_rank * params["wg"].shape[0])
    shared = params.get("shared")
    split_shared = shared is not None and shared["wu"].shape[1] != (
        cfg.d_expert * cfg.n_shared_experts)
    if split_shared:                       # its hidden columns: a partial sum as well
        y = y + layers.mlp_apply(shared, x, "swiglu").float()
    if scatter_tokens:
        if t % n_ep:
            raise ValueError(f"{t} tokens do not scatter over {n_ep} ranks")
        chunk = t // n_ep
        if order is not None:
            y, x = y[order], x[order]
        y = fsdp.reduce_scatter(y, ep_group, 0).to(x.dtype)
        if shared is not None and not split_shared:
            y = y + layers.mlp_apply(shared, x[ep_rank * chunk:(ep_rank + 1) * chunk], "swiglu")
    else:
        y = fsdp.all_reduce(y, ep_group).to(x.dtype)
        if shared is not None and not split_shared:
            y = y + layers.mlp_apply(shared, x, "swiglu")
    return y, aux
