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

The expert-parallel path (``make_moe_fn`` / ``moe_apply_ep``) waits for
training over a mesh (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import MoEConfig
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


def _route(params, x: torch.Tensor, cfg: MoEConfig):
    """Top-k routing -> (experts (T, k) int64, normalized weights (T, k)
    fp32, the GShard aux loss E * sum_e(frac_tokens_e * mean_prob_e) over
    primary experts)."""
    logits = x.float() @ params["router"].float()                # (T, E)
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
                              wg, wu, wd, capacity: int) -> torch.Tensor:
    """Sort-based dispatch over every expert (one device): static shapes,
    assignments past an expert's ``capacity`` dropped."""
    t, d = x.shape
    k = top_e.shape[1]
    n_exp = wg.shape[0]
    n_slots = n_exp * capacity
    dev = x.device
    e_flat = top_e.reshape(-1)                                    # (T*k,)
    order = torch.sort(e_flat, stable=True).indices               # by (expert, arrival)
    e_sorted = e_flat[order]
    counts = torch.bincount(e_sorted, minlength=n_exp)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * k, device=dev) - starts[e_sorted]
    keep = pos < capacity
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
    return y.to(x.dtype)


def moe_apply_local(params, x: torch.Tensor, cfg: MoEConfig, capacity_factor: float = None):
    """Single-device MoE: x (T, d) -> ((T, d), aux loss).  The capacity
    depends on T, so which assignments drop depends on how many tokens one
    call sees (a 1-token decode step drops differently than a prefill)."""
    t, _ = x.shape
    top_e, top_p, aux = _route(params, x, cfg)
    cap = _capacity(t, cfg, capacity_factor or cfg.capacity_factor)
    y = _dispatch_compute_combine(x, top_e, top_p, params["wg"], params["wu"], params["wd"], cap)
    if "shared" in params:
        y = y + layers.mlp_apply(params["shared"], x, "swiglu")
    return y, aux
