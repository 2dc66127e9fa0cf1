"""Step builders — port of the DLRM train, serve and retrieval builders
and the LM train builder of ``repro/launch/steps.py``
(``build_recsys_train`` :531, ``build_recsys_serve`` :557,
``build_recsys_retrieval`` :575, ``build_lm_train`` :149), on one device
with no mesh.

  train_batch            -> BCE loss, its gradient and AdamW (lr 1e-3, no
                            weight decay); the lookups' gradient through
                            the bag kernel's backward
  serve_p99 / serve_bulk -> ``dlrm.forward`` over a batch of contexts
  retrieval_cand         -> ADACUR (``adacur.adacur_search``) over
                            ``n_candidates`` items with DLRM as the exact
                            cross-encoder-class scorer
  LM train_4k            -> next-token NLL over sequence chunks (each
                            chunk's logits recomputed in the backward), its
                            gradient (accumulated over microbatches for the
                            largest models) and AdamW

A train step ``step(params, opt_state, batch) -> (params, opt_state,
metrics)`` updates ``params`` and the optimizer state in place
(``training.optimizer``); the parameters are leaf tensors that require
grad.

Each builder returns a :class:`StepBundle` whose ``args`` are concrete
tensors (the reference's are abstract shapes for its dry run): weights
drawn from a seed as ``_recsys_init`` does with ``PRNGKey(0)``, contexts
from a seeded generator with raw sparse ids in [0, 2^31).  BST, BERT4Rec,
MIND and training over a mesh are later slices (ROADMAP.md, queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..configs.base import AdaCURConfig, LMConfig, LMShape, RecSysConfig, RecSysShape
from ..core import adacur, prng
from ..core.scorer import ScorerStats
from ..device import resolve_device
from ..models import transformer
from ..models.recsys import dlrm, embedding
from ..training import optimizer
from ..tree import leaves, tree_map

K_Q = 500                 # anchor contexts of the retrieval step's R_anc
PAIRS_PER_CALL = 131072   # DLRM pairs a forward of the R_anc build (~6 GB live)
RETRIEVAL_CFG = AdaCURConfig(
    k_anchor=250, n_rounds=5, budget_ce=500, strategy="topk",
    split_budget=True, k_retrieve=100,
)


@dataclass
class StepBundle:
    """One runnable step: ``step(*args)``."""

    name: str
    step: Callable
    args: tuple
    model_flops: float                    # analytic FLOPs of a step
    stats: Optional[ScorerStats] = None   # the retrieval step's CE calls


def _dlrm_only(cfg: RecSysConfig) -> None:
    if cfg.kind != "dlrm":
        raise NotImplementedError(f"{cfg.name}: only the dlrm kind is ported "
                                  "(ROADMAP.md, queue 1, item 13)")


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def recsys_init(cfg: RecSysConfig, seed: int = 0, device=None) -> dict:
    """DLRM weights drawn on ``device``'s own generator seeded with
    ``seed`` (one seed gives other weights on the card than on the CPU)."""
    _dlrm_only(cfg)
    dev = resolve_device(device)
    return dlrm.init_dlrm(cfg, _generator(seed, dev), dev)


def recsys_inputs(cfg: RecSysConfig, batch: int, seed: int = 1, device=None) -> dict:
    """A batch of DLRM contexts: ``dense`` (B, n_dense) fp32 standard
    normal, ``sparse`` (B, n_sparse) int32 raw ids in [0, 2^31)."""
    _dlrm_only(cfg)
    dev = resolve_device(device)
    g = _generator(seed, dev)
    return {"dense": torch.randn((batch, cfg.n_dense), generator=g, device=dev),
            "sparse": torch.randint(0, 2 ** 31, (batch, cfg.n_sparse), generator=g,
                                    device=dev, dtype=torch.int32)}


def recsys_flops(cfg: RecSysConfig, batch: int) -> float:
    """Analytic forward FLOPs of ``batch`` DLRM scores (the reference's
    ``_recsys_flops``): MLPs plus the (F+1)^2 x dim dot interaction."""
    _dlrm_only(cfg)
    mlp = sum(a * b for a, b in zip(cfg.bot_mlp[:-1], cfg.bot_mlp[1:]))
    n = cfg.n_sparse + 1
    mlp += (n * (n - 1) // 2 + cfg.bot_mlp[-1]) * cfg.top_mlp[1]
    mlp += sum(a * b for a, b in zip(cfg.top_mlp[1:-1], cfg.top_mlp[2:]))
    inter = n * n * cfg.embed_dim
    return 2.0 * batch * (mlp + inter)


def anchor_scores(params, cfg: RecSysConfig, contexts: dict, n_items: int) -> torch.Tensor:
    """The offline R_anc (k_q, padded_rows(n_items)) fp32: exact DLRM scores
    of each anchor context against items 0..n_items-1 (the candidate id goes
    into sparse field 0), in forwards of about ``PAIRS_PER_CALL`` pairs;
    padded columns are 0 (the search never samples them)."""
    dense, sparse = contexts["dense"], contexts["sparse"]
    k_q, dev = dense.shape[0], dense.device
    out = torch.zeros((k_q, embedding.padded_rows(n_items)), dtype=torch.float32, device=dev)
    cols = min(n_items, PAIRS_PER_CALL)
    rows = max(1, PAIRS_PER_CALL // cols)
    for r0 in range(0, k_q, rows):
        r1 = min(k_q, r0 + rows)
        for c0 in range(0, n_items, cols):
            c1 = min(n_items, c0 + cols)
            items = torch.arange(c0, c1, dtype=torch.int32, device=dev).expand(r1 - r0, -1)
            out[r0:r1, c0:c1] = dlrm.score_candidates(params, dense[r0:r1], sparse[r0:r1],
                                                      items, cfg)
    return out


def build_recsys_serve(arch_id: str, cfg: RecSysConfig, shape: RecSysShape, *,
                       params=None, seed: int = 0, device=None) -> StepBundle:
    """``step(params, batch) -> (B,)`` logits of ``shape.batch`` contexts."""
    _dlrm_only(cfg)
    params = recsys_init(cfg, seed, device) if params is None else params
    dev = params["tables"][0].device

    def step(params, batch):
        return dlrm.forward(params, batch["dense"], batch["sparse"], cfg)

    batch = recsys_inputs(cfg, shape.batch, seed + 1, dev)
    return StepBundle(f"{arch_id}:{shape.name}", step, (params, batch),
                      recsys_flops(cfg, shape.batch))


def build_recsys_retrieval(arch_id: str, cfg: RecSysConfig, shape: RecSysShape, *,
                           params=None, r_anc=None, seed: int = 0,
                           device=None) -> StepBundle:
    """The paper's technique at scale: ``step(params, batch, key) ->
    (topk_idx, topk_scores)``, ADACUR over ``shape.n_candidates`` items
    (the candidate axis padded by ``embedding.padded_rows``) with DLRM as
    the exact scorer, ``RETRIEVAL_CFG``'s budget of 500 CE calls per
    context.

    ``r_anc`` defaults to :func:`anchor_scores` of ``K_Q`` seeded anchor
    contexts (other contexts than the served ones).  ``stats`` counts the
    CE calls of every step."""
    _dlrm_only(cfg)
    params = recsys_init(cfg, seed, device) if params is None else params
    dev = params["tables"][0].device
    n_cand, b = shape.n_candidates, shape.batch
    if r_anc is None:
        anchors = recsys_inputs(cfg, K_Q, seed + 2, dev)
        r_anc = anchor_scores(params, cfg, anchors, n_cand)
    stats = ScorerStats()

    def step(params, batch, key):
        def sf(q, idx):
            stats.requests += 1
            stats.pairs += idx.numel()
            stats.ce_calls += idx.numel()
            return dlrm.score_candidates(params, q["dense"], q["sparse"], idx, cfg)

        query = {"dense": batch["dense"], "sparse": batch["sparse"]}
        res = adacur.adacur_search(sf, batch["r_anc"], query, RETRIEVAL_CFG, key,
                                   batch=b, n_valid_items=n_cand)
        return res.topk_idx, res.topk_scores

    batch = dict(recsys_inputs(cfg, b, seed + 1, dev), r_anc=r_anc)
    acfg = RETRIEVAL_CFG
    # dominant: n_rounds passes of e_q @ R_anc plus budget_ce DLRM scores
    flops = (2.0 * b * r_anc.shape[0] * n_cand * acfg.n_rounds
             + recsys_flops(cfg, acfg.budget_ce))
    return StepBundle(f"{arch_id}:{shape.name}", step, (params, batch, prng.PRNGKey(seed)),
                      flops, stats)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def require_grad(params):
    """``params`` with every leaf set to require grad (in place)."""
    for p in leaves(params):
        p.requires_grad_(True)
    return params


def _set_grads_none(params) -> None:
    for p in leaves(params):
        p.grad = None


def train_step(loss_fn: Callable, opt_cfg: optimizer.AdamWConfig, n_micro: int = 1):
    """``step(params, opt_state, batch) -> (params, opt_state, {"loss",
    "grad_norm", "lr"})``: the loss's gradient (the mean over ``n_micro``
    microbatches split off the batch's leading axis through
    ``optimizer.accumulate_grads`` when ``n_micro > 1``), then one AdamW
    update in place.  The gradients are dropped after the update."""
    def step(params, opt_state, batch):
        _set_grads_none(params)
        if n_micro > 1:
            mb = tree_map(lambda x: x.reshape((n_micro, x.shape[0] // n_micro) + x.shape[1:]),
                          batch)
            grads, loss = optimizer.accumulate_grads(loss_fn, params, mb, n_micro)
        else:
            loss = loss_fn(params, batch)
            loss.backward()
            grads = tree_map(lambda p: torch.zeros_like(p) if p.grad is None else p.grad,
                             params)
        params, opt_state, metrics = optimizer.adamw_update(opt_cfg, params, grads, opt_state)
        del grads
        _set_grads_none(params)
        return params, opt_state, {"loss": loss.detach(), **metrics}

    return step


def recsys_train_inputs(cfg: RecSysConfig, batch: int, seed: int = 1, device=None) -> dict:
    """:func:`recsys_inputs` plus ``labels`` (B,) fp32 in {0, 1} from the
    same seeded generator."""
    dev = resolve_device(device)
    ctx = recsys_inputs(cfg, batch, seed, dev)
    g = _generator(seed + 1000, dev)
    ctx["labels"] = torch.randint(0, 2, (batch,), generator=g, device=dev).to(torch.float32)
    return ctx


def _recsys_loss(cfg: RecSysConfig):
    _dlrm_only(cfg)
    return lambda p, b: dlrm.bce_loss(p, b["dense"], b["sparse"], b["labels"], cfg)


def build_recsys_train(arch_id: str, cfg: RecSysConfig, shape: RecSysShape, *,
                       params=None, seed: int = 0, device=None) -> StepBundle:
    """``step(params, opt_state, batch)``: one DLRM train step at
    ``shape.batch`` (BCE, its gradient, AdamW with lr 1e-3 and no weight
    decay, as the reference).  ``args`` = (params requiring grad, a fresh
    AdamW state, a seeded batch with labels); ``model_flops`` = 3 x the
    forward's (forward + backward)."""
    opt_cfg = optimizer.AdamWConfig(lr=1e-3, weight_decay=0.0)
    loss_fn = _recsys_loss(cfg)
    params = recsys_init(cfg, seed, device) if params is None else params
    require_grad(params)
    dev = params["tables"][0].device
    batch = recsys_train_inputs(cfg, shape.batch, seed + 1, dev)
    return StepBundle(f"{arch_id}:{shape.name}", train_step(loss_fn, opt_cfg),
                      (params, optimizer.init_adamw(params), batch),
                      3.0 * recsys_flops(cfg, shape.batch))


def _chunked_nll(params, h: torch.Tensor, targets: torch.Tensor, cfg: LMConfig,
                 chunk: int = 512) -> torch.Tensor:
    """Mean next-token NLL over sequence chunks: each chunk's (B, chunk, V)
    logits are recomputed in the backward (``torch.utils.checkpoint``, the
    reference's ``jax.checkpoint``), so the full logits never live at once;
    the chunk sums add in sequence order."""
    from torch.utils.checkpoint import checkpoint

    b, l, d = h.shape
    chunk = min(chunk, l)
    if l % chunk:
        raise ValueError(f"sequence length {l} is not a multiple of the loss chunk {chunk}")

    def one(hc, tc):
        logits = transformer.lm_logits(params, hc, cfg)
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -torch.gather(logp, -1, tc[..., None].long()).sum()

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(l // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + checkpoint(one, h[:, sl], targets[:, sl], use_reentrant=False)
    return total / (b * l)


def _lm_loss_fn(cfg: LMConfig):
    def loss_fn(params, batch):
        h, _ = transformer.encode(params, batch["tokens"], cfg)
        return _chunked_nll(params, h, batch["targets"], cfg)

    return loss_fn


def lm_train_inputs(cfg: LMConfig, batch: int, seq_len: int, seed: int = 1,
                    device=None) -> dict:
    """``tokens`` (B, L) int32 drawn in [4, vocab) from a seeded generator
    and ``targets`` the next token (the sequence shifted by one, wrapping)."""
    dev = resolve_device(device)
    g = _generator(seed, dev)
    tokens = torch.randint(4, cfg.vocab_size, (batch, seq_len), generator=g, device=dev,
                           dtype=torch.int32)
    return {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}


def build_lm_train(arch_id: str, cfg: LMConfig, shape: LMShape, *, params=None,
                   global_batch: Optional[int] = None, n_micro: Optional[int] = None,
                   seed: int = 0, device=None) -> StepBundle:
    """``step(params, opt_state, batch)``: one LM train step (chunked NLL,
    its gradient, AdamW at the reference's defaults).  ``global_batch``
    cuts the shape's batch to what one card holds; ``n_micro`` defaults to
    the reference's rule (4 microbatches above 4e10 parameters).
    ``model_flops`` = 6 x active parameters x tokens."""
    dev = resolve_device(device)
    b = shape.global_batch if global_batch is None else global_batch
    if n_micro is None:
        n_micro = 4 if cfg.n_params() > 4e10 else 1
    if b % n_micro:
        raise ValueError(f"global batch {b} does not split into {n_micro} microbatches")
    params = transformer.init_lm(cfg, _generator(seed, dev)) if params is None else params
    require_grad(params)
    batch = lm_train_inputs(cfg, b, shape.seq_len, seed + 1, dev)
    step = train_step(_lm_loss_fn(cfg), optimizer.AdamWConfig(), n_micro)
    return StepBundle(f"{arch_id}:{shape.name}", step,
                      (params, optimizer.init_adamw(params), batch),
                      6.0 * cfg.n_active_params() * b * shape.seq_len)
