"""Step builders — port of ``repro/launch/steps.py``'s recsys train, serve
and retrieval builders (``build_recsys_train`` :531, ``build_recsys_serve``
:557, ``build_recsys_retrieval`` :575, over the per-kind dispatch
``_recsys_init`` :419, ``_recsys_inputs`` :432, ``_recsys_loss`` :465,
``_recsys_forward`` :479 and ``_recsys_flops`` :511), its LM builders
(``build_lm_train`` :149, ``build_lm_prefill`` :219, ``build_lm_decode``
:256), its GNN builder (``build_gnn_train`` :363 over ``_gnn_batch``
:309), the paper's full pipeline with a model-zoo cross-encoder
(``build_lm_adacur_serve`` :661) and the dispatcher ``build_cell`` (:745),
on one device with no mesh.

  recsys train_batch     -> the kind's loss (DLRM and BST: BCE; BERT4Rec:
                            the masked item's sampled softmax; MIND: the
                            label-aware sampled softmax), its gradient
                            (microbatched when asked) and AdamW (lr 1e-3,
                            no weight decay); DLRM's lookups' gradient
                            through the bag kernel's backward
  serve_p99 / serve_bulk -> DLRM and BST ``forward``, BERT4Rec
                            ``score_candidates`` of the target, MIND's
                            ``retrieve`` of its top 100 over every item; on
                            the card in batch chunks that fit
                            (``serve_chunk_rows``)
  retrieval_cand         -> ADACUR (``adacur.adacur_search``) over
                            ``n_candidates`` items with DLRM, BST or
                            BERT4Rec as the exact cross-encoder-class
                            scorer; MIND's native brute retrieval
  LM train_4k            -> next-token NLL over sequence chunks (each
                            chunk's logits recomputed in the backward), plus
                            the MoE aux loss, its gradient (accumulated over
                            microbatches for the largest models) and AdamW
  LM prefill_32k         -> ``encode`` through the flash kernel, returning
                            the last position's logits and every layer's KV
  LM decode_32k/long_500k-> one KV-cached ``decode_step`` (the local decode
                            core; the reference's sequence-parallel core is
                            its mesh path)
  nequip (all four)      -> the per-graph energy MSE, its gradient and AdamW
                            (lr 1e-3); graphs above 100,000 nodes in edge
                            chunks of 262,144 with each interaction block
                            recomputed in the backward; message passing
                            deterministic (no atomics on the card)
  LM adacur_serve        -> ADACUR over ``n_items`` items whose exact scorer
                            is the LM as a cross-encoder (a prefill of
                            ``[CLS] q [SEP] i [SEP]`` per call, flash)

A train step ``step(params, opt_state, batch) -> (params, opt_state,
metrics)`` updates ``params`` and the optimizer state in place
(``training.optimizer``); the parameters are leaf tensors that require
grad.

Each builder returns a :class:`StepBundle` whose ``args`` are concrete
tensors (the reference's are abstract shapes for its dry run): weights
drawn from a seed as ``_recsys_init`` does with ``PRNGKey(0)``, inputs
from a seeded generator (DLRM's raw sparse ids in [0, 2^31), item ids in
[0, n_items); a GNN batch's graph from ``models/gnn/sampler.py``).  The
serving steps run under ``torch.no_grad()``.  With ``mesh=`` the GNN,
LM and DLRM train builders, ``build_lm_prefill`` and ``build_lm_decode``
run over a ``torch.distributed`` mesh, one process a rank (each builder's
doc); the other recsys kinds and ``build_lm_adacur_serve`` over a mesh
wait (ROADMAP.md, queue 1, item 2c).
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..configs import registry
from ..configs.base import (AdaCURConfig, GNNConfig, GraphShape, LMConfig, LMShape,
                            RecSysConfig, RecSysShape)
from ..core import adacur, prng
from ..core.scorer import ScorerStats
from ..device import resolve_device
from ..distributed import fsdp, sharding
from ..models import cross_encoder, moe as moe_lib, transformer
from ..models.gnn import nequip, sampler
from ..models.recsys import bert4rec, bst, dlrm, embedding, mind
from ..training import optimizer
from ..tree import leaves, leaves_with_paths, tree_map, unflatten_like

K_Q = 500                 # anchor contexts of the retrieval step's R_anc
PAIRS_PER_CALL = 131072   # pairs a forward of the R_anc build, at most (DLRM: ~6 GB live)
MEM_SHARE = 0.6           # of the card's memory a serve chunk's temporaries may take
MIND_NEGATIVES = 64       # MIND's sampled negatives a training row
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
    shardings: Any = None                 # over a mesh: the parameters' shardings


_INIT = {"dlrm": dlrm.init_dlrm, "bst": bst.init_bst,
         "bert4rec": bert4rec.init_bert4rec, "mind": mind.init_mind}


def _kind(cfg: RecSysConfig) -> str:
    """``cfg.kind``; an unknown kind raises ``KeyError``, as the
    reference's dispatch does."""
    if cfg.kind not in _INIT:
        raise KeyError(cfg.kind)
    return cfg.kind


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _device_of(params) -> torch.device:
    return leaves(params)[0].device


def recsys_init(cfg: RecSysConfig, seed: int = 0, device=None) -> dict:
    """The kind's weights drawn on ``device``'s own generator seeded with
    ``seed`` (one seed gives other weights on the card than on the CPU).
    An unknown kind raises ``KeyError``, as the reference's dispatch does."""
    init = _INIT[_kind(cfg)]
    dev = resolve_device(device)
    return init(cfg, _generator(seed, dev), dev)


def _ids(g, high: int, shape, dev) -> torch.Tensor:
    return torch.randint(0, high, shape, generator=g, device=dev, dtype=torch.int32)


def recsys_inputs(cfg: RecSysConfig, batch: int, seed: int = 1, device=None) -> dict:
    """A batch of serving contexts (the reference's ``_recsys_inputs`` with
    ``train=False``) from a generator seeded with ``seed``.  DLRM:
    ``dense`` (B, n_dense) fp32 standard normal, ``sparse`` (B, n_sparse)
    int32 raw ids in [0, 2^31).  The sequence models: ``history`` (B,
    seq_len) int32 item ids in [0, n_items), and for BST and BERT4Rec a
    ``target`` (B,) item."""
    kind = _kind(cfg)
    dev = resolve_device(device)
    g = _generator(seed, dev)
    if kind == "dlrm":
        return {"dense": torch.randn((batch, cfg.n_dense), generator=g, device=dev),
                "sparse": torch.randint(0, 2 ** 31, (batch, cfg.n_sparse), generator=g,
                                        device=dev, dtype=torch.int32)}
    out = {"history": _ids(g, cfg.n_items, (batch, cfg.seq_len), dev)}
    if kind in ("bst", "bert4rec"):
        out["target"] = _ids(g, cfg.n_items, (batch,), dev)
    return out


def recsys_train_inputs(cfg: RecSysConfig, batch: int, seed: int = 1, device=None) -> dict:
    """A training batch (the reference's ``_recsys_inputs`` with
    ``train=True``): :func:`recsys_inputs` plus, from a second generator
    seeded with ``seed + 1000``, ``labels`` (B,) fp32 in {0, 1} for DLRM
    and BST, ``target`` (B,) for MIND and ``neg_ids`` (B, 64) its sampled
    negatives.  BERT4Rec gets ``neg``, its loss's 512 negatives a row drawn
    once for the whole batch (``bert4rec.negatives``): a microbatched step
    slices them with the batch, so its loss is the reference's."""
    dev = resolve_device(device)
    out = recsys_inputs(cfg, batch, seed, dev)
    g = _generator(seed + 1000, dev)
    if cfg.kind in ("dlrm", "bst"):
        out["labels"] = torch.randint(0, 2, (batch,), generator=g, device=dev).to(torch.float32)
    elif cfg.kind == "bert4rec":
        out["neg"] = bert4rec.negatives(batch, cfg, device=dev)
    else:
        out["target"] = _ids(g, cfg.n_items, (batch,), dev)
        out["neg_ids"] = _ids(g, cfg.n_items, (batch, MIND_NEGATIVES), dev)
    return out


def recsys_flops(cfg: RecSysConfig, batch: int) -> float:
    """Analytic forward FLOPs of ``batch`` rows, the reference's
    ``_recsys_flops``.  DLRM: MLPs plus the (F+1)^2 x dim dot interaction.
    The sequence models: attention and FFN over L = seq_len positions, the
    FFN at ``mlp_dims[0]`` wide (BST: 1,024, though its FFN is 4d = 128
    wide over L + 1 = 21 positions, so the formula overstates a BST forward
    about 1.7x: 5.5 against 3.3 MFLOP a row), plus BST's head MLP or a
    d x d head (MIND's retrieval over N items is not counted here)."""
    if _kind(cfg) == "dlrm":
        mlp = sum(a * b for a, b in zip(cfg.bot_mlp[:-1], cfg.bot_mlp[1:]))
        n = cfg.n_sparse + 1
        mlp += (n * (n - 1) // 2 + cfg.bot_mlp[-1]) * cfg.top_mlp[1]
        mlp += sum(a * b for a, b in zip(cfg.top_mlp[1:-1], cfg.top_mlp[2:]))
        inter = n * n * cfg.embed_dim
        return 2.0 * batch * (mlp + inter)
    d, L = cfg.embed_dim, cfg.seq_len
    attn = cfg.n_blocks * (4 * L * d * d + 2 * L * L * d)
    ffn = cfg.n_blocks * 2 * L * d * (cfg.mlp_dims[0] if cfg.mlp_dims else 4 * d)
    if cfg.kind == "bst":
        widths = (d * (L + 1),) + tuple(cfg.mlp_dims) + (1,)
        head = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    else:
        head = d * d
    return 2.0 * batch * (attn + ffn + head)


def serve_row_bytes(cfg: RecSysConfig) -> int:
    """Bytes of temporaries one served row (or one scored pair) holds at the
    peak of a forward, an upper estimate from the shapes: a block's fp32
    attention logits twice (the scaled and the masked copy), its hidden
    states and FFN activations a few times over; MIND's scores of one item
    tile for every interest, their max and the merge's operands.  0 for
    DLRM (its rows are never chunked)."""
    if cfg.kind == "dlrm":
        return 0
    if cfg.kind == "mind":
        t = min(mind.ITEM_TILE, embedding.padded_rows(cfg.n_items))
        return 4 * t * (cfg.n_interests + 4) + 16 * (t + 100)
    pos, d = cfg.seq_len + 1, cfg.embed_dim
    ffn = cfg.mlp_dims[0] if cfg.kind == "bert4rec" else 4 * d
    head = 2 * sum(cfg.mlp_dims) if cfg.kind == "bst" else 0
    return 4 * (2 * cfg.n_heads * pos * pos + pos * (8 * d + 3 * ffn) + head)


def serve_chunk_rows(cfg: RecSysConfig, device) -> Optional[int]:
    """The rows a serve chunk takes: the largest power of two whose
    :func:`serve_row_bytes` fit in ``MEM_SHARE`` of the card's memory;
    None (no chunking) on the CPU and for DLRM.  Rows are independent, so
    chunking changes no result."""
    per_row = serve_row_bytes(cfg)
    dev = torch.device(device)
    if dev.type != "cuda" or not per_row:
        return None
    total = torch.cuda.get_device_properties(dev).total_memory
    return 1 << max(0, int(MEM_SHARE * total // per_row).bit_length() - 1)


def _in_chunks(fn: Callable, batch: dict, rows: Optional[int]):
    """``fn(batch)`` over row chunks of ``rows`` (every leaf sliced alike),
    the outputs (a tensor or a tuple of tensors) concatenated."""
    b = leaves(batch)[0].shape[0]
    if rows is None or rows >= b:
        return fn(batch)
    outs = [fn({k: v[i:i + rows] for k, v in batch.items()}) for i in range(0, b, rows)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def score_fn(cfg: RecSysConfig) -> Callable:
    """``sf(params, query, idx) -> (B, K)`` exact scores of a query batch
    (``query`` a dict of the kind's context tensors) against item ids
    ``idx`` (B, K): the kind's ``score_candidates``.  MIND is a
    dual-encoder, not ADACUR's scorer: it raises ``ValueError``."""
    if cfg.kind == "dlrm":
        return lambda p, q, idx: dlrm.score_candidates(p, q["dense"], q["sparse"], idx, cfg)
    if cfg.kind == "bst":
        return lambda p, q, idx: bst.score_candidates(p, q["history"], idx, cfg)
    if cfg.kind == "bert4rec":
        return lambda p, q, idx: bert4rec.score_candidates(p, q["history"], idx, cfg)
    raise ValueError(f"{cfg.name}: a {_kind(cfg)} model is not a cross-encoder-class scorer")


def anchor_scores(params, cfg: RecSysConfig, contexts: dict, n_items: int) -> torch.Tensor:
    """The offline R_anc (k_q, padded_rows(n_items)) fp32: exact scores of
    each anchor context (``contexts``, a dict of the kind's context
    tensors) against items 0..n_items-1, in forwards of about
    ``PAIRS_PER_CALL`` pairs (fewer on the card where a pair's temporaries
    are large); padded columns are 0 (the search never samples them)."""
    sf = score_fn(cfg)
    first = leaves(contexts)[0]
    k_q, dev = first.shape[0], first.device
    out = torch.zeros((k_q, embedding.padded_rows(n_items)), dtype=torch.float32, device=dev)
    pairs = min(PAIRS_PER_CALL, serve_chunk_rows(cfg, dev) or PAIRS_PER_CALL)
    cols = min(n_items, pairs)
    rows = max(1, pairs // cols)
    with torch.no_grad():
        for r0 in range(0, k_q, rows):
            r1 = min(k_q, r0 + rows)
            q = {k: v[r0:r1] for k, v in contexts.items()}
            for c0 in range(0, n_items, cols):
                c1 = min(n_items, c0 + cols)
                items = torch.arange(c0, c1, dtype=torch.int32, device=dev).expand(r1 - r0, -1)
                out[r0:r1, c0:c1] = sf(params, q, items)
    return out


def _recsys_forward(cfg: RecSysConfig) -> Callable:
    """``fwd(params, batch)``: the serve step's function of one chunk."""
    if cfg.kind == "dlrm":
        return lambda p, b: dlrm.forward(p, b["dense"], b["sparse"], cfg)
    if cfg.kind == "bst":
        return lambda p, b: bst.forward(p, b["history"], b["target"], cfg)
    if cfg.kind == "bert4rec":
        return lambda p, b: bert4rec.score_candidates(p, b["history"], b["target"][:, None],
                                                      cfg)[:, 0]
    if _kind(cfg) == "mind":
        return lambda p, b: mind.retrieve(p, b["history"], 100, cfg)


def build_recsys_serve(arch_id: str, cfg: RecSysConfig, shape: RecSysShape, *,
                       params=None, seed: int = 0, device=None) -> StepBundle:
    """``step(params, batch)``: DLRM and BST (B,) logits, BERT4Rec (B,)
    scores of each context's target, MIND (values (B, 100), ids (B, 100))
    of its retrieval over every item, for ``shape.batch`` seeded contexts,
    in chunks of :func:`serve_chunk_rows` rows run one after the other."""
    fwd = _recsys_forward(cfg)
    params = recsys_init(cfg, seed, device) if params is None else params
    dev = _device_of(params)
    rows = serve_chunk_rows(cfg, dev)

    @torch.no_grad()
    def step(params, batch):
        return _in_chunks(lambda b: fwd(params, b), batch, rows)

    batch = recsys_inputs(cfg, shape.batch, seed + 1, dev)
    return StepBundle(f"{arch_id}:{shape.name}", step, (params, batch),
                      recsys_flops(cfg, shape.batch))


def build_recsys_retrieval(arch_id: str, cfg: RecSysConfig, shape: RecSysShape, *,
                           params=None, r_anc=None, seed: int = 0,
                           device=None) -> StepBundle:
    """The paper's technique at scale: ``step(params, batch, key) ->
    (topk_idx, topk_scores)``, ADACUR over ``shape.n_candidates`` items
    (the candidate axis padded by ``embedding.padded_rows``) with DLRM, BST
    or BERT4Rec as the exact scorer, ``RETRIEVAL_CFG``'s budget of 500 CE
    calls per context.

    ``r_anc`` defaults to :func:`anchor_scores` of ``K_Q`` seeded anchor
    contexts (other contexts than the served ones): K_Q x n_candidates
    exact calls (about 3 x 10^16 FLOP for BERT4Rec at 10^6 candidates, so
    pass one in there).  A sequence model's candidates are the first
    n_candidates rows of its catalogue (at most ``n_items``).  ``stats``
    counts the CE calls of every step.

    MIND (a dual-encoder) runs its native retrieval instead, as the
    reference does: ``step(params, batch) -> (values, ids)``, its top 100
    over every item (``mind.retrieve``)."""
    params = recsys_init(cfg, seed, device) if params is None else params
    dev = _device_of(params)
    n_cand, b = shape.n_candidates, shape.batch
    name = f"{arch_id}:{shape.name}"
    if cfg.kind == "mind":
        @torch.no_grad()
        def mind_step(params, batch):
            return mind.retrieve(params, batch["history"], 100, cfg)

        return StepBundle(name, mind_step, (params, recsys_inputs(cfg, b, seed + 1, dev)),
                          2.0 * b * cfg.n_interests * cfg.embed_dim * n_cand)
    sf = score_fn(cfg)
    if cfg.kind != "dlrm":    # a sequence model's candidates are rows of its item table
        n_cand = min(n_cand, cfg.n_items)
    if r_anc is None:
        anchors = recsys_inputs(cfg, K_Q, seed + 2, dev)
        r_anc = anchor_scores(params, cfg, anchors, n_cand)
    stats = ScorerStats()

    @torch.no_grad()
    def step(params, batch, key):
        def counted(q, idx):
            stats.requests += 1
            stats.pairs += idx.numel()
            stats.ce_calls += idx.numel()
            return sf(params, q, idx)

        query = {k: v for k, v in batch.items() if k not in ("r_anc", "target")}
        res = adacur.adacur_search(counted, batch["r_anc"], query, RETRIEVAL_CFG, key,
                                   batch=b, n_valid_items=n_cand)
        return res.topk_idx, res.topk_scores

    ctx = recsys_inputs(cfg, b, seed + 1, dev)
    ctx.pop("target", None)
    acfg = RETRIEVAL_CFG
    # dominant: n_rounds passes of e_q @ R_anc plus budget_ce exact scores
    flops = (2.0 * b * r_anc.shape[0] * n_cand * acfg.n_rounds
             + recsys_flops(cfg, acfg.budget_ce))
    return StepBundle(name, step, (params, dict(ctx, r_anc=r_anc), prng.PRNGKey(seed)),
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


def _recsys_loss(cfg: RecSysConfig) -> Callable:
    if cfg.kind == "dlrm":
        return lambda p, b: dlrm.bce_loss(p, b["dense"], b["sparse"], b["labels"], cfg)
    if cfg.kind == "bst":
        return lambda p, b: bst.bce_loss(p, b["history"], b["target"], b["labels"], cfg)
    if cfg.kind == "bert4rec":
        return lambda p, b: bert4rec.mlm_loss(p, b["history"], b["target"], cfg, neg=b["neg"])
    if _kind(cfg) == "mind":
        return lambda p, b: mind.sampled_softmax_loss(p, b["history"], b["target"],
                                                      b["neg_ids"], cfg)


def build_recsys_train(arch_id: str, cfg: RecSysConfig, shape: RecSysShape, *,
                       params=None, n_micro: int = 1, seed: int = 0,
                       device=None, mesh=None, batch=None) -> StepBundle:
    """``step(params, opt_state, batch)``: one train step at ``shape.batch``
    (the kind's loss, its gradient, AdamW with lr 1e-3 and no weight decay,
    as the reference), the gradient the mean over ``n_micro`` microbatches
    (a divisor of the batch) when the whole batch's activations do not fit.
    ``args`` = (params requiring grad, a fresh AdamW state, ``batch`` or a
    seeded one from :func:`recsys_train_inputs`); ``model_flops`` = 3 x the
    forward's (forward + backward)."""
    if shape.batch % n_micro:
        raise ValueError(f"batch {shape.batch} does not split into {n_micro} microbatches")
    opt_cfg = optimizer.AdamWConfig(lr=1e-3, weight_decay=0.0)
    if mesh is not None:
        if _kind(cfg) != "dlrm" or n_micro != 1:
            raise NotImplementedError(
                f"{cfg.kind} training over a mesh (and microbatches over one) is not "
                "ported yet: ROADMAP.md, queue 1, item 2c")
        return _build_dlrm_train_mesh(arch_id, cfg, shape, params, seed, device, mesh, opt_cfg,
                                      batch)
    loss_fn = _recsys_loss(cfg)
    params = recsys_init(cfg, seed, device) if params is None else params
    require_grad(params)
    dev = _device_of(params)
    batch = recsys_train_inputs(cfg, shape.batch, seed + 1, dev) if batch is None else batch
    return StepBundle(f"{arch_id}:{shape.name}", train_step(loss_fn, opt_cfg, n_micro),
                      (params, optimizer.init_adamw(params), batch),
                      3.0 * recsys_flops(cfg, shape.batch))


def batch_shard(batch: dict, mesh) -> dict:
    """This rank's rows of a batch split over the mesh's batch axes."""
    b, n_b = _flat_index(mesh, sharding.batch_axes(mesh))
    rows = next(iter(batch.values())).shape[0]
    if rows % n_b:
        raise ValueError(f"a batch of {rows} does not split over {n_b} batch shards")
    rl = rows // n_b
    return {k: v[b * rl:(b + 1) * rl] for k, v in batch.items()}


def _build_dlrm_train_mesh(arch_id, cfg, shape, params, seed, device, mesh,
                           opt_cfg, batch=None) -> StepBundle:
    dev = resolve_device(device)
    sharding.check_mesh_device(mesh, dev)
    specs = dlrm.param_specs(cfg)
    if params is None:
        pieces, shardings = init_pieces(
            lambda place: dlrm.init_dlrm(cfg, _generator(seed, dev), dev, place=place),
            specs, mesh)
    else:
        pieces, shardings = shard_params(params, specs, mesh)
    batch = batch_shard(recsys_train_inputs(cfg, shape.batch, seed + 1, dev)
                        if batch is None else batch, mesh)

    def lookup(tables, ids):
        return embedding.lookup_row_sharded(tables, shardings["tables"], ids, mesh)

    def loss_fn(p, b):
        whole = {"bot": gather_params(p["bot"], shardings["bot"]),
                 "top": gather_params(p["top"], shardings["top"]), "tables": p["tables"]}
        return dlrm.bce_loss(whole, b["dense"], b["sparse"], b["labels"], cfg, lookup=lookup)

    step = fsdp.sharded_adamw_step(loss_fn, opt_cfg, shardings, mesh)
    return StepBundle(f"{arch_id}:{shape.name}", step,
                      (pieces, optimizer.init_adamw(pieces), batch),
                      3.0 * recsys_flops(cfg, shape.batch), shardings=shardings)


def _chunked_nll(params, h: torch.Tensor, targets: torch.Tensor, cfg: LMConfig,
                 chunk: int = 512, tp=None) -> torch.Tensor:
    """Mean next-token NLL over sequence chunks: each chunk's (B, chunk, V)
    logits are recomputed in the backward (``torch.utils.checkpoint``, the
    reference's ``jax.checkpoint``), so the full logits never live at once;
    the chunk sums add in sequence order.

    With ``tp`` (over a mesh: ``params`` this rank's pieces, ``h`` in the
    residual's layout, ``targets`` the data shard's) a vocab piece's
    logits give each position's max, sum of exponentials and target
    logit, which meet over ``model`` (the reference's vocab-sharded loss
    region, ``repro/launch/steps.py:101-132``): the whole sequence's NLL on every model
    rank, no rank holding more than its vocab piece's logits.  A vocab
    whole over ``model`` scores the rank's sequence chunk and the sums
    meet over ``model``.  Every model rank returns its data shard's
    mean."""
    from torch.utils.checkpoint import checkpoint

    b, l = targets.shape
    tp = transformer.ONE_RANK if tp is None else dataclasses.replace(
        tp, seq=tp.n > 1 and l % tp.n == 0)
    head = transformer.lm_head(params, cfg, tp)
    width = head.shape[-1]
    split = width != transformer.padded_vocab(cfg)
    if split:
        h = tp.expand(h)
    else:
        targets = tp.chunk(targets)
    lc = h.shape[1]
    chunk = min(chunk, lc)
    if lc % chunk:
        raise ValueError(f"sequence length {lc} is not a multiple of the loss chunk {chunk}")
    lo = tp.heads(transformer.padded_vocab(cfg), width).start

    def one(hc, tc):
        logits = transformer.head_logits(head, hc, cfg, tp).float()
        if not split:
            logp = torch.log_softmax(logits, dim=-1)
            return -torch.gather(logp, -1, tc[..., None].long()).sum()
        m = fsdp.all_reduce_max(logits.amax(-1), tp.group)
        t = tc.long() - lo
        mine = (t >= 0) & (t < width)
        tl = torch.gather(logits, -1, t.clamp(0, width - 1)[..., None])[..., 0]
        stats = fsdp.all_reduce(torch.stack([torch.exp(logits - m[..., None]).sum(-1),
                                             torch.where(mine, tl, 0.0)]), tp.group)
        return (torch.log(stats[0]) + m - stats[1]).sum()

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(lc // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + checkpoint(one, h[:, sl], targets[:, sl], use_reentrant=False)
    if not split and tp.seq:
        total = fsdp.all_reduce(total.reshape(1), tp.group)[0]
    return total / (b * l)


def _lm_loss_fn(cfg: LMConfig, moe_fn=None, tp=None):
    """Next-token NLL, plus ``aux_loss_coef`` x the MoE layers' summed
    load-balance loss for a MoE config (the reference's ``_lm_loss_fn``);
    over a mesh with the expert-parallel ``moe_fn`` and this rank's
    :class:`transformer.TensorParallel`."""
    def loss_fn(params, batch):
        h, aux = transformer.encode(params, batch["tokens"], cfg, moe_fn=moe_fn, tp=tp)
        loss = _chunked_nll(params, h, batch["targets"], cfg, tp=tp)
        if cfg.moe is not None:
            loss = loss + cfg.moe.aux_loss_coef * aux
        return loss

    return loss_fn


def lm_tokens(cfg: LMConfig, shape: tuple, seed: int, device, low: int = 4) -> torch.Tensor:
    """int32 tokens of ``shape`` drawn in [low, vocab) from a seeded
    generator on ``device``."""
    return torch.randint(low, cfg.vocab_size, tuple(shape), generator=_generator(seed, device),
                         device=device, dtype=torch.int32)


def lm_train_inputs(cfg: LMConfig, batch: int, seq_len: int, seed: int = 1,
                    device=None) -> dict:
    """``tokens`` (B, L) int32 drawn in [4, vocab) from a seeded generator
    and ``targets`` the next token (the sequence shifted by one, wrapping)."""
    tokens = lm_tokens(cfg, (batch, seq_len), seed, resolve_device(device))
    return {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}


FSDP_MIN_PARAMS = 2e9      # below it the train step keeps ``embed`` whole (the reference's rule)
MICRO_MIN_PARAMS = 4e10    # above it the train step takes 4 microbatches (ditto)


def lm_train_rules(cfg: LMConfig, use_fsdp: Optional[bool] = None) -> Optional[dict]:
    """The LM train step's sharding rules: the reference's defaults (FSDP
    over ``data``, TP and EP over ``model``), with ``embed`` whole (tensor
    parallel only) for a config of fewer than 2e9 parameters by its
    ``n_params()``, as the reference reads it; ``use_fsdp`` overrides the
    rule either way."""
    if use_fsdp is None:
        use_fsdp = cfg.n_params() >= FSDP_MIN_PARAMS
    return None if use_fsdp else dict(sharding.DEFAULT_RULES, embed=(None,))


def _lm_pieces(cfg: LMConfig, params, seed: int, dev, mesh, rules=None, grad: bool = True):
    """This rank's pieces of an LM's parameters and their shardings:
    ``params`` cut, or drawn from ``seed`` piece by piece."""
    specs = transformer.param_specs(cfg)
    if params is None:
        pieces, shardings = init_pieces(
            lambda place: transformer.init_lm(cfg, _generator(seed, dev), place), specs, mesh,
            rules)
    else:
        pieces, shardings = shard_params(params, specs, mesh, rules)
    if not grad:
        for p in leaves(pieces):
            p.requires_grad_(False)
    return pieces, shardings


def _lm_moe_fn(cfg: LMConfig, mesh, batch_axes, dev, scatter_tokens: bool = False):
    if cfg.moe is None or "model" not in sharding.mesh_dims(mesh):
        return None
    return moe_lib.make_moe_fn(mesh, cfg.moe, batch_axes, scatter_tokens=scatter_tokens,
                               device=dev)


def build_lm_train(arch_id: str, cfg: LMConfig, shape: LMShape, *, params=None,
                   global_batch: Optional[int] = None, n_micro: Optional[int] = None,
                   seed: int = 0, device=None, mesh=None, batch=None,
                   use_fsdp: Optional[bool] = None) -> StepBundle:
    """``step(params, opt_state, batch)``: one LM train step (chunked NLL,
    its gradient, AdamW at the reference's defaults), each layer
    recomputed in the backward when ``cfg.remat`` (the default).
    ``global_batch`` cuts the shape's batch to what one card holds;
    ``n_micro`` defaults to the reference's rule (4 microbatches above
    4e10 parameters).  ``model_flops`` = 6 x active parameters x tokens.

    With ``mesh`` (a ``("data", "model")`` or ``("pod", "data", "model")``
    mesh over this process's world) the step is the reference's over it:
    ``args`` are this rank's pieces of the parameters (drawn from ``seed``
    piece by piece, or cut from ``params``) and AdamW state under
    ``tree_specs`` by :func:`lm_train_rules` (``use_fsdp`` overrides the
    2e9 rule), and its data shard of the batch (``batch``, whole, or a
    seeded one); the forward is the tensor-parallel one
    (``transformer.TensorParallel``), the MoE expert-parallel with its
    combine reduce-scattered into the residual's chunks where the residual
    is split by sequence (the sequence divides ``model``; else
    all-reduced: the reference's rule, B_local x L dividing ``model``,
    also scatters where its own residual stays whole and GSPMD gathers it
    back), the loss vocab-parallel.  Each rank's ``n_micro``
    microbatches accumulate before one gradient sync
    (``fsdp.sharded_adamw_step``)."""
    dev = resolve_device(device)
    b = shape.global_batch if global_batch is None else global_batch
    if n_micro is None:
        n_micro = 4 if cfg.n_params() > MICRO_MIN_PARAMS else 1
    if mesh is not None:
        return _build_lm_train_mesh(arch_id, cfg, shape, params, b, n_micro, seed, dev, mesh,
                                    batch, use_fsdp)
    if b % n_micro:
        raise ValueError(f"global batch {b} does not split into {n_micro} microbatches")
    params = transformer.init_lm(cfg, _generator(seed, dev)) if params is None else params
    require_grad(params)
    batch = lm_train_inputs(cfg, b, shape.seq_len, seed + 1, dev) if batch is None else batch
    step = train_step(_lm_loss_fn(cfg), optimizer.AdamWConfig(), n_micro)
    return StepBundle(f"{arch_id}:{shape.name}", step,
                      (params, optimizer.init_adamw(params), batch),
                      6.0 * cfg.n_active_params() * b * shape.seq_len)


def _build_lm_train_mesh(arch_id, cfg, shape, params, b, n_micro, seed, dev, mesh, batch,
                         use_fsdp) -> StepBundle:
    sharding.check_mesh_device(mesh, dev)
    _, n_b = _flat_index(mesh, sharding.batch_axes(mesh))
    if b % (n_b * n_micro):
        raise ValueError(f"global batch {b} does not split into {n_b} batch shards of "
                         f"{n_micro} microbatches")
    pieces, shardings = _lm_pieces(cfg, params, seed, dev, mesh, lm_train_rules(cfg, use_fsdp))
    batch = batch_shard(lm_train_inputs(cfg, b, shape.seq_len, seed + 1, dev)
                        if batch is None else batch, mesh)
    tp = transformer.tensor_parallel(mesh, shardings)
    moe_fn = _lm_moe_fn(cfg, mesh, sharding.batch_axes(mesh), dev,
                        tp.n > 1 and shape.seq_len % tp.n == 0)
    step = fsdp.sharded_adamw_step(_lm_loss_fn(cfg, moe_fn, tp), optimizer.AdamWConfig(),
                                   shardings, mesh, n_micro)
    return StepBundle(f"{arch_id}:{shape.name}", step,
                      (pieces, optimizer.init_adamw(pieces), batch),
                      6.0 * cfg.n_active_params() * b * shape.seq_len, shardings=shardings)


# ---------------------------------------------------------------------------
# GNN family (NequIP)
# ---------------------------------------------------------------------------

GNN_BIG_NODES = 100_000       # above this, edge chunks and remat (the reference's rule)
MINIBATCH_PAD = 196608        # the padded fanout subgraph's nodes and edges


def gnn_init(cfg: GNNConfig, shape: GraphShape, seed: int = 0, device=None) -> dict:
    """NequIP's weights for ``shape`` (a ``d_feat`` projection or the species
    embedding) drawn on ``device``'s generator seeded with ``seed``."""
    dev = resolve_device(device)
    return nequip.init_nequip(cfg, _generator(seed, dev), shape.d_feat, dev)


def _pad512(n: int) -> int:
    return (n + 511) // 512 * 512


def gnn_sizes(shape: GraphShape) -> tuple:
    """(nodes, edges, n_graphs) of a batch, padded to multiples of 512 as
    the reference's ``_gnn_batch`` pads them."""
    if shape.kind == "molecule":
        g = shape.batch_graphs
        n, e, n_graphs = g * shape.n_nodes, g * shape.n_edges, g
    elif shape.kind == "minibatch":
        n = e = MINIBATCH_PAD
        n_graphs = 1
    else:
        n, e, n_graphs = shape.n_nodes, shape.n_edges, 1
    return _pad512(n), _pad512(e), n_graphs


def gnn_graph(shape: GraphShape, seed: int, device=None):
    """(senders, receivers) int32 of the whole graph behind a full or
    minibatch shape: ``random_graph``'s law (Pareto(2) + 1 senders,
    uniform receivers) drawn on ``device``'s generator."""
    dev = resolve_device(device)
    return sampler.random_graph_device(shape.n_nodes, shape.n_edges, _generator(seed, dev))


def gnn_sample(shape: GraphShape, senders, receivers, seed: int,
               seconds: Optional[dict] = None) -> sampler.SampledSubgraph:
    """One padded fanout subgraph of a minibatch shape: the CSR built on the
    edges' device (``csr_from_edge_index``), copied to the host, sampled there
    by the numpy ``sample_subgraph`` from ``default_rng(seed)``'s seeds.
    ``seconds`` gets each stage's host seconds (``csr``, ``copy``, ``sample``)."""
    seconds = {} if seconds is None else seconds
    t0 = time.perf_counter()
    indptr, indices = sampler.csr_from_edge_index(senders, receivers, shape.n_nodes)
    indptr[-1].item()                     # waits for the CSR
    t1 = time.perf_counter()
    graph = sampler.to_host_csr(indptr, indices, shape.n_nodes)
    t2 = time.perf_counter()
    rng = np.random.default_rng(seed)
    seeds = rng.choice(shape.n_nodes, size=shape.batch_nodes, replace=False)
    sub = sampler.sample_subgraph(graph, seeds, shape.fanout, MINIBATCH_PAD, MINIBATCH_PAD, rng)
    seconds.update(csr=t1 - t0, copy=t2 - t1, sample=time.perf_counter() - t2)
    return sub


def gnn_inputs(cfg: GNNConfig, shape: GraphShape, seed: int = 1, device=None,
               graph=None, mesh=None, receiver_partitioned: bool = False) -> dict:
    """A concrete batch in ``_gnn_batch``'s layout: nodes and edges padded
    to multiples of 512 (padded edges 0 -> 0 with ``edge_mask`` 0, padded
    nodes ``node_mask`` 0), standard-normal positions (most edges then lie
    within the cutoff), a seeded ``energy`` target a graph, and ``node_attr``
    species ids or standard-normal features (``d_feat``).  A molecule batch
    draws ``n_edges`` edges inside each of its graphs and carries
    ``graph_ids``; a full shape uses ``graph`` ((senders, receivers)) or
    :func:`gnn_graph`'s; a minibatch shape uses ``graph`` when it is a
    ``SampledSubgraph``, else one :func:`gnn_sample` of ``graph`` (or of
    :func:`gnn_graph`'s).

    With ``mesh``, this rank's piece of that batch (every rank draws the
    same one), laid out as the reference's ``_gnn_batch`` places it: the
    nodes (``positions``, ``node_attr``, ``node_mask``, ``graph_ids``)
    sharded over ``data``, the graphs' ``energy`` over the batch axes where
    they divide (else whole), and the edges spread over every axis, or with
    ``receiver_partitioned`` (the sharded interact's contract) sharded over
    ``data`` by their receiver's node shard.  A real graph's receivers do
    not fall evenly into node shards, so there each shard's edge block
    keeps only its real edges (``edge_mask`` 1, in their order) and is
    padded to the largest block with edges (0 -> the shard's first node,
    ``edge_mask`` 0)."""
    if mesh is not None:
        whole = gnn_inputs(cfg, shape, seed, device, graph)
        return _gnn_piece(whole, shape, mesh, receiver_partitioned)
    dev = resolve_device(device)
    n, e, n_graphs = gnn_sizes(shape)
    g = _generator(seed, dev)
    senders = torch.zeros(e, dtype=torch.int32, device=dev)
    receivers = torch.zeros(e, dtype=torch.int32, device=dev)
    edge_mask = torch.zeros(e, dtype=torch.float32, device=dev)
    node_mask = torch.zeros(n, dtype=torch.float32, device=dev)
    batch = {}
    if shape.kind == "molecule":
        nb, eb = shape.batch_graphs, shape.batch_graphs * shape.n_edges
        base = torch.arange(nb, device=dev).repeat_interleave(shape.n_edges) * shape.n_nodes
        senders[:eb] = (torch.randint(0, shape.n_nodes, (eb,), generator=g, device=dev)
                        + base).to(torch.int32)
        receivers[:eb] = (torch.randint(0, shape.n_nodes, (eb,), generator=g, device=dev)
                          + base).to(torch.int32)
        real_n, real_e = nb * shape.n_nodes, eb
        ids = torch.zeros(n, dtype=torch.int32, device=dev)
        ids[:real_n] = torch.arange(real_n, device=dev).div(shape.n_nodes,
                                                            rounding_mode="floor").to(torch.int32)
        batch["graph_ids"] = ids
    elif shape.kind == "minibatch":
        sub = graph
        if not isinstance(sub, sampler.SampledSubgraph):
            sub = gnn_sample(shape, *(graph or gnn_graph(shape, seed, dev)), seed)
        senders.copy_(torch.from_numpy(sub.senders))
        receivers.copy_(torch.from_numpy(sub.receivers))
        edge_mask.copy_(torch.from_numpy(sub.edge_mask.astype(np.float32)))
        node_mask.copy_(torch.from_numpy(sub.node_mask.astype(np.float32)))
        real_n = real_e = None
    else:
        gs, gr = graph if graph is not None else gnn_graph(shape, seed, dev)
        real_n, real_e = shape.n_nodes, shape.n_edges
        senders[:real_e], receivers[:real_e] = gs, gr
    if real_n is not None:
        node_mask[:real_n] = 1.0
        edge_mask[:real_e] = 1.0
    batch["positions"] = torch.randn((n, 3), generator=g, device=dev)
    if shape.d_feat:
        batch["node_attr"] = torch.randn((n, shape.d_feat), generator=g, device=dev)
    else:
        batch["node_attr"] = torch.randint(0, cfg.n_species, (n,), generator=g, device=dev,
                                           dtype=torch.int32)
    batch.update(senders=senders, receivers=receivers, edge_mask=edge_mask,
                 node_mask=node_mask,
                 energy=torch.randn((n_graphs,), generator=g, device=dev))
    return batch


def _flat_index(mesh, axes) -> tuple:
    """(this rank's row-major index over mesh dimensions ``axes``, their
    product)."""
    sh = sharding.Sharding(mesh, (tuple(axes),))
    return sh.index(0), sh.parts(0)


def _gnn_piece(whole: dict, shape: GraphShape, mesh, receiver_partitioned: bool) -> dict:
    """This rank's piece of a whole GNN batch (:func:`gnn_inputs`)."""
    d, n_d = _flat_index(mesh, ("data",))
    n = whole["positions"].shape[0]
    if n % n_d:
        raise ValueError(f"{n} nodes do not split over {n_d} data shards")
    n_l = n // n_d
    out = {k: whole[k][d * n_l:(d + 1) * n_l]
           for k in ("positions", "node_attr", "node_mask", "graph_ids") if k in whole}
    s, r, m = whole["senders"], whole["receivers"], whole["edge_mask"]
    if receiver_partitioned:
        real = m != 0
        shard = torch.div(r.long(), n_l, rounding_mode="floor")
        counts = torch.bincount(shard[real], minlength=n_d)
        width = int(counts.max())
        keep = (real & (shard == d)).nonzero().squeeze(1)
        pad = width - keep.numel()
        fill = lambda x, v: torch.cat([x[keep], torch.full((pad,), v, dtype=x.dtype,  # noqa: E731
                                                           device=x.device)])
        out.update(senders=fill(s, 0), receivers=fill(r, d * n_l), edge_mask=fill(m, 0))
    else:
        i, n_all = _flat_index(mesh, mesh.mesh_dim_names)
        e_l = s.shape[0] // n_all
        out.update({k: whole[k][i * e_l:(i + 1) * e_l]
                    for k in ("senders", "receivers", "edge_mask")})
    b, n_b = _flat_index(mesh, sharding.batch_axes(mesh))
    g = whole["energy"].shape[0]
    out["energy"] = whole["energy"][b * (g // n_b):(b + 1) * (g // n_b)] if g % n_b == 0 \
        else whole["energy"]
    return out


def gnn_flops(cfg: GNNConfig, n_edges: int) -> float:
    """The reference's ``model_flops``: ~(paths x irrep_dim x h) MACs an edge."""
    return 2.0 * n_edges * 11 * 9 * cfg.d_hidden * cfg.n_layers


def build_gnn_train(arch_id: str, cfg: GNNConfig, shape: GraphShape, *, params=None,
                    batch=None, seed: int = 0, device=None, mesh=None,
                    sharded_interact: Optional[bool] = None) -> StepBundle:
    """``step(params, opt_state, batch)``: one NequIP train step (the
    per-graph energy MSE, its gradient and AdamW with lr 1e-3, as the
    reference).  A graph above 100,000 nodes runs in edge chunks of
    ``nequip.EDGE_CHUNK`` with each interaction block recomputed in the
    backward.  ``args`` = (params requiring grad, a fresh AdamW state,
    ``batch`` or :func:`gnn_inputs`'s); ``model_flops`` is the
    reference's.

    With ``mesh`` (a ``("data", "model")`` or ``("pod", "data", "model")``
    mesh over this process's world) the step is the reference's over that
    mesh: ``args`` are this rank's pieces of the parameters and AdamW state
    (``param_specs`` under ``tree_specs``; the parameters drawn whole from
    the one-device init's seed, then cut), of the batch
    (:func:`gnn_inputs` with ``mesh``, or of ``batch``, a whole one) and
    the step runs on pieces (``distributed/fsdp.py``).  Above
    ``GNN_BIG_NODES`` nodes (the reference's rule; ``sharded_interact``
    forces either way) the edges are receiver-partitioned and every block
    runs ``nequip.make_sharded_interact`` in edge chunks, without remat, as
    the reference's; otherwise each step gathers the batch and runs the
    one-device loss on every rank."""
    dev = resolve_device(device)
    params = gnn_init(cfg, shape, seed, dev) if params is None else params
    _, e, n_graphs = gnn_sizes(shape)
    big = shape.n_nodes > GNN_BIG_NODES
    chunk = nequip.EDGE_CHUNK if big else None
    if mesh is not None:
        return _build_gnn_train_mesh(arch_id, cfg, shape, params, seed, dev, mesh,
                                     big if sharded_interact is None else sharded_interact,
                                     batch)
    require_grad(params)
    batch = gnn_inputs(cfg, shape, seed + 1, dev) if batch is None else batch

    def loss_fn(p, b):
        return nequip.energy_mse_loss(p, cfg, b, n_graphs=n_graphs, remat=big,
                                      edge_chunk=chunk)

    step = train_step(loss_fn, optimizer.AdamWConfig(lr=1e-3))
    return StepBundle(f"{arch_id}:{shape.name}", step,
                      (params, optimizer.init_adamw(params), batch), gnn_flops(cfg, e))


def shard_params(params, logical_specs, mesh, rules=None):
    """(this rank's pieces of ``params`` requiring grad, their shardings):
    ``logical_specs`` under ``tree_specs`` on ``mesh`` (the reference's
    ``DEFAULT_RULES``, or ``rules``)."""
    shardings = sharding.tree_shardings(mesh, params, logical_specs, rules)
    return require_grad(fsdp.shard_tree(params, shardings)), shardings


def init_pieces(init: Callable, logical_specs, mesh, rules=None):
    """(this rank's pieces requiring grad, their shardings) of the
    parameters ``init(place)`` draws, each leaf cut to its piece under
    ``tree_specs`` by the ``place(path, leaf)`` hook as it is drawn, so no
    rank keeps a whole leaf it does not hold.  The pieces equal
    :func:`shard_params`' of the same draws."""
    logical, placed = sharding.logical_by_path(logical_specs), {}

    def place(path, leaf):
        placed[path] = sharding.Sharding(
            mesh, sharding.spec_for(mesh, logical[path], tuple(leaf.shape), rules))
        return placed[path].local(leaf).contiguous().clone()

    pieces = init(place)
    shardings = unflatten_like(pieces, [placed[k] for k, _ in leaves_with_paths(pieces)])
    return require_grad(pieces), shardings


def gather_params(pieces, shardings):
    """The whole parameters from this rank's pieces, differentiable (each
    leaf all-gathered where it is sharded)."""
    return tree_map(fsdp.gather, pieces, shardings)


def _build_gnn_train_mesh(arch_id, cfg, shape, params, seed, dev, mesh, use_si,
                          batch) -> StepBundle:
    sharding.check_mesh_device(mesh, dev)
    _, e, n_graphs = gnn_sizes(shape)
    big = shape.n_nodes > GNN_BIG_NODES
    pieces, shardings = shard_params(params, nequip.param_specs(cfg, shape.d_feat), mesh)
    batch = (gnn_inputs(cfg, shape, seed + 1, dev, mesh=mesh, receiver_partitioned=use_si)
             if batch is None else _gnn_piece(batch, shape, mesh, use_si))
    batch_group = fsdp.mesh_group(mesh, sharding.batch_axes(mesh))
    whole_energy = batch["energy"].shape[0] != n_graphs

    def energy(b):
        return fsdp.all_gather(b["energy"], batch_group) if whole_energy else b["energy"]

    if use_si:
        si = nequip.make_sharded_interact(mesh, "data", "model" if "model" in
                                          sharding.mesh_dims(mesh) else None)

        def loss_fn(p, b):
            return nequip.energy_mse_loss(gather_params(p, shardings), cfg,
                                          {**b, "energy": energy(b)}, n_graphs=n_graphs,
                                          edge_chunk=nequip.EDGE_CHUNK, interact_fn=si)
    else:
        node_group = fsdp.mesh_group(mesh, ("data",))
        every = fsdp.mesh_group(mesh, mesh.mesh_dim_names)
        chunk = nequip.EDGE_CHUNK if big else None

        def loss_fn(p, b):
            whole = {k: fsdp.all_gather(v, every if k in ("senders", "receivers", "edge_mask")
                                        else node_group)
                     for k, v in b.items() if k != "energy"}
            whole["energy"] = energy(b)
            return nequip.energy_mse_loss(gather_params(p, shardings), cfg, whole,
                                          n_graphs=n_graphs, remat=big, edge_chunk=chunk)

    step = fsdp.sharded_adamw_step(loss_fn, optimizer.AdamWConfig(lr=1e-3), shardings, mesh)
    return StepBundle(f"{arch_id}:{shape.name}", step,
                      (pieces, optimizer.init_adamw(pieces), batch), gnn_flops(cfg, e),
                      shardings=shardings)


# ---------------------------------------------------------------------------
# LM serving: prefill, decode, and the paper's pipeline with an LM as CE
# ---------------------------------------------------------------------------


def _lm_params(cfg: LMConfig, params, seed: int, device):
    if params is not None:
        return params
    return transformer.init_lm(cfg, _generator(seed, resolve_device(device)))


def _lm_batch_axes(mesh, b: int) -> tuple:
    """The batch dimensions a batch of ``b`` rows splits over: every batch
    axis when they divide it, else none (the reference's ``_even``)."""
    bp = sharding.batch_axes(mesh)
    return bp if bp and b % sharding.axis_size(mesh, bp) == 0 else ()


def _rows(x: torch.Tensor, mesh, batch_axes) -> torch.Tensor:
    """This rank's rows of ``x`` split over ``batch_axes``."""
    if not batch_axes:
        return x
    i, n = _flat_index(mesh, batch_axes)
    rl = x.shape[0] // n
    return x[i * rl:(i + 1) * rl]


def build_lm_prefill(arch_id: str, cfg: LMConfig, shape: LMShape, *, params=None,
                     global_batch: Optional[int] = None, seed: int = 0,
                     device=None, mesh=None, tokens=None) -> StepBundle:
    """``step(params, tokens) -> (logits (B, padded vocab) of the last
    position, cache)``: one prefill of (B, seq_len) tokens through the flash
    kernel (``attn_impl="flash"``; the reference's builder uses ``ref``,
    the same function for unpadded tokens), the cache every layer's (k, v)
    in ``init_cache``'s layout, seq_len entries long.  ``global_batch`` cuts
    the shape's batch to what one card holds; ``tokens`` (whole) replaces
    the seeded ones.  ``model_flops`` = 2 x active parameters x tokens.

    With ``mesh`` the step is the reference's over it: ``args`` are this
    rank's pieces of the parameters under ``tree_specs`` (the reference's
    rules) and its rows of the tokens (the batch over the batch dimensions
    when they divide it), flash runs on the rank's heads
    (``transformer.TensorParallel``), the MoE is expert-parallel, the
    logits are the rank's rows, whole, and the cache is in
    ``make_decode_core``'s layout (this rank's rows and sequence chunk
    over ``model``, every kv head), so a mesh decode continues from it."""
    dev = resolve_device(device)
    b = shape.global_batch if global_batch is None else global_batch
    tokens = lm_tokens(cfg, (b, shape.seq_len), seed + 1, dev) if tokens is None else tokens
    tp, moe_fn = None, None
    if mesh is None:
        params = _lm_params(cfg, params, seed, dev)
        shardings = None
    else:
        sharding.check_mesh_device(mesh, dev)
        params, shardings = _lm_pieces(cfg, params, seed, dev, mesh, grad=False)
        batch_axes = _lm_batch_axes(mesh, b)
        tokens = _rows(tokens, mesh, batch_axes)
        tp = transformer.tensor_parallel(mesh, shardings)
        moe_fn = _lm_moe_fn(cfg, mesh, batch_axes, dev)

    def layout(x):
        return x if tp is None else transformer.decode_layout(tp, x, cfg.n_kv_heads)

    @torch.no_grad()
    def step(params, tokens):
        h, _, (prefix_kv, layers_kv) = transformer.encode(params, tokens, cfg, return_kv=True,
                                                          attn_impl="flash", moe_fn=moe_fn,
                                                          tp=tp)
        if tp is None:
            last = transformer.lm_logits(params, h[:, -1:, :], cfg)[:, 0]
        else:
            # the last position lives on the last model rank when the
            # sequence is split: every rank takes it from there
            end = h[:, -1] if h.shape[1] == tokens.shape[1] else tp.whole(
                h[:, -1:], 1, tp.n)[:, -1]
            last = tp.whole(transformer.lm_logits(params, end, cfg, tp), -1,
                            transformer.padded_vocab(cfg))
        cache = {"layers": [{"k": layout(k), "v": layout(v)} for k, v in layers_kv]}
        if prefix_kv:
            cache["prefix"] = [{"k": layout(k), "v": layout(v)} for k, v in prefix_kv]
        return last, cache

    return StepBundle(f"{arch_id}:{shape.name}", step, (params, tokens),
                      2.0 * cfg.n_active_params() * b * shape.seq_len, shardings=shardings)


def build_lm_decode(arch_id: str, cfg: LMConfig, shape: LMShape, *, params=None,
                    global_batch: Optional[int] = None, seed: int = 0,
                    device=None, mesh=None) -> StepBundle:
    """``step(params, cache, token, pos) -> (logits (B, padded vocab),
    cache)``: one ``decode_step`` against a KV cache of ``seq_len`` entries,
    written in place at ``pos``.  ``args`` = (params, a zero cache
    (``init_cache``), seeded tokens (B,), ``pos`` = seq_len - 1 as a 0-d
    tensor: the new token attends over the whole cache).  ``model_flops``
    = 2 x active parameters x B.

    With ``mesh`` (a ``DeviceMesh``; every rank calls this) the step is
    the reference's mesh decode: the cache's sequence over ``model`` and
    the batch over the batch dimensions (``pod``, ``data``) that divide it
    (at ``long_500k``, batch 1, the sequence over every dimension), through
    ``make_decode_core``; the parameters are this rank's pieces under
    ``tree_specs`` (the reference's rules: FSDP over ``data``, heads, MLP
    columns, vocab and experts over ``model``), the dense blocks
    tensor-parallel and the MoE expert-parallel (``make_moe_fn``).
    ``args`` are this rank's: its pieces, its chunk of the cache, its rows
    of the tokens, and the logits are those rows', whole."""
    dev = resolve_device(device)
    b, s = (shape.global_batch if global_batch is None else global_batch), shape.seq_len
    token = lm_tokens(cfg, (b,), seed + 1, dev)
    pos = torch.tensor(s - 1, dtype=torch.int32, device=dev)
    hooks, shardings = {}, None
    if mesh is None:
        params = _lm_params(cfg, params, seed, dev)
    else:
        from ..distributed.decode_attention import make_decode_core

        sharding.check_mesh_device(mesh, dev)
        params, shardings = _lm_pieces(cfg, params, seed, dev, mesh, grad=False)
        if shape.name == "long_500k":
            batch_axes, seq_axes = (), sharding.batch_axes(mesh) + ("model",)
        else:
            dims = sharding.mesh_dims(mesh)
            batch_axes = tuple(a for a in sharding.batch_axes(mesh) if b % dims[a] == 0)
            seq_axes = ("model",)
        hooks["decode_core"] = make_decode_core(mesh, batch_axes, seq_axes, s, device=dev)
        hooks["moe_fn"] = _lm_moe_fn(cfg, mesh, batch_axes, dev)
        hooks["tp"] = transformer.tensor_parallel(mesh, shardings)
        token = _rows(token, mesh, batch_axes)
        b, s = token.shape[0], hooks["decode_core"].local_len

    @torch.no_grad()
    def step(params, cache, token, pos):
        return transformer.decode_step(params, cache, token, pos, cfg, **hooks)

    cache = transformer.init_cache(cfg, b, s, device=dev)
    return StepBundle(f"{arch_id}:{shape.name}", step, (params, cache, token, pos),
                      2.0 * cfg.n_active_params() * b, shardings=shardings)


ADACUR_SERVE_CFG = AdaCURConfig(
    k_anchor=250, n_rounds=5, budget_ce=500, strategy="topk",
    split_budget=True, k_retrieve=100,
)


def build_lm_adacur_serve(arch_id: str, cfg: LMConfig, *, params=None,
                          n_items: int = 1_000_000, batch: int = 8, item_len: int = 48,
                          query_len: int = 16, k_q: int = 500, seed: int = 0,
                          device=None) -> StepBundle:
    """The paper's full pipeline: ``step(params, batch_in, key) ->
    (topk_idx, topk_scores)``, Algorithm 1 (``adacur.adacur_search``,
    ``ADACUR_SERVE_CFG``: 250 anchors in 5 rounds, budget 500, top 100)
    over ``n_items`` items whose exact scorer is the LM as a cross-encoder:
    each round's B x k_s calls are one batch of ``[CLS] q [SEP] i [SEP]``
    pairs (``query_len + item_len + 3`` tokens) through ``score_tokens``
    with ``attn_impl="flash"``.

    ``batch_in``: ``corpus_tokens`` (N padded to a multiple of 512,
    item_len) and ``query_tokens`` (batch, query_len), seeded draws in
    [3, vocab) so no ``pad_id`` 0 falls inside a pair (the flash path's
    length mask stays trailing-only), and ``r_anc`` (k_q, N padded) fp32.
    A real R_anc is k_q x N CE calls, so it is a seeded standard normal
    stand-in (padded columns 0); the reference's step takes it as an input
    too, and a caller may put its own in ``batch_in``.
    The config is used as given: a causal one gives every pair one score
    (``cross_encoder``'s doc), so serve ``replace(cfg, causal=False)``.
    ``stats`` counts the CE calls of every step.  ``model_flops`` =
    budget_ce prefills a query plus the rounds' e_q @ R_anc passes."""
    dev = resolve_device(device)
    acfg = ADACUR_SERVE_CFG
    if params is None:
        params = cross_encoder.init_cross_encoder(cfg, _generator(seed, dev), dev)
    n_pad = (n_items + 511) // 512 * 512
    pair_len = query_len + item_len + 3
    stats = ScorerStats()

    @torch.no_grad()
    def step(params, batch_in, key):
        corpus = batch_in["corpus_tokens"]

        def score_fn(q_tokens, item_idx):
            stats.requests += 1
            stats.pairs += item_idx.numel()
            stats.ce_calls += item_idx.numel()
            pairs = cross_encoder.build_pair_tokens(q_tokens, corpus[item_idx.long()],
                                                    pad_to=pair_len)
            return cross_encoder.score_tokens(params, pairs.reshape(-1, pair_len), cfg,
                                              attn_impl="flash").reshape(item_idx.shape)

        res = adacur.adacur_search(score_fn, batch_in["r_anc"], batch_in["query_tokens"],
                                   acfg, key, batch=batch, n_valid_items=n_items)
        return res.topk_idx, res.topk_scores

    r_anc = torch.randn((k_q, n_pad), generator=_generator(seed + 3, dev), device=dev)
    r_anc[:, n_items:] = 0.0
    batch_in = {"corpus_tokens": lm_tokens(cfg, (n_pad, item_len), seed + 1, dev, low=3),
                "query_tokens": lm_tokens(cfg, (batch, query_len), seed + 2, dev, low=3),
                "r_anc": r_anc}
    ce_flops = 2.0 * cfg.n_active_params() * batch * acfg.budget_ce * pair_len
    return StepBundle(f"{arch_id}:adacur_serve", step, (params, batch_in, prng.PRNGKey(seed)),
                      ce_flops + 2.0 * batch * k_q * n_pad * acfg.n_rounds, stats)


def build_cell(arch_id: str, shape_name: str, *, params=None, global_batch=None,
               seed: int = 0, device=None, mesh=None) -> StepBundle:
    """The bundle of one (arch, shape) cell of a family the port serves
    (``registry.get`` raises for the others); ``adacur_serve`` is the LM
    family's extra cell.  With ``mesh``, the GNN cells, the LM cells but
    ``adacur_serve`` and DLRM's ``train_batch`` run over it; the other
    cells raise (ROADMAP.md, queue 1, item 2c)."""
    entry = registry.get(arch_id)
    cfg = entry.config
    kw = dict(params=params, seed=seed, device=device)
    if mesh is not None:
        kw["mesh"] = mesh
        shape = registry.shapes_for(arch_id).get(shape_name)
        if not (entry.family == "gnn"
                or (entry.family == "lm" and shape_name != "adacur_serve")
                or (entry.family == "recsys" and shape is not None and shape.kind == "train"
                    and cfg.kind == "dlrm")):
            raise NotImplementedError(
                f"{arch_id}:{shape_name} over a mesh is not ported yet: ROADMAP.md, queue 1, "
                "item 2c")
    if entry.family == "gnn":
        return build_gnn_train(arch_id, cfg, registry.shapes_for(arch_id)[shape_name], **kw)
    if entry.family == "lm":
        if shape_name == "adacur_serve":
            return build_lm_adacur_serve(arch_id, cfg, **kw)
        shape = registry.shapes_for(arch_id)[shape_name]
        builder = {"train": build_lm_train, "prefill": build_lm_prefill,
                   "decode": build_lm_decode}[shape.kind]
        return builder(arch_id, cfg, shape, global_batch=global_batch, **kw)
    shape = registry.shapes_for(arch_id)[shape_name]
    if shape.kind == "train":
        return build_recsys_train(arch_id, cfg, shape, **kw)
    if shape.kind == "serve":
        return build_recsys_serve(arch_id, cfg, shape, **kw)
    return build_recsys_retrieval(arch_id, cfg, shape, **kw)
