"""Decoder/encoder transformer LM — port of ``repro/models/transformer.py``
on one device: ``padded_vocab``, ``init_lm``, ``_project_qkv``,
``_mlp_block`` (dense and MoE), ``encode`` (train / prefill, optionally
returning every layer's K/V), ``lm_logits``, and the KV-cached decode path
(``init_cache``, ``_local_decode_core``, ``_decode_layer``,
``decode_step``).

Parameters are a dict: ``embed`` (padded vocab, d), ``prefix`` (MoE
configs with ``first_k_dense``: the dense layers that come first) and
``layers`` (lists of per-layer dicts in the reference's layouts: ``attn``
with ``wq``/``wk``/``wv`` (d, heads, hd) and ``wo`` (H, hd, d),
``ln1``/``ln2``, and ``mlp`` or ``moe``), ``final_norm`` and ``lm_head``.
The reference stacks ``layers`` on a leading axis for ``lax.scan``;
``convert.lm_params`` unstacks them.  A KV cache follows the same layout:
``{"layers": [{"k", "v"}, ...], "prefix": [...]}``, each (B, S, KV, hd).
The reference's pluggable ``moe_fn`` / ``decode_core`` (its mesh paths)
are ``encode``'s and ``decode_step``'s keywords.  ``cfg.remat`` recomputes
each layer in the backward (``torch.utils.checkpoint``, the reference's
``jax.checkpoint``) whenever autograd records.

Over a mesh (``tp=``, a :class:`TensorParallel` of this rank) one layer
serves encode and decode: the parameters are this rank's pieces under the
reference's ``tree_specs``, a piece split over ``data`` is gathered where
the layer uses it (``fsdp.gather``, its gradient reduce-scattered back) and
a piece split over ``model`` is used in place.  The reference asks GSPMD
for this layout (``launch/steps.py``'s ``act_spec`` / ``attn_spec``); the
port writes the collectives out, Megatron's way:

- the residual stream between layers is split by sequence over ``model``
  (decode's one token: replicated); a block's input is normed on the
  rank's chunk and all-gathered over ``model``;
- ``wq``/``wk``/``wv`` are column-parallel (the rank's heads), attention
  runs on the rank's heads, ``wo`` is row-parallel and its partial sums are
  reduce-scattered back into the sequence chunks (all-reduced in decode);
  the dense MLP likewise by its columns, the MoE by its experts
  (``moe.make_moe_fn``); a block whose weights are whole over ``model``
  (a head count or width that does not divide it) computes whole and keeps
  its chunk;
- kv heads whole over ``model`` (fewer than its ranks) are read by the
  rank's q heads from the whole set: q head h reads kv head h / (H / KV);
- the embedding is vocab-parallel (each rank looks up the ids its rows
  own, zeros for the others, and the sum lands in the residual's layout)
  and so are the logits (:func:`lm_logits` of a vocab piece masks the
  padded rows by their global index).

The sequence's partial sums cross ranks in the activations' dtype (two
model ranks: the bits of an fp32 sum cast back), decode's in fp32.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import LMConfig
from ..distributed import fsdp
from ..kernels.flash_attention.ops import flash_attention
from ..tree import tree_map
from . import layers, moe as moe_lib


def torch_dtype(cfg: LMConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def padded_vocab(cfg: LMConfig) -> int:
    """Vocab rows padded to a multiple of 512, as the reference pads them."""
    return (cfg.vocab_size + 511) // 512 * 512


def _norm_init(cfg: LMConfig, d: int, device):
    w = {"w": torch.ones(d, device=device)}
    if cfg.norm == "layernorm":
        w["b"] = torch.zeros(d, device=device)
    return w


def _apply_norm(cfg: LMConfig, p, x):
    if cfg.norm == "layernorm":
        return layers.layernorm(x, p["w"], p["b"])
    return layers.rmsnorm(x, p["w"], cfg.rms_eps)


def _layer_init(gen: torch.Generator, cfg: LMConfig, use_moe: bool = False):
    hd, d, dt = cfg.resolved_head_dim, cfg.d_model, torch_dtype(cfg)
    dev = gen.device
    attn = {
        "wq": layers.dense_init(gen, (d, cfg.n_heads, hd), dtype=dt),
        "wk": layers.dense_init(gen, (d, cfg.n_kv_heads, hd), dtype=dt),
        "wv": layers.dense_init(gen, (d, cfg.n_kv_heads, hd), dtype=dt),
        "wo": layers.dense_init(gen, (cfg.n_heads, hd, d), dtype=dt),
    }
    if cfg.qkv_bias:
        attn["bq"] = torch.zeros((cfg.n_heads, hd), dtype=dt, device=dev)
        attn["bk"] = torch.zeros((cfg.n_kv_heads, hd), dtype=dt, device=dev)
        attn["bv"] = torch.zeros((cfg.n_kv_heads, hd), dtype=dt, device=dev)
    if cfg.qk_norm:
        attn["q_norm"] = torch.ones(hd, device=dev)
        attn["k_norm"] = torch.ones(hd, device=dev)
    out = {"attn": attn, "ln1": _norm_init(cfg, d, dev), "ln2": _norm_init(cfg, d, dev)}
    if use_moe:
        out["moe"] = moe_lib.moe_init(gen, d, cfg.moe, dtype=dt)
        return out
    d_ff = cfg.d_ff if cfg.moe is None else (cfg.moe.d_ff_dense or cfg.d_ff)
    out["mlp"] = layers.mlp_init(gen, d, d_ff, cfg.act, dtype=dt)
    if cfg.mlp_bias:
        out["mlp"]["bu"] = torch.zeros(d_ff, dtype=dt, device=dev)
        out["mlp"]["bd"] = torch.zeros(d, dtype=dt, device=dev)
    return out


def n_prefix_layers(cfg: LMConfig) -> int:
    """Dense layers before the homogeneous stack (Moonlight's first dense
    block); 0 for a dense model."""
    return cfg.moe.first_k_dense if cfg.moe is not None else 0


def init_lm(cfg: LMConfig, generator: torch.Generator, place=None):
    """Parameters drawn from ``generator`` on its device (the reference's
    shapes, dtypes and scales; the port's own draws).  ``place(path,
    leaf)``, when given, maps each leaf to what is kept of it (this rank's
    piece) as soon as its layer is drawn, so at most one layer is whole at
    a time; the draws are the same either way."""
    dt = torch_dtype(cfg)
    n_prefix = n_prefix_layers(cfg)

    def kept(tree, path):
        if place is None:
            return tree
        if isinstance(tree, dict):
            return {k: kept(v, f"{path}/{k}") for k, v in tree.items()}
        return place(path, tree)

    params = {"embed": kept(layers.dense_init(generator, (padded_vocab(cfg), cfg.d_model),
                                              scale=0.02, dtype=dt), "embed")}
    if n_prefix:
        params["prefix"] = [kept(_layer_init(generator, cfg), f"prefix/{i}")
                            for i in range(n_prefix)]
    params["layers"] = [kept(_layer_init(generator, cfg, cfg.moe is not None), f"layers/{i}")
                        for i in range(cfg.n_layers - n_prefix)]
    params["final_norm"] = kept(_norm_init(cfg, cfg.d_model, generator.device), "final_norm")
    if not cfg.tie_embeddings:
        params["lm_head"] = kept(layers.dense_init(
            generator, (cfg.d_model, padded_vocab(cfg)), scale=0.02, dtype=dt), "lm_head")
    return params


def _norm_specs(cfg: LMConfig) -> dict:
    return {"w": ("embed",), "b": ("embed",)} if cfg.norm == "layernorm" else {"w": ("embed",)}


def _layer_specs(cfg: LMConfig, use_moe: bool = False) -> dict:
    attn = {"wq": ("embed", "heads", "head_dim"), "wk": ("embed", "kv_heads", "head_dim"),
            "wv": ("embed", "kv_heads", "head_dim"), "wo": ("heads", "head_dim", "embed")}
    if cfg.qkv_bias:
        attn.update(bq=("heads", "head_dim"), bk=("kv_heads", "head_dim"),
                    bv=("kv_heads", "head_dim"))
    if cfg.qk_norm:
        attn.update(q_norm=("head_dim",), k_norm=("head_dim",))
    out = {"attn": attn, "ln1": _norm_specs(cfg), "ln2": _norm_specs(cfg)}
    if use_moe:
        out["moe"] = moe_lib.moe_specs(cfg.moe)
        return out
    out["mlp"] = layers.mlp_specs(cfg.act)
    if cfg.mlp_bias:
        out["mlp"].update(bu=("mlp",), bd=("embed",))
    return out


def param_specs(cfg: LMConfig) -> dict:
    """The logical axes of every leaf of :func:`init_lm`'s tree (the
    reference's second return value of ``init_lm``, in the port's layout:
    ``layers`` a list of per-layer trees, each without the reference's
    leading "layers" axis; ``convert.stack_layer_specs`` gives the
    reference's)."""
    n_prefix = n_prefix_layers(cfg)
    specs = {"embed": ("vocab", "embed")}
    if n_prefix:
        specs["prefix"] = [_layer_specs(cfg) for _ in range(n_prefix)]
    specs["layers"] = [_layer_specs(cfg, cfg.moe is not None)
                       for _ in range(cfg.n_layers - n_prefix)]
    specs["final_norm"] = _norm_specs(cfg)
    if not cfg.tie_embeddings:
        specs["lm_head"] = ("embed", "vocab")
    return specs


def _project_qkv(cfg: LMConfig, attn, x, rope):
    """q, k, v (..., heads, hd) of x; ``rope`` = ``layers.rope_tables`` of
    the positions (computed once per forward)."""
    def proj(w):          # "...d,dhk->...hk"
        return (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1], *w.shape[1:])

    q, k, v = proj(attn["wq"]), proj(attn["wk"]), proj(attn["wv"])
    if cfg.qkv_bias:
        q, k, v = q + attn["bq"], k + attn["bk"], v + attn["bv"]
    if cfg.qk_norm:
        q = layers.rmsnorm(q, attn["q_norm"], cfg.rms_eps)
        k = layers.rmsnorm(k, attn["k_norm"], cfg.rms_eps)
    return layers.rotate(q, *rope), layers.rotate(k, *rope), v


def _dense_ff(cfg: LMConfig) -> int:
    return cfg.d_ff if cfg.moe is None else (cfg.moe.d_ff_dense or cfg.d_ff)


# ---------------------------------------------------------------------------
# tensor parallelism over a mesh's model dimension (the module's doc)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TensorParallel:
    """This rank's part in a tensor-parallel forward: ``group`` the process
    group over the mesh's ``model`` dimension (None: one rank, and every
    method below is the identity), ``n`` its size, ``rank`` this rank's
    index on it, ``shardings`` the parameters' (a tree shaped like them;
    None when no piece is split over ``data``) and ``seq`` whether the
    residual stream is split by sequence (its dimension 1) over ``model``:
    ``encode`` sets it when the length divides, ``decode_step`` clears
    it.  Which blocks are split over ``model`` is read off the pieces'
    shapes."""

    group: Any = None
    n: int = 1
    rank: int = 0
    shardings: Any = None
    seq: bool = False
    axis: str = "model"

    def fetch(self, tree, shardings):
        """``tree``'s pieces with their splits over mesh dimensions other
        than ``model`` gathered (differentiable)."""
        if shardings is None:
            return tree
        return tree_map(lambda p, s: fsdp.gather(p, s, keep=(self.axis,)), tree, shardings)

    def expand(self, x):
        """The whole sequence of a tensor in the residual's layout."""
        if self.group is None or not self.seq:
            return x
        return fsdp.all_gather(x, self.group, 1)

    def chunk(self, x):
        """This rank's part of a whole-sequence tensor in the residual's
        layout (a view)."""
        if self.group is None or not self.seq:
            return x
        lc = x.shape[1] // self.n
        return x.narrow(1, self.rank * lc, lc)

    def combine(self, y, split: bool):
        """A block's output of the whole sequence into the residual's
        layout: partial sums (``split``: the block's weights are this
        rank's slice) reduce-scattered by sequence (sent in their own
        dtype, summed in fp32 and cast back once) or, for decode's one
        token, all-reduced in fp32; a whole output's chunk."""
        if self.group is None:
            return y
        if not split:
            return self.chunk(y)
        if self.seq:
            return fsdp.reduce_scatter(y, self.group, 1)
        return fsdp.all_reduce(y.float(), self.group).to(y.dtype)

    def heads(self, total: int, local: int) -> range:
        """The global ids of this rank's ``local`` of ``total`` heads (or
        vocab rows)."""
        lo = 0 if local == total else self.rank * local
        return range(lo, lo + local)

    def whole(self, x, dim: int, total: int):
        """``x`` whole along ``dim`` (``total`` long) from the ranks' slices
        of it (without a gradient: decode and the logits of one position)."""
        if x.shape[dim] == total:
            return x
        return fsdp.all_gather(x, self.group, dim % x.dim())


ONE_RANK = TensorParallel()


def tensor_parallel(mesh, shardings=None, axis: str = "model") -> TensorParallel:
    """This rank's :class:`TensorParallel` over ``mesh``'s ``axis`` (a mesh
    without it, or of one rank along it, gives one rank)."""
    from ..distributed.sharding import mesh_dims

    group = fsdp.mesh_group(mesh, (axis,)) if axis in mesh_dims(mesh) else None
    if group is None:
        return TensorParallel(shardings=shardings, axis=axis)
    return TensorParallel(group, dist.get_world_size(group), dist.get_rank(group), shardings,
                          axis=axis)


def seq_order(b: int, l: int, n: int) -> torch.Tensor:
    """The (B, L) tokens' row-major positions reordered so that rank r's
    block of B x L / n rows is its sequence chunk (B, L / n) in row-major
    order: where ``moe.make_moe_fn(scatter_tokens=True)`` reduce-scatters
    the MoE's output rows, the residual's layout wants them."""
    return torch.arange(b * l).view(b, n, l // n).transpose(0, 1).reshape(-1)


def decode_layout(tp: TensorParallel, x: torch.Tensor, n_kv: int) -> torch.Tensor:
    """A prefill's k or v of this rank's kv heads over the whole sequence
    (B, L, KV_local, hd) -> ``make_decode_core``'s layout over ``model``:
    this rank's sequence chunk, every kv head (B, L / n, KV, hd), by one
    all-to-all (heads to sequence); a length that does not divide gives
    every head over the whole sequence."""
    if tp.group is None:
        return x
    if x.shape[1] % tp.n:
        return tp.whole(x, 2, n_kv)
    if x.shape[2] == n_kv:
        lc = x.shape[1] // tp.n
        return x[:, tp.rank * lc:(tp.rank + 1) * lc].contiguous()
    return fsdp.all_to_all(x, tp.group, 1, 2)


def _kv_for_heads(cfg: LMConfig, tp: TensorParallel, q_heads: int, k, v):
    """k, v (..., KV_local, hd) as this rank's ``q_heads`` q heads read
    them: as they are when the kv heads follow the q heads' split (or
    neither is split); else, kv heads whole, the kv heads of this rank's q
    heads (head h reads kv head h // (H / KV)), a slice when they group
    evenly, one a q head otherwise."""
    if k.shape[-2] != cfg.n_kv_heads or q_heads == cfg.n_heads:
        return k, v
    ids = [h // cfg.q_per_kv for h in tp.heads(cfg.n_heads, q_heads)]
    count = ids[-1] - ids[0] + 1
    if q_heads % count == 0 and ids == [ids[0] + j // (q_heads // count)
                                        for j in range(q_heads)]:
        return k.narrow(-2, ids[0], count), v.narrow(-2, ids[0], count)
    idx = torch.tensor(ids, device=k.device)
    return k.index_select(-2, idx), v.index_select(-2, idx)


def _ffn(cfg: LMConfig, tp: TensorParallel, lp, x, moe_fn=None):
    """The layer's FFN of x (its norm's output) in the residual's layout ->
    (the FFN's output in that layout, aux loss): the MoE or dense MLP.
    ``moe_fn(params, x)`` replaces the single-device MoE (the
    expert-parallel ``moe.make_moe_fn``, over ``model`` when ``tp`` is
    set; with ``scatter_tokens`` its output rows land in the residual's
    chunks)."""
    xg = tp.expand(x)
    x2 = xg.reshape(-1, xg.shape[-1])
    if "moe" in lp:
        if moe_fn is None:
            y, aux = moe_lib.moe_apply_local(lp["moe"], x2, cfg.moe)
            return tp.chunk(y.reshape(xg.shape)), aux
        if tp.seq and tp.group is not None and getattr(moe_fn, "scatter_tokens", False):
            order = seq_order(xg.shape[0], xg.shape[1], tp.n).to(x.device)
            y, aux = moe_fn(lp["moe"], x2, order=order)
            return y.reshape(x.shape), aux
        y, aux = moe_fn(lp["moe"], x2)
        return tp.chunk(y.reshape(xg.shape)), aux
    p = lp["mlp"]
    zero = torch.zeros((), device=x.device)
    split = p["wu"].shape[-1] != _dense_ff(cfg)
    if cfg.mlp_bias:
        y = F.gelu(x2 @ p["wu"] + p["bu"], approximate="tanh") @ p["wd"]
        return tp.combine(y.reshape(xg.shape), split) + p["bd"], zero
    return tp.combine(layers.mlp_apply(p, x2, cfg.act).reshape(xg.shape), split), zero


def _out_proj(o, wo):
    """"...hk,hkd->...d" of attention heads o (..., H, hd)."""
    return o.reshape(*o.shape[:-2], -1) @ wo.reshape(-1, wo.shape[-1])


def _encode_layer(cfg: LMConfig, attn_fn, h, lp, rope, moe_fn=None,
                  tp: Optional[TensorParallel] = None, shardings=None):
    """One layer of h (B, L_local, d): ``lp`` this rank's pieces (whole on
    one rank), ``shardings`` theirs -> (h, (k, v of this rank's kv heads
    over the whole sequence, aux))."""
    tp = tp or ONE_RANK
    lp = tp.fetch(lp, shardings)
    x = tp.expand(_apply_norm(cfg, lp["ln1"], h))
    q, k, v = _project_qkv(cfg, lp["attn"], x, rope)
    o = attn_fn(q, *_kv_for_heads(cfg, tp, q.shape[-2], k, v))
    h = h + tp.combine(_out_proj(o, lp["attn"]["wo"]), q.shape[-2] != cfg.n_heads)
    ffn, aux = _ffn(cfg, tp, lp, _apply_norm(cfg, lp["ln2"], h), moe_fn)
    return h + ffn, (k, v, aux)


def _embed(cfg: LMConfig, tp: TensorParallel, embed, tokens):
    """Token ids (B, L) or (B,) -> their rows in the residual's layout, in
    the model's dtype.  A vocab piece looks up the ids its rows own (zeros
    for the others) and the ranks' sums land in the layout: each id has
    one owner, so the rows are the whole table's bits."""
    rows = embed.shape[0]
    if rows == padded_vocab(cfg):
        return tp.chunk(F.embedding(tokens.long(), embed).to(torch_dtype(cfg)))
    ids = tokens.long() - tp.heads(padded_vocab(cfg), rows).start
    mine = (ids >= 0) & (ids < rows)
    e = F.embedding(ids.clamp(0, rows - 1), embed)
    e = torch.where(mine[..., None], e, torch.zeros((), dtype=e.dtype, device=e.device))
    return tp.combine(e.to(torch_dtype(cfg)), True)


def encode(params, tokens: torch.Tensor, cfg: LMConfig, *, positions=None,
           kv_mask=None, q_chunk: int = 1024, return_kv: bool = False,
           attn_impl: str = "ref", flash_block: Tuple[int, int] = (128, 128),
           flash_interpret: bool = True, moe_fn=None, tp: Optional[TensorParallel] = None):
    """Full forward pass -> (hidden (B, L, d), aux loss[, kv]).

    The aux loss is the MoE layers' load-balance terms summed (0 for a
    dense model).  With ``return_kv`` the third item is ``(prefix_kv,
    layers_kv)``: lists of each layer's (k, v), (B, L, KV, hd) after RoPE,
    as the reference returns them (its scanned ones stacked).

    ``attn_impl='flash'`` routes attention through ``flash_attention`` (the
    CUDA kernel on the card, its plain version on the CPU); ``kv_mask`` must
    then describe trailing padding only, and is collapsed to per-example
    ``kv_lens = kv_mask.sum(-1)``.  ``flash_block`` shapes only the plain
    version's tiles; ``flash_interpret`` has no effect in the port (kept so
    one kwargs dict drives both packages).  ``moe_fn`` replaces the MoE
    layers' single-device FFN.  Each layer is recomputed in the backward
    when ``cfg.remat`` and autograd records.

    With ``tp`` (over a mesh: ``params`` this rank's pieces, ``tokens`` its
    data shard's rows, whole over ``model``) the hidden states are this
    rank's sequence chunk (B, L / n, d) when n divides L (else whole), and
    the kv this rank's kv heads over the whole sequence.
    """
    b, l = tokens.shape
    tp = ONE_RANK if tp is None else replace(tp, seq=tp.n > 1 and l % tp.n == 0)
    sh = tp.shardings or {}
    if positions is None:
        positions = torch.arange(l, device=tokens.device)[None, :].expand(b, l)
    # F.embedding: the same rows as indexing, and a deterministic backward on
    # the card (a sort, not atomics), which training's bitwise resume needs
    h = _embed(cfg, tp, tp.fetch(params["embed"], sh.get("embed")), tokens)

    if attn_impl == "flash":
        kv_lens = None if kv_mask is None else kv_mask.sum(-1).to(torch.int32)

        def attn_fn(q, k, v):
            return flash_attention(q, k, v, causal=cfg.causal, block_q=flash_block[0],
                                   block_k=flash_block[1], kv_lens=kv_lens)
    elif attn_impl == "ref":
        def attn_fn(q, k, v):
            return layers.attention_ref(q, k, v, causal=cfg.causal, q_chunk=q_chunk,
                                        kv_mask=kv_mask)
    else:
        raise ValueError(f"unknown attn_impl '{attn_impl}' (ref|flash)")

    rope = layers.rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    remat = cfg.remat and torch.is_grad_enabled()
    aux_total = torch.zeros((), device=h.device)
    kvs = {"prefix": [], "layers": []}
    for part in ("prefix", "layers"):
        for i, lp in enumerate(params.get(part, [])):
            args = (cfg, attn_fn, h, lp, rope, moe_fn, tp, sh[part][i] if sh else None)
            if remat:
                h, (k, v, aux) = checkpoint(_encode_layer, *args, use_reentrant=False)
            else:
                h, (k, v, aux) = _encode_layer(*args)
            aux_total = aux_total + aux
            if return_kv:
                kvs[part].append((k, v))
    h = _apply_norm(cfg, tp.fetch(params["final_norm"], sh.get("final_norm")), h)
    if return_kv:
        return h, aux_total, (kvs["prefix"], kvs["layers"])
    return h, aux_total


def lm_head(params, cfg: LMConfig, tp: Optional[TensorParallel] = None):
    """The (d, vocab rows) head of :func:`lm_logits` (the tied embedding's
    transpose or ``lm_head``): with ``tp``, this rank's vocab piece, its
    ``data`` split gathered."""
    tp = tp or ONE_RANK
    sh = tp.shardings or {}
    if cfg.tie_embeddings:
        return tp.fetch(params["embed"], sh.get("embed")).T
    return tp.fetch(params["lm_head"], sh.get("lm_head"))


def head_logits(head, hidden: torch.Tensor, cfg: LMConfig,
                tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """hidden (..., d) @ ``head`` (:func:`lm_head`) with the padded vocab
    rows set to -1e30 by their global index, as the reference masks them."""
    tp = tp or ONE_RANK
    logits = hidden @ head
    cols = tp.heads(padded_vocab(cfg), logits.shape[-1])
    if cols.stop > cfg.vocab_size:
        mask = torch.arange(cols.start, cols.stop, device=logits.device) < cfg.vocab_size
        logits = torch.where(mask, logits, torch.tensor(-1e30, dtype=logits.dtype,
                                                        device=logits.device))
    return logits


def lm_logits(params, hidden: torch.Tensor, cfg: LMConfig,
              tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """(..., padded vocab) logits of hidden states (..., d): the tied
    embedding's transpose or ``lm_head``; the padded vocab rows are set to
    -1e30, as the reference masks them.  With ``tp``, this rank's vocab
    piece of them (:func:`lm_head`)."""
    return head_logits(lm_head(params, cfg, tp), hidden, cfg, tp)


# ---------------------------------------------------------------------------
# decode: KV-cached single-token step
# ---------------------------------------------------------------------------


def init_cache(cfg: LMConfig, batch: int, max_len: int, device=None) -> dict:
    """A zero KV cache in the params' layout: ``{"layers": [{"k", "v"}],
    "prefix": [...]}`` (``prefix`` only for a model with dense prefix
    layers), each (batch, max_len, KV, hd) in the model's dtype."""
    dt = torch_dtype(cfg)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    n_prefix = n_prefix_layers(cfg)

    def layer():
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}

    cache = {"layers": [layer() for _ in range(cfg.n_layers - n_prefix)]}
    if n_prefix:
        cache["prefix"] = [layer() for _ in range(n_prefix)]
    return cache


def _local_decode_core(q, k_new, v_new, ck, cv, pos):
    """Write the new token's K/V at ``pos`` of ck/cv (in place), attend over
    the cache's first ``pos + 1`` entries -> (B, H, hd) in q's dtype."""
    ck.index_copy_(1, pos.reshape(1), k_new[:, None])
    cv.index_copy_(1, pos.reshape(1), v_new[:, None])
    num, den, _ = layers.decode_attention_local(q, ck, cv, shard_offset=0, kv_len=pos + 1)
    return (num / (den[..., None] + 1e-30)).to(q.dtype)


def _decode_layer(cfg: LMConfig, h, lp, c, pos, rope, moe_fn=None,
                  decode_core=_local_decode_core, tp: Optional[TensorParallel] = None,
                  shardings=None):
    """One decode layer: h (B, d); c the layer's cache {"k", "v"} (B, S,
    KV, hd), written in place.  ``decode_core`` is pluggable: the local
    core above or the sequence-parallel one
    (``distributed.decode_attention.make_decode_core``), which takes every
    head: with ``tp`` the rank's heads' q / k / v are all-gathered over
    ``model`` for it, and ``wo`` and the FFN run row-parallel on the
    rank's slices, an all-reduce of (B, d) each."""
    tp = tp or ONE_RANK
    lp = tp.fetch(lp, shardings)
    x = _apply_norm(cfg, lp["ln1"], h)
    q, k, v = _project_qkv(cfg, lp["attn"], x[:, None, :], rope)
    local = q.shape[-2]
    o = decode_core(tp.whole(q[:, 0], 1, cfg.n_heads), tp.whole(k[:, 0], 1, cfg.n_kv_heads),
                    tp.whole(v[:, 0], 1, cfg.n_kv_heads), c["k"], c["v"], pos)
    mine = tp.heads(cfg.n_heads, local)
    o = o[:, mine.start:mine.stop]
    h = h + tp.combine(_out_proj(o, lp["attn"]["wo"]), local != cfg.n_heads)
    ffn, _ = _ffn(cfg, tp, lp, _apply_norm(cfg, lp["ln2"], h), moe_fn)
    return h + ffn


def decode_step(params, cache: dict, token: torch.Tensor, pos, cfg: LMConfig, *,
                moe_fn=None, decode_core=None, tp: Optional[TensorParallel] = None):
    """One autoregressive step: token (B,) int at position ``pos`` (an int or
    a 0-d tensor) -> (logits (B, padded vocab), cache).

    The new K/V are written into ``cache`` IN PLACE at ``pos`` (the
    reference returns an updated copy; a preallocated cache here holds the
    one copy a long context has room for), and the same dict is returned.
    ``pos`` must lie inside the cache (checked when it is an int; a tensor
    is not read back to the host).  ``moe_fn`` and ``decode_core`` are the
    reference's mesh hooks: on a mesh each rank passes its batch rows, its
    chunk of the cache and its experts (``launch.steps.build_lm_decode``
    with ``mesh=``); with ``tp`` the parameters are this rank's pieces
    (the module's doc) and the logits are whole on every rank."""
    dev = token.device
    tp = ONE_RANK if tp is None else replace(tp, seq=False)
    sh = tp.shardings or {}
    if decode_core is None:
        decode_core = _local_decode_core
    size = getattr(decode_core, "seq_len",
                   (cache.get("prefix") or cache["layers"])[0]["k"].shape[1])
    if isinstance(pos, int) and not 0 <= pos < size:
        raise ValueError(f"pos={pos} lies outside a cache of {size} entries")
    pos = torch.as_tensor(pos, device=dev).long().reshape(())
    h = _embed(cfg, tp, tp.fetch(params["embed"], sh.get("embed")), token)
    rope = layers.rope_tables(pos.reshape(1, 1), cfg.resolved_head_dim, cfg.rope_theta)
    for part in ("prefix", "layers"):
        for i, (lp, c) in enumerate(zip(params.get(part, []), cache.get(part, []))):
            h = _decode_layer(cfg, h, lp, c, pos, rope, moe_fn, decode_core, tp,
                              sh[part][i] if sh else None)
    h = _apply_norm(cfg, tp.fetch(params["final_norm"], sh.get("final_norm")), h)
    return tp.whole(lm_logits(params, h, cfg, tp), -1, padded_vocab(cfg)), cache
