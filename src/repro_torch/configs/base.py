"""Configs — the port's own copies of the reference's ``AdaCURConfig``,
``MoEConfig``, ``LMConfig``, ``GNNConfig``, ``RecSysConfig``, ``LMShape``,
``GraphShape``, ``RecSysShape`` and ``replace`` (``repro/configs/base.py``), with the same field names, defaults and
checks, so both packages can be built from one kwargs dict.

``fused_interpret`` and ``distributed_gather`` are kept only for that
reason and have no effect here: in the port the backend follows the
tensor's device (CUDA kernels for CUDA tensors, the plain PyTorch versions
for CPU tensors), and the port runs on one device, so anchor columns are
always gathered by index (the reference's one-hot gather serves its SPMD
path).  Likewise ``fused_tile`` is the CPU plain version's item tile; the
CUDA kernels pick their own tiling, and their results do not depend on it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class AdaCURConfig:
    """Inference-time configuration for the multi-round adaptive retriever.

    A CE-call budget ``budget_ce`` split between ``k_anchor`` anchor items
    sampled over ``n_rounds`` rounds and ``budget_ce - k_anchor`` items
    re-ranked with exact CE scores (``split_budget=False`` is
    ADACUR^No-Split).  See the reference config for each field's story.
    """

    k_anchor: int = 100
    n_rounds: int = 5
    budget_ce: int = 200
    strategy: str = "topk"           # "topk" | "softmax" | "random"
    first_round: str = "random"      # "random" | "retriever"
    split_budget: bool = True
    k_retrieve: int = 100
    softmax_temp: float = 1.0
    round_epsilon: float = 0.0
    incremental_pinv: bool = True
    distributed_gather: bool = False  # no effect in the port (see module doc)
    loop_mode: str = "unrolled"      # "unrolled" | "fori"
    use_fused_topk: bool = False
    fused_tile: int = 6144
    fused_interpret: bool = True     # no effect in the port (see module doc)
    early_exit_tol: float = 0.0
    round_kernel: str = "staged"     # "staged" | "persistent"
    payload_dtype: str = "float32"   # "float32"|"bfloat16"|"int8"|"int4"|"fp8"
    payload_tile: int = 512
    pinv_rcond: float = 1e-4

    def __post_init__(self):
        if self.k_anchor % self.n_rounds != 0:
            raise ValueError(
                f"k_anchor={self.k_anchor} must divide evenly into n_rounds={self.n_rounds}"
            )
        if self.split_budget and self.budget_ce < self.k_anchor:
            raise ValueError("budget_ce must cover k_anchor when splitting budget")
        if self.loop_mode not in ("unrolled", "fori"):
            raise ValueError(f"unknown loop_mode '{self.loop_mode}'")
        if self.early_exit_tol > 0.0 and self.loop_mode != "fori":
            raise ValueError("early_exit_tol requires loop_mode='fori'")
        if self.payload_dtype not in (
            "float32", "bfloat16", "int8", "int4", "fp8"
        ):
            raise ValueError(
                f"unknown payload_dtype '{self.payload_dtype}' "
                "(float32|bfloat16|int8|int4|fp8)"
            )
        if self.payload_tile <= 0:
            raise ValueError("payload_tile must be positive")
        if self.payload_dtype == "int4" and self.payload_tile % 2:
            raise ValueError("int4 payloads need an even payload_tile "
                             "(two codes pack per byte)")
        if self.round_kernel not in ("staged", "persistent"):
            raise ValueError(f"unknown round_kernel '{self.round_kernel}'")
        if self.round_kernel == "persistent" and not self.use_fused_topk:
            raise ValueError(
                "round_kernel='persistent' fuses the round into one payload "
                "sweep; it requires use_fused_topk=True"
            )


def replace(cfg, **kw):
    """dataclasses.replace that works through our frozen configs."""
    return dataclasses.replace(cfg, **kw)


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration — the port's copy of the
    reference's ``MoEConfig`` (GShard-style dispatch with a per-expert
    capacity), same field names and defaults."""

    n_experts: int
    top_k: int
    d_expert: int                    # per-expert FFN hidden dim
    n_shared_experts: int = 0        # DeepSeek/Moonlight-style shared experts
    first_k_dense: int = 0           # first K layers use a dense FFN instead
    d_ff_dense: int = 0              # hidden dim of those dense layers
    router_jitter: float = 0.0
    aux_loss_coef: float = 0.01
    capacity_factor: float = 1.25    # GShard per-expert capacity (drop beyond)


@dataclass(frozen=True)
class LMConfig:
    """Decoder (or encoder) transformer LM configuration — the port's copy
    of the reference's ``LMConfig``, same field names and defaults.

    ``remat`` and ``scan_layers`` have no effect in the port (it runs
    eagerly over a list of per-layer parameter dicts); they are kept so one
    kwargs dict builds both packages' configs.  ``moe`` takes a
    :class:`MoEConfig` (a ``dict`` of its fields is converted).
    """

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # defaults to d_model // n_heads
    qk_norm: bool = False            # Qwen3-style per-head RMSNorm on q,k
    qkv_bias: bool = False           # Qwen1.5-style bias on QKV projections
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    causal: bool = True              # False => encoder-only (cross-encoders)
    act: str = "swiglu"              # "swiglu" | "gelu"
    norm: str = "rmsnorm"            # "rmsnorm" | "layernorm"
    mlp_bias: bool = False           # bias on MLP projections
    moe: Optional[MoEConfig] = None
    max_seq_len: int = 524288
    dtype: str = "bfloat16"          # activation / param dtype for serving
    remat: bool = True
    scan_layers: bool = True

    def __post_init__(self):
        if isinstance(self.moe, dict):   # dataclasses.asdict of a config nests it
            object.__setattr__(self, "moe", MoEConfig(**self.moe))

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def _attn_params(self) -> int:
        hd = self.resolved_head_dim
        attn = self.d_model * hd * (self.n_heads + 2 * self.n_kv_heads)  # qkv
        return attn + self.n_heads * hd * self.d_model                     # out

    def n_params(self) -> int:
        """Analytic parameter count (the reference's formula)."""
        hd = self.resolved_head_dim
        emb = self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        attn = self._attn_params()
        if self.qkv_bias:
            attn += hd * (self.n_heads + 2 * self.n_kv_heads)
        n_ff = 3 if self.act == "swiglu" else 2
        if self.moe is None:
            total_ffn = (attn + n_ff * self.d_model * self.d_ff) * self.n_layers
        else:
            moe_ffn = n_ff * self.d_model * self.moe.d_expert * (
                self.moe.n_experts + self.moe.n_shared_experts
            ) + self.d_model * self.moe.n_experts  # router
            dense_ffn = n_ff * self.d_model * (self.moe.d_ff_dense or self.d_ff)
            n_moe = self.n_layers - self.moe.first_k_dense
            total_ffn = (attn * self.n_layers + moe_ffn * n_moe
                         + dense_ffn * self.moe.first_k_dense)
        norms = self.n_layers * 2 * self.d_model + self.d_model
        return emb + total_ffn + norms

    def n_active_params(self) -> int:
        """Parameters a token passes through (the reference's formula): all
        of them in a dense model; the routed top-k and shared experts in a
        MoE layer (the reference's formula, which counts no QKV bias
        there)."""
        if self.moe is None:
            return self.n_params()
        emb = self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        n_ff = 3 if self.act == "swiglu" else 2
        active_ffn = n_ff * self.d_model * self.moe.d_expert * (
            self.moe.top_k + self.moe.n_shared_experts
        )
        dense_ffn = n_ff * self.d_model * (self.moe.d_ff_dense or self.d_ff)
        n_moe = self.n_layers - self.moe.first_k_dense
        return (emb + self._attn_params() * self.n_layers + active_ffn * n_moe
                + dense_ffn * self.moe.first_k_dense)


@dataclass(frozen=True)
class GNNConfig:
    """NequIP configuration — the port's copy of the reference's
    ``GNNConfig`` (``models/gnn/nequip.py``), same field names and
    defaults."""

    name: str
    n_layers: int
    d_hidden: int                    # multiplicity per irrep channel
    l_max: int                       # max spherical-harmonic degree
    n_rbf: int                       # radial basis functions
    cutoff: float                    # radial cutoff (Angstrom)
    d_feat: int = 0                  # raw input node-feature dim (0 => species embed)
    n_species: int = 64
    equivariance: str = "E(3)-tensor-product"
    dtype: str = "float32"

    @property
    def irrep_dim(self) -> int:
        """Total feature dim per channel over l = 0..l_max: sum(2l+1)."""
        return sum(2 * l + 1 for l in range(self.l_max + 1))


@dataclass(frozen=True)
class RecSysConfig:
    """Recommender configuration — the port's copy of the reference's
    ``RecSysConfig``, same field names and defaults.  The port serves every
    kind: ``dlrm`` (``models/recsys/dlrm.py``), ``bst``, ``bert4rec`` and
    ``mind`` (``models/recsys/{bst,bert4rec,mind}.py``)."""

    name: str
    kind: str                        # "bst" | "mind" | "bert4rec" | "dlrm"
    embed_dim: int
    n_items: int = 1_000_000         # item vocabulary (retrieval corpus)
    seq_len: int = 20                # user-history length (sequential models)
    n_heads: int = 8
    n_blocks: int = 1
    mlp_dims: Tuple[int, ...] = ()
    # MIND
    n_interests: int = 4
    capsule_iters: int = 3
    # DLRM
    n_dense: int = 0
    n_sparse: int = 0
    bot_mlp: Tuple[int, ...] = ()
    top_mlp: Tuple[int, ...] = ()
    table_sizes: Tuple[int, ...] = ()
    interaction: str = "dot"
    multihot_per_field: int = 1      # lookups per sparse field (embedding-bag size)
    dtype: str = "float32"


@dataclass(frozen=True)
class RecSysShape:
    """One named recsys step shape (``configs/shapes.py``)."""

    name: str
    kind: str          # "train" | "serve" | "retrieval"
    batch: int
    n_candidates: int = 0


@dataclass(frozen=True)
class LMShape:
    """One named LM step shape (``configs/shapes.py``)."""

    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


@dataclass(frozen=True)
class GraphShape:
    """One named GNN step shape (``configs/shapes.py``)."""

    name: str
    kind: str          # "full" | "minibatch" | "molecule"
    n_nodes: int
    n_edges: int
    d_feat: int = 0
    batch_nodes: int = 0
    fanout: Tuple[int, ...] = ()
    batch_graphs: int = 0
