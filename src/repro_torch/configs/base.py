"""Configs — the port's own copies of the reference's ``AdaCURConfig``,
``LMConfig``, ``RecSysConfig``, ``RecSysShape`` and ``replace``
(``repro/configs/base.py``), with the same field names, defaults and
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
class LMConfig:
    """Decoder (or encoder) transformer LM configuration — the port's copy
    of the reference's ``LMConfig``, same field names and defaults.

    ``moe`` is kept as a field so one kwargs dict builds both packages'
    configs, but the port serves dense models only: a config with ``moe``
    set raises (MoE is listed in ROADMAP.md, queue 1).  ``remat`` and
    ``scan_layers`` have no effect in the port (it runs eagerly, forward
    only, over a list of per-layer parameter dicts).
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
    moe: Optional[object] = None     # not ported (see class doc)
    max_seq_len: int = 524288
    dtype: str = "bfloat16"          # activation / param dtype for serving
    remat: bool = True
    scan_layers: bool = True

    def __post_init__(self):
        if self.moe is not None:
            raise NotImplementedError(
                f"{self.name}: MoE layers are not ported yet (ROADMAP.md, "
                "queue 1); the port serves dense LMConfigs"
            )

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def n_active_params(self) -> int:
        """Parameters a token passes through: all of them in a dense model."""
        return self.n_params()

    def n_params(self) -> int:
        """Analytic parameter count of the dense model."""
        hd = self.resolved_head_dim
        emb = self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        attn = self.d_model * hd * (self.n_heads + 2 * self.n_kv_heads)  # qkv
        attn += self.n_heads * hd * self.d_model                          # out
        if self.qkv_bias:
            attn += hd * (self.n_heads + 2 * self.n_kv_heads)
        n_ff = 3 if self.act == "swiglu" else 2
        per_layer = attn + n_ff * self.d_model * self.d_ff
        norms = self.n_layers * 2 * self.d_model + self.d_model
        return emb + per_layer * self.n_layers + norms


@dataclass(frozen=True)
class RecSysConfig:
    """Recommender configuration — the port's copy of the reference's
    ``RecSysConfig``, same field names and defaults.  The port serves the
    ``dlrm`` kind; BST, BERT4Rec and MIND are later slices (ROADMAP.md,
    queue 1, item 13)."""

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
