"""Architecture registry: ``--arch <id>`` -> (config, family, shape set) —
the port's copy of ``repro/configs/registry.py`` for the families it
serves: the five model-zoo LMs (qwen3-8b, the paper pipeline's primary
cross-encoder backbone in ``launch/steps.py::build_lm_adacur_serve``;
qwen1.5-110b; starcoder2-3b; the MoE moonshot-v1-16b-a3b and
granite-moe-1b-a400m), ``ce-tiny`` and ``dlrm-mlperf``, field for field,
and ``smoke_config``'s LM and recsys branches.

nequip, bst, mind and bert4rec are the reference's too, but the port does
not serve them yet: :func:`get` raises ``NotImplementedError`` for them
(ROADMAP.md, queue 1).

``QWEN3_8B_ATTENTION`` is Qwen3-8B's attention shape (32 query heads, 8 KV
heads, head_dim 128), read off its config: the flash kernel's checks at a
large-model width use it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

from . import (
    dlrm_mlperf,
    granite_moe_1b_a400m,
    moonshot_v1_16b_a3b,
    qwen1_5_110b,
    qwen3_8b,
    starcoder2_3b,
)
from .base import LMConfig, replace
from .shapes import SHAPES_BY_FAMILY


@dataclass(frozen=True)
class ArchEntry:
    arch_id: str
    family: str            # "lm" | "recsys"
    config: Any
    adacur_applicable: bool
    notes: str = ""


# The paper's own model: a small cross-encoder backbone.
CE_TINY = LMConfig(
    name="ce-tiny",
    n_layers=4,
    d_model=256,
    n_heads=8,
    n_kv_heads=4,
    head_dim=32,
    d_ff=1024,
    vocab_size=512,          # byte-level tokenizer + specials
    qk_norm=True,
    rope_theta=10000.0,
    act="swiglu",
    causal=False,            # cross-encoders read the joint sequence bidirectionally
    max_seq_len=512,
)

QWEN3_8B_ATTENTION = dict(n_heads=qwen3_8b.CONFIG.n_heads,
                          n_kv_heads=qwen3_8b.CONFIG.n_kv_heads,
                          head_dim=qwen3_8b.CONFIG.resolved_head_dim)

REGISTRY: Dict[str, ArchEntry] = {
    "qwen3-8b": ArchEntry("qwen3-8b", "lm", qwen3_8b.CONFIG, True, "primary CE backbone"),
    "qwen1.5-110b": ArchEntry("qwen1.5-110b", "lm", qwen1_5_110b.CONFIG, True),
    "starcoder2-3b": ArchEntry("starcoder2-3b", "lm", starcoder2_3b.CONFIG, True),
    "moonshot-v1-16b-a3b": ArchEntry(
        "moonshot-v1-16b-a3b", "lm", moonshot_v1_16b_a3b.CONFIG, True, "MoE CE backbone"
    ),
    "granite-moe-1b-a400m": ArchEntry(
        "granite-moe-1b-a400m", "lm", granite_moe_1b_a400m.CONFIG, True, "MoE CE backbone"
    ),
    "dlrm-mlperf": ArchEntry("dlrm-mlperf", "recsys", dlrm_mlperf.CONFIG, True),
    "ce-tiny": ArchEntry("ce-tiny", "lm", CE_TINY, True, "paper repro backbone"),
}

LM_ARCHS = tuple(a for a, e in REGISTRY.items() if e.family == "lm" and a != "ce-tiny")

# the reference's other architectures, not ported yet
NOT_PORTED = ("nequip", "bst", "mind", "bert4rec")


def get(arch_id: str) -> ArchEntry:
    if arch_id in NOT_PORTED:
        raise NotImplementedError(f"{arch_id} is not ported yet (ROADMAP.md, queue 1)")
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


def shapes_for(arch_id: str):
    """Assigned shape set for this arch (dict name -> shape dataclass)."""
    return SHAPES_BY_FAMILY[get(arch_id).family]


def smoke_config(arch_id: str):
    """Reduced config of the same family for CPU tests (the reference's
    ``smoke_config``): an LM at 2 layers, d_model 64, 4 heads of 16, fp32,
    its MoE cut to 4 experts (top 2, d_expert 64) with a generous capacity
    factor of 8, so decode equals encode (no batch-dependent drops)."""
    entry = get(arch_id)
    cfg = entry.config
    if entry.family == "lm":
        moe = cfg.moe
        if moe is not None:
            moe = replace(
                moe, n_experts=4, top_k=2, d_expert=64,
                n_shared_experts=min(moe.n_shared_experts, 1),
                first_k_dense=min(moe.first_k_dense, 1), d_ff_dense=128,
                capacity_factor=8.0,
            )
        return replace(
            cfg, n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=max(1, 4 * cfg.n_kv_heads // cfg.n_heads),
            head_dim=16, d_ff=128, vocab_size=256, moe=moe,
            max_seq_len=1024, dtype="float32",
        )
    kw = dict(embed_dim=16, n_items=1000, seq_len=min(cfg.seq_len, 8))
    if cfg.kind == "dlrm":
        kw.update(
            bot_mlp=(13, 32, 16), top_mlp=(64, 32, 1),
            table_sizes=tuple(min(s, 100) for s in cfg.table_sizes),
        )
    return replace(cfg, **kw)
