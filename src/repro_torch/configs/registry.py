"""Model configs the port serves — the port's copy of the reference's
``CE_TINY`` and ``dlrm-mlperf`` entries (``repro/configs/registry.py``),
field for field, and of ``smoke_config``'s recsys branch.

``QWEN3_8B_ATTENTION`` is the attention shape of Qwen3-8B (32 query heads,
8 KV heads, head_dim 128).  No path serves Qwen3-8B as a cross-encoder (its
config is causal, so position 0 would see only ``[CLS]``); the shape is
used only to check the flash-attention kernel at a large-model width.
"""

from __future__ import annotations

from . import dlrm_mlperf
from .base import LMConfig, replace

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

QWEN3_8B_ATTENTION = dict(n_heads=32, n_kv_heads=8, head_dim=128)

RECSYS = {"dlrm-mlperf": dlrm_mlperf.CONFIG}


def smoke_config(arch_id: str):
    """Reduced config of the same family for CPU tests (the reference's
    recsys branch, ``registry.py:126-135``)."""
    cfg = RECSYS[arch_id]
    kw = dict(embed_dim=16, n_items=1000, seq_len=min(cfg.seq_len, 8))
    if cfg.kind == "dlrm":
        kw.update(
            bot_mlp=(13, 32, 16), top_mlp=(64, 32, 1),
            table_sizes=tuple(min(s, 100) for s in cfg.table_sizes),
        )
    return replace(cfg, **kw)
