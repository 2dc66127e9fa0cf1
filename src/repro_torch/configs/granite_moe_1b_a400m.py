"""Granite-3.0-1B-A400M  [hf:ibm-granite/granite-3.0-1b-a400m-base] — the port's copy
of ``repro/configs/granite_moe_1b_a400m.py``.

24L d_model=1024 16H (GQA kv=8) per-expert d_ff=512 vocab=49155,
MoE 32 experts top-8, tied embeddings.
"""

from .base import LMConfig, MoEConfig

CONFIG = LMConfig(
    name="granite-moe-1b-a400m",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    qk_norm=False,
    qkv_bias=False,
    rope_theta=10000.0,
    act="swiglu",
    tie_embeddings=True,
    moe=MoEConfig(n_experts=32, top_k=8, d_expert=512),
)
