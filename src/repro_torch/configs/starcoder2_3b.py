"""StarCoder2-3B  [arXiv:2402.19173] — the port's copy
of ``repro/configs/starcoder2_3b.py``.

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152 — GQA, RoPE,
GELU MLP (non-gated), tied embeddings, learned bias on projections.
"""

from .base import LMConfig

CONFIG = LMConfig(
    name="starcoder2-3b",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    qk_norm=False,
    qkv_bias=True,
    rope_theta=999999.4,
    act="gelu",
    norm="layernorm",
    mlp_bias=True,
    tie_embeddings=True,
)
