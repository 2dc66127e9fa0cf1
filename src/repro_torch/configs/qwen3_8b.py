"""Qwen3-8B  [hf:Qwen/Qwen3-8B] — the port's copy
of ``repro/configs/qwen3_8b.py``.

36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936 — qk_norm, GQA,
head_dim=128, SwiGLU, RoPE theta 1e6, untied embeddings.
"""

from .base import LMConfig

CONFIG = LMConfig(
    name="qwen3-8b",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,
    qkv_bias=False,
    rope_theta=1_000_000.0,
    act="swiglu",
)
