"""Qwen1.5-110B  [hf:Qwen/Qwen1.5-110B; config family per hf:Qwen/Qwen1.5-0.5B] — the port's copy
of ``repro/configs/qwen1_5_110b.py``.

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064 — QKV bias,
SwiGLU, RoPE theta 1e6.
"""

from .base import LMConfig

CONFIG = LMConfig(
    name="qwen1.5-110b",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=49152,
    vocab_size=152064,
    qk_norm=False,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    act="swiglu",
)
