"""Moonlight-16B-A3B (moonshot-v1-16b-a3b)  [hf:moonshotai/Moonlight-16B-A3B] — the port's copy
of ``repro/configs/moonshot_v1_16b_a3b.py``.

48L d_model=2048 16H (kv=16, i.e. MHA) per-expert d_ff=1408 vocab=163840,
MoE 64 experts top-6, 2 shared experts, first layer dense (d_ff 11264) —
DeepSeek-V3-style layout.
"""

from .base import LMConfig, MoEConfig

CONFIG = LMConfig(
    name="moonshot-v1-16b-a3b",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163840,
    qk_norm=False,
    qkv_bias=False,
    rope_theta=50000.0,
    act="swiglu",
    moe=MoEConfig(
        n_experts=64,
        top_k=6,
        d_expert=1408,
        n_shared_experts=2,
        first_k_dense=1,
        d_ff_dense=11264,
    ),
)
