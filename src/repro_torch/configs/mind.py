"""MIND: Multi-Interest Network with Dynamic routing  [arXiv:1904.08030] —
the port's copy of ``repro/configs/mind.py``.

embed_dim=64 n_interests=4 capsule_iters=3: a dual-encoder-style
multi-interest retriever.  Not an ADACUR target (its scores are a max over
dot products); it serves as the first-round anchor retriever (the paper's
DE_BASE role).
"""

from .base import RecSysConfig

CONFIG = RecSysConfig(
    name="mind",
    kind="mind",
    embed_dim=64,
    seq_len=50,
    n_interests=4,
    capsule_iters=3,
    n_items=1_000_000,
    interaction="multi-interest",
)
