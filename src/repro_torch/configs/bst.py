"""Behavior Sequence Transformer (Alibaba)  [arXiv:1905.06874] — the port's
copy of ``repro/configs/bst.py``.

embed_dim=32 seq_len=20 n_blocks=1 n_heads=8 mlp=1024-512-256, a
transformer over the user behaviour sequence plus the target item (a joint
query-item scorer, so a cross-encoder-class model for ADACUR).
"""

from .base import RecSysConfig

CONFIG = RecSysConfig(
    name="bst",
    kind="bst",
    embed_dim=32,
    seq_len=20,
    n_blocks=1,
    n_heads=8,
    mlp_dims=(1024, 512, 256),
    n_items=1_000_000,
    interaction="transformer-seq",
)
