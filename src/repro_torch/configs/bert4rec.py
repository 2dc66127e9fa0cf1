"""BERT4Rec  [arXiv:1904.06690] — the port's copy of
``repro/configs/bert4rec.py``.

embed_dim=64 n_blocks=2 n_heads=2 seq_len=200: a bidirectional transformer
over the interaction sequence; a joint (sequence, item) scorer.
"""

from .base import RecSysConfig

CONFIG = RecSysConfig(
    name="bert4rec",
    kind="bert4rec",
    embed_dim=64,
    seq_len=200,
    n_blocks=2,
    n_heads=2,
    mlp_dims=(256,),
    n_items=1_000_000,
    interaction="bidir-seq",
)
