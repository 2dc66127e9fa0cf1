"""DLRM MLPerf benchmark config (Criteo 1TB)  [arXiv:1906.00091] — the
port's copy of ``repro/configs/dlrm_mlperf.py``.

n_dense=13 n_sparse=26 embed_dim=128 bot_mlp=13-512-256-128
top_mlp=1024-1024-512-256-1 (the first top width is replaced by the
interaction's width, 479, at init), dot interaction.  The table sizes are
the MLPerf/Criteo-Terabyte cardinalities: 187,767,399 rows in all, 96.1 GB
in fp32 at dim 128 (the reference's docstring says ~880M rows; the sum of
its own tuple is this one).

One 80 GB card cannot hold them, so :func:`capped` caps each table at
``CARD_ROW_CAP`` = 2^24 rows: fields 0, 9, 19, 20 and 21 are cut, leaving
87,956,992 padded rows (45.0 GB in fp32).  Ids are taken modulo the padded
row count either way, so the cap narrows only the hash space; widths and
the number of fields are unchanged.

Training holds four copies of the tables (parameters, gradients and
AdamW's two moments), so it caps them at ``TRAIN_ROW_CAP`` = 2^22 rows:
25,042,432 padded rows, 12.8 GB a copy, 51.3 GB for the four.
"""

from __future__ import annotations

from .base import RecSysConfig, replace

# MLPerf DLRM (Criteo Terabyte, day_0-23) per-field cardinalities.
CRITEO_TABLE_SIZES = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36,
)

CONFIG = RecSysConfig(
    name="dlrm-mlperf",
    kind="dlrm",
    embed_dim=128,
    n_dense=13,
    n_sparse=26,
    bot_mlp=(13, 512, 256, 128),
    top_mlp=(1024, 1024, 512, 256, 1),
    table_sizes=CRITEO_TABLE_SIZES,
    n_items=1_000_000,
    interaction="dot",
)

CARD_ROW_CAP = 1 << 24
TRAIN_ROW_CAP = 1 << 22


def capped(cfg: RecSysConfig = CONFIG, max_rows: int = CARD_ROW_CAP) -> RecSysConfig:
    """``cfg`` with every table cut to at most ``max_rows`` rows."""
    return replace(cfg, table_sizes=tuple(min(s, max_rows) for s in cfg.table_sizes))
