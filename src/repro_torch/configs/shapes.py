"""Named step shapes — the port's copy of ``RECSYS_SHAPES`` and of
``LM_SHAPES``' training shape (``repro/configs/shapes.py``)."""

from __future__ import annotations

from .base import LMShape, RecSysShape

LM_SHAPES = {
    "train_4k": LMShape("train_4k", "train", seq_len=4096, global_batch=256),
}

RECSYS_SHAPES = {
    "train_batch": RecSysShape("train_batch", "train", batch=65536),
    "serve_p99": RecSysShape("serve_p99", "serve", batch=512),
    "serve_bulk": RecSysShape("serve_bulk", "serve", batch=262144),
    "retrieval_cand": RecSysShape(
        "retrieval_cand", "retrieval", batch=1, n_candidates=1_000_000
    ),
}
