"""Named step shapes — the port's copy of ``LM_SHAPES`` and
``RECSYS_SHAPES`` (``repro/configs/shapes.py``).

``decode_*`` / ``long_*`` are one new token against a KV cache of
``seq_len`` entries (``launch/steps.py::build_lm_decode``), not a train
step.  The reference serves long_500k with a sequence-parallel cache over
a mesh; the port decodes on one card, where the full cache fits for the
smaller models only (PERF.md §4).
"""

from __future__ import annotations

from .base import LMShape, RecSysShape

LM_SHAPES = {
    "train_4k": LMShape("train_4k", "train", seq_len=4096, global_batch=256),
    "prefill_32k": LMShape("prefill_32k", "prefill", seq_len=32768, global_batch=32),
    "decode_32k": LMShape("decode_32k", "decode", seq_len=32768, global_batch=128),
    "long_500k": LMShape("long_500k", "decode", seq_len=524288, global_batch=1),
}

RECSYS_SHAPES = {
    "train_batch": RecSysShape("train_batch", "train", batch=65536),
    "serve_p99": RecSysShape("serve_p99", "serve", batch=512),
    "serve_bulk": RecSysShape("serve_bulk", "serve", batch=262144),
    "retrieval_cand": RecSysShape(
        "retrieval_cand", "retrieval", batch=1, n_candidates=1_000_000
    ),
}

# the families the port serves (the reference's GNN shapes wait for the
# GNN slice, ROADMAP.md queue 1)
SHAPES_BY_FAMILY = {
    "lm": LM_SHAPES,
    "recsys": RECSYS_SHAPES,
}
