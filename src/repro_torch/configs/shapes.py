"""Named step shapes — the port's copy of ``LM_SHAPES``, ``GNN_SHAPES``
and ``RECSYS_SHAPES`` (``repro/configs/shapes.py``).

``decode_*`` / ``long_*`` are one new token against a KV cache of
``seq_len`` entries (``launch/steps.py::build_lm_decode``), not a train
step.  The reference serves long_500k with a sequence-parallel cache over
a mesh; the port decodes on one card, where the full cache fits for the
smaller models only (PERF.md §4).
"""

from __future__ import annotations

from .base import GraphShape, LMShape, RecSysShape

LM_SHAPES = {
    "train_4k": LMShape("train_4k", "train", seq_len=4096, global_batch=256),
    "prefill_32k": LMShape("prefill_32k", "prefill", seq_len=32768, global_batch=32),
    "decode_32k": LMShape("decode_32k", "decode", seq_len=32768, global_batch=128),
    "long_500k": LMShape("long_500k", "decode", seq_len=524288, global_batch=1),
}

GNN_SHAPES = {
    "full_graph_sm": GraphShape(
        "full_graph_sm", "full", n_nodes=2708, n_edges=10556, d_feat=1433
    ),
    "minibatch_lg": GraphShape(
        "minibatch_lg",
        "minibatch",
        n_nodes=232965,
        n_edges=114615892,
        batch_nodes=1024,
        fanout=(15, 10),
    ),
    "ogb_products": GraphShape(
        "ogb_products", "full", n_nodes=2449029, n_edges=61859140, d_feat=100
    ),
    "molecule": GraphShape(
        "molecule", "molecule", n_nodes=30, n_edges=64, batch_graphs=128
    ),
}

RECSYS_SHAPES = {
    "train_batch": RecSysShape("train_batch", "train", batch=65536),
    "serve_p99": RecSysShape("serve_p99", "serve", batch=512),
    "serve_bulk": RecSysShape("serve_bulk", "serve", batch=262144),
    "retrieval_cand": RecSysShape(
        "retrieval_cand", "retrieval", batch=1, n_candidates=1_000_000
    ),
}

SHAPES_BY_FAMILY = {
    "lm": LM_SHAPES,
    "gnn": GNN_SHAPES,
    "recsys": RECSYS_SHAPES,
}
