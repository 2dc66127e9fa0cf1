"""Neighbor sampling for minibatch GNN training (GraphSAGE-style fanout) —
the port's copy of ``repro/models/gnn/sampler.py``.

Host-side (numpy): builds a CSR adjacency once, then per batch samples a
fanout-bounded k-hop subgraph and pads it to static shapes.  This is the
real sampler the ``minibatch_lg`` shape requires (232K nodes / 114M
edges, fanout 15-10).  ``CSRGraph``, ``sample_subgraph`` and
``random_graph`` are the reference's numpy code line for line, so the same
``default_rng`` seed gives the same arrays in both packages.

Beside them, for graphs of a real deployment's size on the card:
``random_graph_device`` draws a graph of ``random_graph``'s law (senders
by Pareto(2) + 1 weights, receivers uniform) from a seeded
``torch.Generator`` (other numbers than numpy's), and
``csr_from_edge_index`` is ``CSRGraph.from_edge_index`` on torch tensors
(a stable sort by sender): on the same edges it gives the numpy version's
``indptr`` and ``indices`` bit for bit, on any device.
"""


from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass
class CSRGraph:
    indptr: np.ndarray      # (n_nodes+1,)
    indices: np.ndarray     # (n_edges,)
    n_nodes: int

    @staticmethod
    def from_edge_index(senders: np.ndarray, receivers: np.ndarray, n_nodes: int) -> "CSRGraph":
        order = np.argsort(senders, kind="stable")
        s, r = senders[order], receivers[order]
        counts = np.bincount(s, minlength=n_nodes)
        indptr = np.zeros(n_nodes + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return CSRGraph(indptr, r.astype(np.int32), n_nodes)

    def sample_neighbors(self, nodes: np.ndarray, fanout: int, rng: np.random.Generator):
        """Uniform fanout sampling: returns (senders, receivers) edge lists."""
        src, dst = [], []
        for v in nodes:
            lo, hi = self.indptr[v], self.indptr[v + 1]
            deg = hi - lo
            if deg == 0:
                continue
            take = min(fanout, deg)
            picks = rng.choice(deg, size=take, replace=False) + lo
            nbrs = self.indices[picks]
            src.append(nbrs)
            dst.append(np.full(take, v, dtype=np.int32))
        if not src:
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        return np.concatenate(src), np.concatenate(dst)


@dataclass
class SampledSubgraph:
    """Padded, statically-shaped subgraph batch for the jit'd step."""

    node_ids: np.ndarray      # (max_nodes,) original ids (padded with 0)
    node_mask: np.ndarray     # (max_nodes,) bool
    senders: np.ndarray       # (max_edges,) local ids
    receivers: np.ndarray     # (max_edges,)
    edge_mask: np.ndarray     # (max_edges,) bool
    seed_mask: np.ndarray     # (max_nodes,) True for the loss-bearing seeds


def sample_subgraph(
    graph: CSRGraph,
    seed_nodes: np.ndarray,
    fanouts: Tuple[int, ...],
    max_nodes: int,
    max_edges: int,
    rng: np.random.Generator,
) -> SampledSubgraph:
    """k-hop fanout sampling + relabel + pad to (max_nodes, max_edges)."""
    frontier = seed_nodes.astype(np.int64)
    all_src = []
    all_dst = []
    seen = set(frontier.tolist())
    for f in fanouts:
        src, dst = graph.sample_neighbors(frontier, f, rng)
        all_src.append(src)
        all_dst.append(dst)
        new = np.unique(src)
        frontier = np.array([v for v in new if v not in seen], dtype=np.int64)
        seen.update(frontier.tolist())
        if frontier.size == 0:
            break
    src = np.concatenate(all_src) if all_src else np.zeros(0, np.int32)
    dst = np.concatenate(all_dst) if all_dst else np.zeros(0, np.int32)

    node_ids = np.unique(np.concatenate([seed_nodes, src, dst]))
    if node_ids.size > max_nodes:        # truncate (keep seeds first)
        others = np.setdiff1d(node_ids, seed_nodes, assume_unique=False)
        node_ids = np.concatenate([seed_nodes, others])[:max_nodes]
    relabel = {v: i for i, v in enumerate(node_ids.tolist())}
    keep = np.array(
        [s in relabel and d in relabel for s, d in zip(src.tolist(), dst.tolist())],
        dtype=bool,
    )
    src, dst = src[keep][:max_edges], dst[keep][:max_edges]
    loc_s = np.array([relabel[v] for v in src.tolist()], dtype=np.int32)
    loc_d = np.array([relabel[v] for v in dst.tolist()], dtype=np.int32)

    n, e = node_ids.size, loc_s.size
    out = SampledSubgraph(
        node_ids=np.zeros(max_nodes, np.int32),
        node_mask=np.zeros(max_nodes, bool),
        senders=np.zeros(max_edges, np.int32),
        receivers=np.zeros(max_edges, np.int32),
        edge_mask=np.zeros(max_edges, bool),
        seed_mask=np.zeros(max_nodes, bool),
    )
    out.node_ids[:n] = node_ids
    out.node_mask[:n] = True
    out.senders[:e] = loc_s
    out.receivers[:e] = loc_d
    out.edge_mask[:e] = True
    out.seed_mask[: seed_nodes.size] = True
    return out


def random_graph(n_nodes: int, n_edges: int, seed: int = 0):
    """Synthetic power-law-ish graph for tests/benchmarks."""
    rng = np.random.default_rng(seed)
    # preferential-attachment-flavoured degree skew
    weights = rng.pareto(2.0, n_nodes) + 1.0
    weights /= weights.sum()
    senders = rng.choice(n_nodes, size=n_edges, p=weights).astype(np.int32)
    receivers = rng.integers(0, n_nodes, size=n_edges).astype(np.int32)
    return senders, receivers


def csr_from_edge_index(senders, receivers, n_nodes: int):
    """``CSRGraph.from_edge_index`` on tensors of any device: ``(indptr
    (n_nodes + 1,) int64, indices (n_edges,) int32)``, the edges ordered by
    a stable sort on the sender (numpy's stable ``argsort``)."""
    import torch

    order = torch.sort(senders, stable=True).indices
    counts = torch.bincount(senders.long(), minlength=n_nodes)
    indptr = torch.zeros(n_nodes + 1, dtype=torch.int64, device=senders.device)
    torch.cumsum(counts, 0, out=indptr[1:])
    return indptr, receivers[order].to(torch.int32)


def to_host_csr(indptr, indices, n_nodes: int) -> CSRGraph:
    """A ``CSRGraph`` (numpy) from :func:`csr_from_edge_index`'s tensors."""
    return CSRGraph(indptr.cpu().numpy(), indices.cpu().numpy(), n_nodes)


def random_graph_device(n_nodes: int, n_edges: int, generator):
    """``random_graph``'s law drawn on ``generator``'s device: Pareto(2) + 1
    sender weights (numpy's ``pareto(2.0)`` is ``exp(Exp(1) / 2) - 1``), the
    senders by inverse CDF of the float64 cumulative weights, the receivers
    uniform; (senders, receivers) int32."""
    import torch

    dev = generator.device
    w = torch.empty(n_nodes, dtype=torch.float64, device=dev).exponential_(generator=generator)
    cdf = torch.cumsum(torch.exp(w * 0.5), 0)
    u = torch.rand(n_edges, dtype=torch.float64, device=dev, generator=generator) * cdf[-1]
    senders = torch.searchsorted(cdf, u, right=True).clamp_(max=n_nodes - 1).to(torch.int32)
    del u
    receivers = torch.randint(0, n_nodes, (n_edges,), generator=generator, device=dev,
                              dtype=torch.int32)
    return senders, receivers
