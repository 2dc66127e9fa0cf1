"""NequIP: E(3)-equivariant interatomic potential [arXiv:2101.03164] — port
of ``repro/models/gnn/nequip.py`` on one device.

- Features are irreps l = 0..2 with ``d_hidden`` channels, in Cartesian
  form, kept as one node table (N, 13, h): s, then v_0..2, then the
  symmetric-traceless t_ij at 4 + 3i + j, each a row of h channels (the
  reference's s (N, h), v (N, h, 3) and t (N, h, 3, 3), transposed).  A
  gather or a scatter then moves one row of 13h floats a node.
- Messages are the reference's 11 tensor-product paths
  (``kernels/tensor_product``: a hand-written kernel on the card, its plain
  version on the CPU), under per-edge radial weights from the Bessel basis.
- Message passing (:func:`message_passing`) is deterministic, with no
  floating-point atomics: the edges are sorted by receiver once a forward
  (a stable sort), each chunk of them gathers its senders' rows (the bag
  kernel) and sums its messages by receiver over its own contiguous row
  range (the bag's backward kernel), and the chunks add in order.  Its
  backward walks the edges sorted by sender, so the sender gather's
  gradient is the same range-local sum.  Activations are recomputed a
  chunk at a time, never stored for all edges.
- Every other gather (positions by edge, the species embedding) is the bag
  kernel too, and the per-graph energy sum the bag's backward kernel
  (``kernels/embedding_bag/ops.py::gather_rows`` / ``segment_sum``), so
  their gradients are deterministic as well.

- Over a mesh, :func:`make_sharded_interact` is the reference's
  receiver-partitioned, channel-parallel block: each rank holds a (node
  shard, channel block) of the table, its edges have their receivers in
  its node range, one all-gather over the node axis brings its channels of
  every sender, the scatter stays shard-local, and only the channel-mixing
  linears cross the channel axis (one reduce-scatter).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ...configs.base import GNNConfig
from ...device import resolve_device, to_device
from ...kernels.embedding_bag.ops import (embedding_bag_backward, embedding_bag_op,
                                          gather_rows, segment_sum)
from ...kernels.tensor_product.ops import tensor_product, tensor_product_backward
from ...kernels.tensor_product.ref import IRREP_ROWS, PATHS
from ..layers import dense_init

EDGE_CHUNK = 262144        # the reference's edge_chunk (_interact_inner_tp)
RADIAL_HIDDEN = 16


def _sym_traceless(m: torch.Tensor) -> torch.Tensor:
    """The symmetric-traceless part over the last two dims (..., 3, 3)."""
    m = 0.5 * (m + m.transpose(-1, -2))
    tr = torch.diagonal(m, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    eye = torch.eye(3, dtype=m.dtype, device=m.device)
    return m - tr * eye / 3.0


def bessel_basis(r: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """Radial Bessel basis with the smooth polynomial cutoff envelope (paper)."""
    r = torch.clamp(r, min=1e-6)
    n = torch.arange(1, n_rbf + 1, dtype=r.dtype, device=r.device)
    basis = (2.0 / cutoff) ** 0.5 * torch.sin(n * torch.pi * r[..., None] / cutoff) / r[..., None]
    x = torch.clamp(r / cutoff, 0.0, 1.0)
    # p=6 polynomial envelope: 1 - 28x^6 + 48x^7 - 21x^8 (C^2-smooth at cutoff)
    env = 1.0 - 28.0 * x ** 6 + 48.0 * x ** 7 - 21.0 * x ** 8
    return basis * env[..., None]


def _radial_mlp_init(gen: torch.Generator, n_rbf: int, n_out: int,
                     hidden: int = RADIAL_HIDDEN) -> dict:
    return {"w1": dense_init(gen, (n_rbf, hidden)), "w2": dense_init(gen, (hidden, n_out))}


def _radial_mlp(w1: torch.Tensor, w2: torch.Tensor, rbf: torch.Tensor) -> torch.Tensor:
    return F.silu(rbf @ w1) @ w2


def _layer_init(gen: torch.Generator, cfg: GNNConfig) -> dict:
    h = cfg.d_hidden
    lin = {
        # post-aggregation channel mixing per irrep; gates for v and t
        "w_s": dense_init(gen, (2 * h, h)),
        "w_v": dense_init(gen, (2 * h, h)),
        "w_t": dense_init(gen, (2 * h, h)),
        "w_gate": dense_init(gen, (2 * h, 2 * h)),
    }
    return {"lin": lin, "radial": _radial_mlp_init(gen, cfg.n_rbf, len(PATHS) * h)}


def init_nequip(cfg: GNNConfig, generator: torch.Generator, d_feat: int = 0,
                device=None) -> dict:
    """The reference's parameter tree drawn from ``generator`` on its own
    device (the port's draws, not JAX's bits; the reference's shapes and
    scales), then moved to ``device`` (default ``"cuda"``; without a card it
    raises unless ``device="cpu"``): ``d_feat > 0`` projects raw node
    features in, else a species embedding."""
    dev = resolve_device(device)
    h = cfg.d_hidden
    params: Dict = {}
    if d_feat > 0:
        params["embed"] = dense_init(generator, (d_feat, h))
    else:
        params["embed"] = dense_init(generator, (cfg.n_species, h), scale=1.0)
    params["layers"] = [_layer_init(generator, cfg) for _ in range(cfg.n_layers)]
    params["readout1"] = dense_init(generator, (h, h))
    params["readout2"] = dense_init(generator, (h, 1))
    return to_device(params, dev)


def param_specs(cfg: GNNConfig, d_feat: int = 0) -> dict:
    """The logical axes of every leaf of :func:`init_nequip`'s tree (the
    reference's second return value of ``init_nequip``)."""
    layer = {"lin": {k: ("ch_in", "ch") for k in ("w_s", "w_v", "w_t", "w_gate")},
             "radial": {"w1": ("rbf", "mlp"), "w2": ("mlp", "radial_out")}}
    return {"embed": ("feat", "ch") if d_feat > 0 else ("species", "ch"),
            "layers": [{"lin": dict(layer["lin"]), "radial": dict(layer["radial"])}
                       for _ in range(cfg.n_layers)],
            "readout1": ("ch_in", "ch"), "readout2": ("ch_in", "unit")}


# ---------------------------------------------------------------------------
# the edge graph and its geometry
# ---------------------------------------------------------------------------


@dataclass
class EdgeGraph:
    """A forward's edges, sorted by receiver (stable), and the order of its
    backward, sorted by sender: per chunk of each, its edge range and its
    node range [lo, hi].  Built once a forward (:func:`edge_graph`); the
    layers share it."""

    n_nodes: int
    order: torch.Tensor          # (E,) int64: sorted position -> input edge
    senders: torch.Tensor        # (E,) int32, receiver-sorted order
    receivers: torch.Tensor      # (E,) int32, ascending
    chunks: List[Tuple[int, int, int, int]]       # (start, end, lo, hi)
    by_sender: torch.Tensor      # (E,) int64: sender-sorted position -> edge
    senders_s: torch.Tensor      # senders in that order, ascending
    chunks_s: List[Tuple[int, int, int, int]]


def _chunks(keys: torch.Tensor, chunk: int) -> list:
    """Cut ascending ``keys`` (E,) into chunks of ``chunk``: [(start, end,
    lo, hi)], lo and hi the chunk's first and last key.  One host read."""
    e = keys.numel()
    starts = list(range(0, e, chunk))
    ends = [min(s + chunk, e) for s in starts]
    if not starts:
        return []
    idx = torch.tensor([i for s, t in zip(starts, ends) for i in (s, t - 1)],
                       device=keys.device)
    bounds = keys[idx].tolist()
    return [(s, t, bounds[2 * i], bounds[2 * i + 1]) for i, (s, t) in enumerate(zip(starts, ends))]


def edge_graph(senders: torch.Tensor, receivers: torch.Tensor, n_nodes: int,
               edge_chunk: Optional[int] = None) -> EdgeGraph:
    """The sorted edge orders of one forward (``edge_chunk`` None: one chunk)."""
    e = senders.numel()
    chunk = max(1, e if edge_chunk is None else edge_chunk)
    senders, receivers = senders.to(torch.int32), receivers.to(torch.int32)
    rs, order = torch.sort(receivers, stable=True)
    ss = senders[order]
    s_sorted, by_sender = torch.sort(ss, stable=True)
    return EdgeGraph(n_nodes, order, ss, rs, _chunks(rs, chunk), by_sender, s_sorted,
                     _chunks(s_sorted, chunk))


def _edge_geometry(positions, graph: EdgeGraph, cfg: GNNConfig, offset: int = 0):
    """(rhat (E, 3), y2 (E, 3, 3), rbf (E, n_rbf)) in the graph's order;
    the positions' gathers are the bag kernel (differentiable).  A graph of
    one node shard numbers its receivers from ``offset`` in ``positions``."""
    receivers = graph.receivers + offset if offset else graph.receivers
    rel = gather_rows(positions, receivers) - gather_rows(positions, graph.senders)
    r = torch.sqrt(torch.sum(rel * rel, dim=-1) + 1e-12)
    rhat = rel / r[:, None]
    rbf = bessel_basis(r, cfg.n_rbf, cfg.cutoff)
    # Y1 = rhat ; Y2 = sym-traceless(rhat rhat^T)
    y2 = _sym_traceless(rhat[:, :, None] * rhat[:, None, :])
    return rhat, y2, rbf


# ---------------------------------------------------------------------------
# message passing
# ---------------------------------------------------------------------------


def _add_rows(acc: torch.Tensor, part: torch.Tensor, lo: int) -> None:
    acc[lo:lo + part.shape[0]] += part


class _MessagePassing(torch.autograd.Function):
    """agg (N, 13h) = Σ over edges of the tensor-product message, by receiver."""

    @staticmethod
    def forward(ctx, table, w1, w2, rhat, y2, rbf, graph: EdgeGraph, h: int):
        n = graph.n_nodes
        agg = torch.zeros((n, IRREP_ROWS * h), dtype=torch.float32, device=table.device)
        for a, b, lo, hi in graph.chunks:
            x = embedding_bag_op(table, graph.senders[a:b, None], "sum")
            w = _radial_mlp(w1, w2, rbf[a:b])
            m = tensor_product(x.view(-1, IRREP_ROWS, h), w.view(-1, len(PATHS), h),
                               rhat[a:b], y2[a:b])
            _add_rows(agg, embedding_bag_backward(m.view(b - a, -1),
                                                  (graph.receivers[a:b] - lo)[:, None],
                                                  hi - lo + 1), lo)
        ctx.save_for_backward(table, w1, w2, rhat, y2, rbf)
        ctx.graph, ctx.h = graph, h
        return agg

    @staticmethod
    def backward(ctx, d_agg):
        table, w1, w2, rhat, y2, rbf = ctx.saved_tensors
        graph, h = ctx.graph, ctx.h
        need_x, need_w1, need_w2, need_r, need_y, need_b = ctx.needs_input_grad[:6]
        geometry = need_r or need_y or need_b
        d_agg = d_agg.contiguous()
        d_table = torch.zeros_like(table) if need_x else None
        dw1, dw2 = torch.zeros_like(w1), torch.zeros_like(w2)
        d_rhat = torch.zeros_like(rhat) if geometry else None
        d_y2 = torch.zeros_like(y2) if geometry else None
        d_rbf = torch.zeros_like(rbf) if geometry else None
        for a, b, lo, hi in graph.chunks_s:
            idx = graph.by_sender[a:b]
            x = embedding_bag_op(table, graph.senders_s[a:b, None], "sum")
            g = embedding_bag_op(d_agg, graph.receivers[idx, None], "sum")
            rh, yy = rhat[idx], y2[idx]
            with torch.enable_grad():
                p1, p2 = w1.detach().requires_grad_(), w2.detach().requires_grad_()
                rb = rbf[idx].requires_grad_(geometry)
                w = _radial_mlp(p1, p2, rb)
            dx, dw, dr, dy = tensor_product_backward(
                x.view(-1, IRREP_ROWS, h), w.detach().view(-1, len(PATHS), h), rh, yy,
                g.view(-1, IRREP_ROWS, h), geometry)
            if need_x:
                _add_rows(d_table, embedding_bag_backward(dx.view(b - a, -1),
                                                          (graph.senders_s[a:b] - lo)[:, None],
                                                          hi - lo + 1), lo)
            grads = torch.autograd.grad(w, (p1, p2, rb) if geometry else (p1, p2),
                                        dw.view(b - a, -1))
            dw1 += grads[0]
            dw2 += grads[1]
            if geometry:
                d_rhat[idx], d_y2[idx], d_rbf[idx] = dr, dy, grads[2]
        return (d_table, dw1 if need_w1 else None, dw2 if need_w2 else None,
                d_rhat if need_r else None, d_y2 if need_y else None,
                d_rbf if need_b else None, None, None)


def message_passing(table: torch.Tensor, radial: dict, rhat, y2, rbf, graph: EdgeGraph,
                    h: int) -> torch.Tensor:
    """(N, 13h) sums by receiver of every edge's tensor-product message,
    the senders' rows of ``table`` (N, 13h) under the radial MLP of ``rbf``;
    differentiable in the table, the radial weights and the geometry."""
    return _MessagePassing.apply(table, radial["w1"], radial["w2"], rhat, y2, rbf, graph, h)


# ---------------------------------------------------------------------------
# the interaction block and the model
# ---------------------------------------------------------------------------


def _interact(lp, x: torch.Tensor, graph: EdgeGraph, rhat, y2, rbf) -> torch.Tensor:
    """One interaction block on the node table ``x`` (N, 13, h): messages
    summed by receiver over the graph's chunks, then the self-interaction
    (concat(old, aggregated) -> channel mix per irrep) and the gates.  A
    graph of one chunk is the reference's ``_interact``; of edge chunks,
    its ``_interact_inner_tp`` on one rank (no radial slice, the mix a
    plain matmul)."""
    n, _, h = x.shape
    agg = message_passing(x.reshape(n, -1), lp["radial"], rhat, y2, rbf, graph,
                          h).view(n, IRREP_ROWS, h)
    lin = lp["lin"]
    return _SelfInteraction.apply(x, agg, lin["w_s"], lin["w_v"], lin["w_t"], lin["w_gate"])


_IRREPS = (slice(0, 1), slice(1, 4), slice(4, IRREP_ROWS))     # s, v, t rows of the table


def _mix_forward(x, agg, w_s, w_v, w_t, w_gate):
    """The pre-activations of the self-interaction: concat(old, aggregated)
    @ w per irrep and for the gates, as the two halves' products summed."""
    h = x.shape[2]
    pre = [x[:, r] @ w[:h] + agg[:, r] @ w[h:] for r, w in zip(_IRREPS, (w_s, w_v, w_t))]
    gates = torch.sigmoid(x[:, 0] @ w_gate[:h] + agg[:, 0] @ w_gate[h:])
    return pre, gates[:, None, :h], gates[:, None, h:]


class _SelfInteraction(torch.autograd.Function):
    """out = (s + silu(new_s), v + g_v new_v, t + g_t new_t) from the old
    table ``x`` (N, 13, h) and the aggregated one: the reference's
    ``lin`` mix and gates.  Saves only its inputs and writes each gradient
    into one buffer, so no (N, 13, 2h) concatenation and no full-size
    gradient per row slice is ever stored."""

    @staticmethod
    def forward(ctx, x, agg, w_s, w_v, w_t, w_gate):
        (s, v, t), g_v, g_t = _mix_forward(x, agg, w_s, w_v, w_t, w_gate)
        out = torch.empty_like(x)
        out[:, 0:1] = x[:, 0:1] + F.silu(s)
        out[:, 1:4] = x[:, 1:4] + g_v * v
        out[:, 4:] = x[:, 4:] + g_t * t
        ctx.save_for_backward(x, agg, w_s, w_v, w_t, w_gate)
        return out

    @staticmethod
    def backward(ctx, d_out):
        x, agg, w_s, w_v, w_t, w_gate = ctx.saved_tensors
        h = x.shape[2]
        (s, v, t), g_v, g_t = _mix_forward(x, agg, w_s, w_v, w_t, w_gate)
        sig = torch.sigmoid(s)
        d_s = d_out[:, 0:1] * (sig * (1 + s * (1 - sig)))            # silu'
        d_v, d_t = d_out[:, 1:4] * g_v, d_out[:, 4:] * g_t
        d_gate = torch.cat([(d_out[:, 1:4] * v).sum(1) * g_v[:, 0] * (1 - g_v[:, 0]),
                            (d_out[:, 4:] * t).sum(1) * g_t[:, 0] * (1 - g_t[:, 0])], dim=1)
        d_x, d_agg = d_out.clone(), torch.empty_like(agg)
        for r, d, w in zip(_IRREPS, (d_s, d_v, d_t), (w_s, w_v, w_t)):
            d_x[:, r] += d @ w[:h].T
            d_agg[:, r] = d @ w[h:].T
        d_x[:, 0] += d_gate @ w_gate[:h].T
        d_agg[:, 0] += d_gate @ w_gate[h:].T
        d_w = [torch.cat([torch.einsum("nrh,nrk->hk", x[:, r], d),
                          torch.einsum("nrh,nrk->hk", agg[:, r], d)])
               for r, d in zip(_IRREPS, (d_s, d_v, d_t))]
        d_wg = torch.cat([x[:, 0].T @ d_gate, agg[:, 0].T @ d_gate])
        return d_x, d_agg, d_w[0], d_w[1], d_w[2], d_wg


class ShardedInteract:
    """The interaction block over a mesh (:func:`make_sharded_interact`),
    and what :func:`forward` needs around it: this rank's node range and
    channel block, and the collectives over the two axes."""

    def __init__(self, mesh, node_axis: str = "data", channel_axis: Optional[str] = "model"):
        from ...distributed.fsdp import mesh_group
        from ...distributed.sharding import mesh_coordinate, mesh_dims

        dims, coord = mesh_dims(mesh), mesh_coordinate(mesh)
        self.mesh, self.node_axis, self.channel_axis = mesh, node_axis, channel_axis
        self.n_node_shards, self.node_shard = dims[node_axis], coord[node_axis]
        self.tp = dims[channel_axis] if channel_axis else 1
        self.crank = coord[channel_axis] if channel_axis else 0
        self.node_group = mesh_group(mesh, (node_axis,))
        self.channel_group = mesh_group(mesh, (channel_axis,)) if channel_axis else None

    def channels(self, h: int) -> slice:
        """This rank's block of ``h`` channels."""
        if h % self.tp:
            raise ValueError(f"{h} channels do not split over {self.tp} channel shards")
        hl = h // self.tp
        return slice(self.crank * hl, (self.crank + 1) * hl)

    def gather_nodes(self, x: torch.Tensor) -> torch.Tensor:
        from ...distributed.fsdp import all_gather

        return all_gather(x, self.node_group, 0)

    def sum_nodes(self, x: torch.Tensor) -> torch.Tensor:
        from ...distributed.fsdp import all_reduce

        return all_reduce(x, self.node_group)

    def gather_channels(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        from ...distributed.fsdp import all_gather

        return all_gather(x, self.channel_group, dim)

    def __call__(self, lp, x: torch.Tensor, graph: EdgeGraph, rhat, y2, rbf) -> torch.Tensor:
        """One block on this rank's (n_local, 13, h / tp) table: the
        reference's ``make_sharded_interact`` body over
        ``_interact_inner_tp``."""
        from ...distributed.fsdp import reduce_scatter

        n, _, hl = x.shape
        h = hl * self.tp
        # sender rows: every node's row of this rank's channels
        full = self.gather_nodes(x.reshape(n, -1))
        w2 = lp["radial"]["w2"]
        w2 = w2.view(w2.shape[0], len(PATHS), h)[:, :, self.channels(h)].reshape(w2.shape[0], -1)
        agg = message_passing(full, {"w1": lp["radial"]["w1"], "w2": w2}, rhat, y2, rbf,
                              graph, hl).view(n, IRREP_ROWS, hl)
        # channel-parallel mix: each rank's rows of w (its input channels in
        # both halves of concat(old, aggregated)) make a partial product
        # over every output channel; one reduce-scatter sums them over the
        # channel axis and hands each rank its output block.  The v and t
        # gate halves keep their own blocks (the reference's two
        # psum_scatters), since the output channels lie tp-major.
        lin, rows = lp["lin"], self.channels(h)

        def part(w, r, cols=slice(None)):
            return x[:, r] @ w[rows, cols] + agg[:, r] @ w[h + rows.start:h + rows.stop, cols]

        pre = torch.cat([part(w, r) for r, w in zip(_IRREPS, (lin["w_s"], lin["w_v"], lin["w_t"]))]
                        + [part(lin["w_gate"], slice(0, 1), slice(0, h)),
                           part(lin["w_gate"], slice(0, 1), slice(h, 2 * h))], dim=1)
        pre = pre.view(n, IRREP_ROWS + 2, self.tp, hl).permute(2, 0, 1, 3)
        mine = reduce_scatter(pre.reshape(self.tp * n, IRREP_ROWS + 2, hl),
                              self.channel_group, 0)
        s, v, t = mine[:, 0:1], mine[:, 1:4], mine[:, 4:IRREP_ROWS]
        g_v = torch.sigmoid(mine[:, IRREP_ROWS:IRREP_ROWS + 1])
        g_t = torch.sigmoid(mine[:, IRREP_ROWS + 1:])
        return torch.cat([x[:, 0:1] + F.silu(s), x[:, 1:4] + g_v * v, x[:, 4:] + g_t * t], dim=1)


def make_sharded_interact(mesh, node_axis: str = "data",
                          channel_axis: Optional[str] = "model") -> ShardedInteract:
    """Receiver-partitioned, channel-parallel message passing — the
    reference's ``make_sharded_interact`` (pod-scale graphs).

    - ``node_axis``: a rank's edges have their receivers in its node range
      (the graph-partitioning contract), so every scatter-add is
      shard-local; the one node-axis collective is the all-gather of this
      rank's channels of the sender features (its adjoint in the backward a
      reduce-scatter).
    - ``channel_axis``: the irrep channels are tensor-parallel — every
      tensor-product path is channelwise, so each rank gathers and computes
      only its h / tp channels (the radial weights sliced to them, the
      tensor-product kernel at h / tp); only the channel-mixing linears
      contract across ranks (one reduce-scatter a block).

    The features stay sharded (node, channel) between blocks.  Pass the
    result as :func:`forward`'s ``interact_fn``: the forward then takes this
    rank's node shard (positions, attributes, masks) and its edge block in
    global node ids."""
    return ShardedInteract(mesh, node_axis, channel_axis)


def features(x: torch.Tensor) -> dict:
    """The node table as the reference's {"s" (N, h), "v" (N, h, 3),
    "t" (N, h, 3, 3)}."""
    n, _, h = x.shape
    return {"s": x[:, 0], "v": x[:, 1:4].transpose(1, 2),
            "t": x[:, 4:].reshape(n, 3, 3, h).permute(0, 3, 1, 2)}


def forward(params, cfg: GNNConfig, positions: torch.Tensor, node_attr: torch.Tensor,
            senders: torch.Tensor, receivers: torch.Tensor,
            edge_mask: Optional[torch.Tensor] = None,
            node_mask: Optional[torch.Tensor] = None,
            graph_ids: Optional[torch.Tensor] = None, n_graphs: int = 1,
            remat: bool = False, edge_chunk: Optional[int] = None,
            interact_fn: Optional[ShardedInteract] = None) -> torch.Tensor:
    """Per-graph potential energies (n_graphs,) — ((1,) without graph_ids).
    ``edge_chunk`` cuts the edges into chunks of that many (the reference's
    ``_interact_inner_tp``; None: one chunk, its ``_interact``); ``remat``
    recomputes each interaction block in the backward
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``).

    With ``interact_fn`` (:func:`make_sharded_interact`) the tensors are
    this rank's: its node shard of ``positions``, ``node_attr``,
    ``node_mask`` and ``graph_ids``, and its edge block (receivers in its
    node range, ids global); the features live as (node shard, channel
    block) and every rank returns the whole graph's energies.  The
    reference's ``feat_spec`` (the features' sharding constraint) is the
    interact's ``node_axis`` here."""
    si = interact_fn
    n_nodes = positions.shape[0]
    h = cfg.d_hidden
    if node_attr.dim() == 1:
        s = gather_rows(params["embed"], torch.remainder(
            node_attr.long(), params["embed"].shape[0]).to(torch.int32))
    else:
        s = node_attr @ params["embed"]
    offset = 0
    if si is not None:
        s = s[:, si.channels(h)]
        h = s.shape[1]
        offset = si.node_shard * n_nodes
        positions = si.gather_nodes(positions)
        receivers = receivers - offset
    x = torch.cat([s[:, None], s.new_zeros((n_nodes, IRREP_ROWS - 1, h))], dim=1)
    graph = edge_graph(senders, receivers, n_nodes, edge_chunk)
    rhat, y2, rbf = _edge_geometry(positions, graph, cfg, offset)
    if edge_mask is not None:
        rbf = rbf * edge_mask[graph.order].to(rbf.dtype)[:, None]
    block = _interact if si is None else si
    for lp in params["layers"]:
        if remat and torch.is_grad_enabled():
            from torch.utils.checkpoint import checkpoint

            x = checkpoint(block, lp, x, graph, rhat, y2, rbf, use_reentrant=False)
        else:
            x = block(lp, x, graph, rhat, y2, rbf)
    # the scalars alone are kept for the readout's backward, not the table
    s = x[:, 0].contiguous()
    if si is not None:
        s = si.gather_channels(s, 1)
    node_e = (F.silu(s @ params["readout1"]) @ params["readout2"])[:, 0]
    if node_mask is not None:
        node_e = node_e * node_mask
    if graph_ids is None:
        e = torch.sum(node_e, dim=0, keepdim=True)
    else:
        e = segment_sum(node_e[:, None], graph_ids.to(torch.int32), n_graphs)[:, 0]
    return e if si is None else si.sum_nodes(e)


def energy_and_forces(params, cfg: GNNConfig, positions, node_attr, senders, receivers, **kw):
    """(E, forces): forces = -dE/dpositions (autograd through the whole network)."""
    with torch.enable_grad():
        pos = positions.detach().requires_grad_()
        e = forward(params, cfg, pos, node_attr, senders, receivers, **kw).sum()
        (grad,) = torch.autograd.grad(e, pos)
    return e.detach(), -grad


def energy_mse_loss(params, cfg: GNNConfig, batch: dict, n_graphs: int = 1,
                    remat: bool = False, edge_chunk: Optional[int] = None,
                    interact_fn: Optional[ShardedInteract] = None) -> torch.Tensor:
    """MSE on per-graph energies (with ``interact_fn``, ``batch`` is this
    rank's, and ``energy`` the whole batch's targets)."""
    e = forward(params, cfg, batch["positions"], batch["node_attr"], batch["senders"],
                batch["receivers"], edge_mask=batch.get("edge_mask"),
                node_mask=batch.get("node_mask"), graph_ids=batch.get("graph_ids"),
                n_graphs=n_graphs, remat=remat, edge_chunk=edge_chunk,
                interact_fn=interact_fn)
    return torch.mean((e - batch["energy"]) ** 2)
