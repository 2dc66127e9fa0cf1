"""Plain PyTorch version of the embedding-bag kernel — the arithmetic of
the TPU kernel ``_bag_kernel`` (``repro/kernels/embedding_bag/kernel.py:26``)
over the gather of its oracle ``embedding_bag_reference`` (``ref.py:9``).

``out[b] = Σ_h table[ids[b, h]]`` (or that sum / H for ``mean``) with an
fp32 accumulator over h = 0..H-1 in ascending order, one divide by H in
fp32 for ``mean``, then one cast to the table's dtype, as the Pallas kernel
does.  The CUDA kernel (``csrc/embedding_bag.cu``) adds in the same order,
so the two agree bit for bit.  Ids follow ``jnp.take``: an id in
[-rows, 0) wraps once, one outside [-rows, rows) reads as a row of NaN.

``embedding_bag_backward_plain`` is the backward's plain version (the CPU
backend of ``ops``); ``embedding_bag_backward_emulated`` repeats the
backward kernel's order of additions, for the tests and ``chip_smoke.py``
to hold the kernel to bit for bit.
"""

from __future__ import annotations

import torch

MODES = ("sum", "mean")
BACKWARD_CHUNK = 32    # csrc/embedding_bag.cu bag_bwd::CHUNK: sorted positions a window sums
BACKWARD_GROUPS = 8    # bag_bwd::GROUPS: the warps that combine a long row's pieces


def check_bag(table: torch.Tensor, ids: torch.Tensor, mode: str) -> None:
    """Raise on what neither version takes."""
    if mode not in MODES:
        raise ValueError(f"embedding-bag mode must be one of {MODES}, got {mode!r}")
    if table.dim() != 2:
        raise ValueError(f"table must be (rows, dim), got {tuple(table.shape)}")
    if ids.dim() != 2:
        raise ValueError(f"ids must be (B, H), got {tuple(ids.shape)}")
    if ids.dtype != torch.int32:
        raise ValueError(f"ids must be int32 integers (the reference kernel's id "
                         f"type), got {ids.dtype}")
    if ids.shape[1] == 0:
        raise ValueError("a bag needs H >= 1 ids (got H = 0)")
    if ids.device != table.device:
        raise ValueError(f"ids on {ids.device} but the table on {table.device}")


def embedding_bag_plain(table: torch.Tensor, ids: torch.Tensor,
                        mode: str = "sum") -> torch.Tensor:
    """(B, dim) bag in the table's dtype; any device."""
    check_bag(table, ids, mode)
    rows, h = table.shape[0], ids.shape[1]
    idx = ids.long()
    idx = torch.where(idx < 0, idx + rows, idx)
    bad = (idx < 0) | (idx >= rows)
    gathered = table[idx.clamp(0, rows - 1)]                 # (B, H, dim)
    acc = gathered[:, 0].to(torch.float32, copy=True).masked_fill_(bad[:, 0, None], torch.nan)
    for i in range(1, h):
        acc += gathered[:, i].float().masked_fill(bad[:, i, None], torch.nan)
    if mode == "mean":
        # a divide by a tensor on acc's device: on the card, a divide by a
        # Python number becomes a multiply by its reciprocal
        acc /= torch.tensor(float(h), dtype=torch.float32, device=acc.device)
    return acc.to(table.dtype)


def row_keys(ids: torch.Tensor, rows: int) -> torch.Tensor:
    """The (B * H,) int64 table row of each lookup in lookup order (b, h):
    an id in [-rows, 0) wraps once, one outside [-rows, rows) becomes
    ``rows`` (its gather read NaN; it takes no part in the gradient, as
    jnp.take's scatter-add drops it)."""
    idx = ids.reshape(-1).long()
    idx = torch.where(idx < 0, idx + rows, idx)
    return torch.where((idx < 0) | (idx >= rows), rows, idx)


def embedding_bag_backward_plain(grad_out: torch.Tensor, ids: torch.Tensor, rows: int,
                                 mode: str = "sum") -> torch.Tensor:
    """d table (rows, dim) fp32 of the bag: ``index_add_`` of each lookup's
    ``grad_out[b]`` (``/ H`` for ``mean``, an fp32 divide) in lookup order,
    dropped ids left out; any device."""
    if mode not in MODES:
        raise ValueError(f"embedding-bag mode must be one of {MODES}, got {mode!r}")
    b, h = ids.shape
    g = grad_out.float()
    if mode == "mean":
        g = g / torch.tensor(float(h), dtype=torch.float32, device=g.device)
    keys = row_keys(ids, rows)
    keep = keys < rows
    src = g[:, None, :].expand(b, h, g.shape[1]).reshape(b * h, -1)
    out = torch.zeros((rows, g.shape[1]), dtype=torch.float32, device=g.device)
    return out.index_add_(0, keys[keep], src[keep])


def _ordered_sums(vals: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """(len(starts), dim): each segment ``vals[starts[i] : starts[i] + lens[i]]``
    summed in order from +0.0, one fp32 add at a time."""
    acc = vals.new_zeros((starts.numel(), vals.shape[1]))
    for j in range(int(lens.max()) if lens.numel() else 0):
        live = (lens > j).nonzero().squeeze(1)
        acc[live] = acc[live] + vals[starts[live] + j]
    return acc


def embedding_bag_backward_emulated(grad_out: torch.Tensor, ids: torch.Tensor, rows: int,
                                    mode: str = "sum", chunk: int = BACKWARD_CHUNK,
                                    groups: int = BACKWARD_GROUPS) -> torch.Tensor:
    """The backward kernel's d table in plain PyTorch, addition for addition.
    Each lookup's value is ``grad_out[b]`` widened to fp32 (``/ H`` for
    ``mean``, an fp32 divide).  The lookups are sorted stably by row
    (dropped ids last) and the sorted array is cut into windows of
    ``chunk`` positions; a row's piece in a window is summed in lookup order
    from +0.0.  A row of one piece is that sum.  A row of m > 1 pieces puts
    them in ``groups`` groups of q = ceil(m / groups) consecutive pieces,
    each summed in piece order from +0.0, and adds the groups' sums in group
    order from +0.0.  Untouched rows are +0.0.  Any device; for tests and
    ``chip_smoke.py`` (the op's CPU backend is
    ``embedding_bag_backward_plain``)."""
    if mode not in MODES:
        raise ValueError(f"embedding-bag mode must be one of {MODES}, got {mode!r}")
    dev, h = grad_out.device, ids.shape[1]
    g = grad_out.float()
    if mode == "mean":
        g = g / torch.tensor(float(h), dtype=torch.float32, device=dev)
    keys, perm = torch.sort(row_keys(ids, rows), stable=True)
    keep = keys < rows                             # a prefix: dropped ids sort last
    keys, perm = keys[keep], perm[keep]
    out = torch.zeros((rows, g.shape[1]), dtype=torch.float32, device=dev)
    if not keys.numel():
        return out
    vals = g[perm // h]                            # each lookup's value, sorted by row
    window = torch.arange(keys.numel(), device=dev) // chunk
    _, piece_lens = torch.unique_consecutive(keys * (int(window[-1]) + 1) + window,
                                             return_counts=True)
    piece_starts = torch.cumsum(piece_lens, 0) - piece_lens
    partial = _ordered_sums(vals, piece_starts, piece_lens)
    row, n_pieces = torch.unique_consecutive(keys[piece_starts], return_counts=True)
    first = torch.cumsum(n_pieces, 0) - n_pieces
    light = n_pieces == 1
    out[row[light]] = partial[first[light]]
    heavy = (~light).nonzero().squeeze(1)
    if heavy.numel():
        m, p0 = n_pieces[heavy], first[heavy]
        q = (m + groups - 1) // groups
        n_groups = (m + q - 1) // q
        first_group = torch.cumsum(n_groups, 0) - n_groups
        group_row = torch.repeat_interleave(torch.arange(heavy.numel(), device=dev), n_groups)
        group_i = torch.arange(group_row.numel(), device=dev) - first_group[group_row]
        group_start = p0[group_row] + group_i * q[group_row]
        group_len = torch.minimum(q[group_row], (p0 + m)[group_row] - group_start)
        sums = _ordered_sums(partial, group_start, group_len)
        out[row[heavy]] = _ordered_sums(sums, first_group, n_groups)
    return out
