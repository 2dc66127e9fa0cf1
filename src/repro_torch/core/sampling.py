"""Anchor-item sampling strategies (paper Algorithm 3), port of
``repro/core/sampling.py``.

Every random draw of the engine reads one canonical field over (query row,
item) coordinates, generated per ``NOISE_BLOCK``-item block:

    noise[i, j] = gumbel(fold_in(fold_in(key, row_id[i]), j // NOISE_BLOCK))
                      [j % NOISE_BLOCK]

The port draws it with its own threefry (``core/prng.py``), so the integer
bits equal the reference's and the Gumbel values agree to the final
``log``'s rounding.  :func:`gumbel_at` evaluates the same field at
scattered columns (a candidate subset), bit-equal to :func:`blocked_gumbel`
there.  Every top-k here is index-stable (``select.py``).  The §3.2 oracles
(:func:`oracle_topk`, :func:`oracle_softmax`) read exact CE scores.
"""

from __future__ import annotations

import torch

from ..kernels.approx_topk.select import NEG_INF, stable_topk
from . import prng

NOISE_BLOCK = 128


def blocked_gumbel(key, rows: int, n: int, row_offset: int = 0,
                   col_offset: int = 0, device=None) -> torch.Tensor:
    """(rows, n) Gumbel noise: the canonical field's rectangle starting at
    global coordinates (``row_offset``, ``col_offset``); ``col_offset`` is
    a multiple of ``NOISE_BLOCK``.  Generated in row chunks."""
    device = torch.device("cpu") if device is None else torch.device(device)
    key = key.to(device=device, dtype=torch.int64)
    nb = -(-n // NOISE_BLOCK)
    blk_ids = col_offset // NOISE_BLOCK + torch.arange(nb, dtype=torch.int64, device=device)
    out = torch.empty((rows, n), dtype=torch.float32, device=device)
    step = prng.chunk_rows(rows, nb * NOISE_BLOCK)
    for lo in range(0, rows, step):
        hi = min(rows, lo + step)
        row_ids = row_offset + torch.arange(lo, hi, dtype=torch.int64, device=device)
        row_keys = prng.fold_in(key, row_ids)                          # (r, 2)
        blk_keys = prng.fold_in(row_keys[:, None, :], blk_ids[None, :])  # (r, nb, 2)
        bits = prng.block_bits(blk_keys, NOISE_BLOCK)                  # (r, nb, 128)
        g = prng._unit_to_gumbel(prng._bits_to_unit(bits))
        out[lo:hi] = g.reshape(hi - lo, nb * NOISE_BLOCK)[:, :n]
    return out


def gumbel_at(key, rows: int, col_pos, row_offset: int = 0) -> torch.Tensor:
    """(rows, C) noise: the canonical field at scattered global columns
    ``col_pos`` (C,) (any order, repeats allowed), entry (i, j) bit-equal
    to :func:`blocked_gumbel`'s at (row_offset + i, col_pos[j]).  The field
    is addressable only by whole blocks, so each distinct touched block is
    drawn once a row, transformed exactly as ``blocked_gumbel`` transforms
    a block, and the columns are gathered from it.  On ``col_pos``'s device."""
    col_pos = torch.as_tensor(col_pos).to(torch.int64)
    device = col_pos.device
    key = key.to(device=device, dtype=torch.int64)
    blocks, inv = torch.unique(col_pos // NOISE_BLOCK, return_inverse=True)
    flat = inv * NOISE_BLOCK + col_pos % NOISE_BLOCK     # into (touched, NOISE_BLOCK)
    out = torch.empty((rows, col_pos.shape[0]), dtype=torch.float32, device=device)
    step = prng.chunk_rows(rows, blocks.shape[0] * NOISE_BLOCK)
    for lo in range(0, rows, step):
        hi = min(rows, lo + step)
        row_ids = row_offset + torch.arange(lo, hi, dtype=torch.int64, device=device)
        row_keys = prng.fold_in(key, row_ids)                          # (r, 2)
        blk_keys = prng.fold_in(row_keys[:, None, :], blocks[None, :])   # (r, U, 2)
        g = prng._unit_to_gumbel(prng._bits_to_unit(prng.block_bits(blk_keys, NOISE_BLOCK)))
        out[lo:hi] = g.reshape(hi - lo, -1)[:, flat]
    return out


def _masked_logits(scores, selected, temp: float):
    logits = scores / torch.tensor(temp, dtype=scores.dtype)
    return torch.where(selected, torch.tensor(NEG_INF, dtype=scores.dtype), logits)


def sample_topk(scores, selected, k: int, temp: float = 1.0):
    """TopK strategy: greedily pick the k highest-scoring unselected items."""
    return stable_topk(_masked_logits(scores, selected, temp), k)[1]


def sample_softmax(key, scores, selected, k: int, temp: float = 1.0):
    """SoftMax strategy: k items w/o replacement ∝ softmax(scores), by the
    Gumbel-top-k trick over the canonical field's (0, 0) rectangle."""
    logits = _masked_logits(scores, selected, temp)
    g = blocked_gumbel(key, logits.shape[0], logits.shape[1], device=logits.device)
    return stable_topk(logits + g, k)[1]


def sample_random(key, selected, k: int):
    """Random strategy: uniform w/o replacement over unselected items."""
    logits = torch.where(selected, NEG_INF, 0.0).to(torch.float32)
    g = blocked_gumbel(key, logits.shape[0], logits.shape[1], device=selected.device)
    return stable_topk(logits + g, k)[1]


def sample(strategy: str, key, scores, selected, k: int, temp: float = 1.0):
    """Dispatch on the paper's three strategies (Algorithm 3)."""
    if strategy == "topk":
        return sample_topk(scores, selected, k, temp)
    if strategy == "softmax":
        return sample_softmax(key, scores, selected, k, temp)
    if strategy == "random":
        return sample_random(key, selected, k)
    raise ValueError(f"unknown sampling strategy '{strategy}'")


# ---------------------------------------------------------------------------
# Oracle strategies (paper §3.2): they read the EXACT CE scores of every
# item, to analyse why adaptive anchor selection works.
# ---------------------------------------------------------------------------


def _descending(exact_scores, k: int) -> torch.Tensor:
    """The first ``k`` of each row's stable descending order (ties to the
    lower id), as the reference's ``jnp.argsort(-scores)``."""
    return torch.sort(-exact_scores, dim=-1, stable=True).indices[:, :k]


def _rows_set(sel, idx):
    return sel.scatter(1, idx.long(), True)


def oracle_topk(key, exact_scores, k_i: int, k_m: int = 0, eps: float = 0.0) -> torch.Tensor:
    """TopK^O_{k_m,eps}: skip the top-k_m items, take the next (1-eps)·k_i
    greedily, fill the other eps·k_i uniformly at random."""
    n_greedy = int(round((1.0 - eps) * k_i))
    n_rand = k_i - n_greedy
    order = _descending(exact_scores, k_m + n_greedy)
    greedy = order[:, k_m:].to(torch.int32)
    if n_rand == 0:
        return greedy
    sel = _rows_set(torch.zeros(exact_scores.shape, dtype=torch.bool,
                                device=exact_scores.device), order)
    return torch.cat([greedy, sample_random(key, sel, n_rand)], dim=-1)


def oracle_softmax(key, exact_scores, k_i: int, k_m: int = 0, eps: float = 0.0,
                   temp: float = 1.0) -> torch.Tensor:
    """SoftMax^O_{k_m,eps}: skip the top-k_m items, sample (1-eps)·k_i by a
    softmax of the exact scores, fill the other eps·k_i uniformly at random."""
    n_soft = int(round((1.0 - eps) * k_i))
    n_rand = k_i - n_soft
    sel = torch.zeros(exact_scores.shape, dtype=torch.bool, device=exact_scores.device)
    if k_m > 0:
        sel = _rows_set(sel, _descending(exact_scores, k_m))
    k_soft, k_rand = prng.split(key)
    soft = sample_softmax(k_soft, exact_scores, sel, n_soft, temp)
    if n_rand == 0:
        return soft
    rand = sample_random(k_rand, _rows_set(sel, soft), n_rand)
    return torch.cat([soft, rand], dim=-1)
