"""Anchor-item sampling strategies (paper Algorithm 3), port of
``repro/core/sampling.py``.

Every random draw of the engine reads one canonical field over (query row,
item) coordinates, generated per ``NOISE_BLOCK``-item block:

    noise[i, j] = gumbel(fold_in(fold_in(key, row_id[i]), j // NOISE_BLOCK))
                      [j % NOISE_BLOCK]

The port draws it with its own threefry (``core/prng.py``), so the integer
bits equal the reference's and the Gumbel values agree to the final
``log``'s rounding.  Every top-k here is index-stable (``select.py``).
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
