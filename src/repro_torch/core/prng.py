"""threefry2x32 in plain torch, matching ``jax.random`` (JAX 0.9.0 with
``jax_threefry_partitionable=True``) bit for bit on the integer side.

torch has no full uint32 arithmetic, so every uint32 lives in an int64
tensor and is masked back to 32 bits after each add and shift.  A key is an
int64 tensor of shape (..., 2) holding the pair ``(k1, k2)``; keys are tiny
and live on the CPU unless a caller moves them.

Specification (the installed JAX sources): ``jax/_src/prng.py`` —
``threefry_2x32`` (the hash), ``_threefry_split_foldlike`` (split),
``threefry_fold_in`` and ``_threefry_random_bits_partitionable`` (32-bit
bits = ``x0 ^ x1`` of the hash of the flat (hi, lo) counter) — and
``jax/_src/random.py`` — ``_uniform`` (mantissa fill) and ``_gumbel`` in its
default ``low`` mode.  Integer bits and ``uniform`` are bit-equal to JAX;
``gumbel`` is equal up to the final two ``log`` calls, which torch and XLA
round differently (within 1e-6 absolute on the field's range).

Large fields are generated in chunks so no int64 temporary grows past a few
hundred MB (a (256 x 10^6) Gumbel field is 2.56e8 draws).
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
# elements of one generation chunk: int64 temporaries stay ~128 MB each
_CHUNK = 1 << 24


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k1, k2, x0, x1):
    """The threefry2x32 hash of counter pairs (x0, x1) under key (k1, k2).

    All operands are int64 tensors of uint32 values, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed in the int32 range."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _M32, seed & _M32], dtype=torch.int64)


def key_data(key) -> torch.Tensor:
    """A raw (..., 2) uint32 key pair (numpy or tensor) as an int64 key."""
    return torch.as_tensor(np.array(key, dtype=np.int64)) & _M32


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> (num, 2)."""
    key = key.to(torch.int64)
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0:1], key[..., 1:2], torch.zeros_like(lo), lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``; ``key`` (..., 2) and ``data`` (...)
    broadcast, so a batch of keys or of data folds in one call."""
    key = key.to(torch.int64)
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _M32
    o0, o1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([o0, o1], dim=-1)


def random_bits(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """32-bit ``jax.random.bits(key, shape)`` as int64 values."""
    key = key.to(torch.int64).to(device or key.device)
    n = 1
    for s in shape:
        n *= int(s)
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[0], key[1], i >> 32, i & _M32)
    return (b1 ^ b2).reshape(tuple(shape))


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> [0, 1) float32 by mantissa fill, as ``_uniform``."""
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fb.view(torch.float32) - 1.0


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0,
            device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    f = _bits_to_unit(random_bits(key, shape, device))
    lo = torch.tensor(minval, dtype=torch.float32)
    hi = torch.tensor(maxval, dtype=torch.float32)
    return torch.maximum(lo.to(f.device), f * (hi - lo).to(f.device) + lo.to(f.device))


_TINY = torch.finfo(torch.float32).tiny


def _unit_to_gumbel(f: torch.Tensor) -> torch.Tensor:
    # uniform(minval=tiny, maxval=1): (1 - tiny) rounds to 1.0 in fp32
    u = torch.clamp_min(f + _TINY, _TINY)
    return -torch.log(-torch.log(u))


def gumbel(key, shape, device=None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` (default ``low`` mode)."""
    return _unit_to_gumbel(_bits_to_unit(random_bits(key, shape, device)))


def normal(key, shape, device=None) -> torch.Tensor:
    """Standard normal draws by the inverse-CDF route ``jax.random.normal``
    takes (sqrt(2)·erfinv of a uniform on (-1, 1)); the same distribution,
    not promised bit-equal to JAX."""
    lo = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)).item()
    u = uniform(key, shape, lo, 1.0, device)
    return torch.erfinv(u) * (2.0 ** 0.5)


def randint(key, shape, low: int, high: int, device=None) -> torch.Tensor:
    """Uniform integers in [low, high) from one 32-bit draw each (the same
    distribution as ``jax.random.randint`` up to a bias of (high-low)/2^32,
    not promised bit-equal)."""
    bits = random_bits(key, shape, device)
    return low + bits % (high - low)


def block_bits(block_keys: torch.Tensor, width: int) -> torch.Tensor:
    """32-bit bits of ``width`` draws under each key of a (..., 2) key array
    -> (..., width); row i of the result is ``random_bits(block_keys[i])``."""
    i = torch.arange(width, dtype=torch.int64, device=block_keys.device)
    b1, b2 = threefry2x32(
        block_keys[..., 0:1], block_keys[..., 1:2], torch.zeros_like(i), i
    )
    return b1 ^ b2


def chunk_rows(rows: int, per_row: int) -> int:
    """Rows per generation chunk for fields of ``per_row`` draws a row."""
    return max(1, _CHUNK // max(1, per_row))
