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
``jax/_src/random.py`` — ``_uniform`` (mantissa fill), ``_randint`` (two
32-bit draws a value, combined by a span multiply in uint32),
``_normal_real`` (``sqrt(2) * erf_inv(u)``) and ``_gumbel`` in its default
``low`` mode.

What is promised:

- integer bits, ``uniform`` and ``randint``: bit-equal to JAX;
- ``normal``: the f32 ``erf_inv`` polynomial XLA lowers ``lax.erf_inv`` to
  (Giles' approximation, with XLA's own ``log1p`` and ``log``, and the
  fused multiply-adds the CPU compiler forms), so the draws are JAX's bit
  for bit except where |u| > 0.9966 (``w >= 5``): there XLA's CPU ``sqrt``
  is not correctly rounded, and a draw may differ by a few ulp
  (``tests/test_torch_prng.py`` states the bound it measured);
- ``gumbel``: equal up to the final two ``log`` calls, which torch and XLA
  round differently (within 1e-6 absolute on the field's range).

A fused multiply-add is formed in float64 and rounded once to float32:
the product of two floats is exact in float64, so only the sum rounds
twice, which changes a result only when it lands within 2^-29 of a float32
half-way point.

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


def _fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (see the module doc)."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    """XLA's ``EvaluatePolynomial``: highest degree first, one fma a step."""
    p = torch.zeros_like(x)
    for c in coeffs:
        p = _fma(p, x, torch.full_like(x, c))
    return p


# Cephes' single-precision log, the polynomial XLA's CPU backend emits for f32
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
          3.3333331174e-1)
# Cephes' log1p rational approximation for |x| < sqrt(2) - 1 (XLA's EmitLog1p)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
# Giles' f32 erf_inv, as XLA lowers lax.erf_inv: w < 5 and w >= 5 branches
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _f(v, like) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """f32 ``log`` for x in [0, inf) as XLA's CPU backend computes it."""
    bits = torch.clamp_min(x, _TINY).view(torch.int32)
    e = 1.0 + ((bits >> 23) - 0x7F).to(torch.float32)
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)    # [0.5, 1)
    small = m < 0.707106781186547524
    e = e - small.to(torch.float32)
    t = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    x2 = t * t
    x3 = x2 * t
    p = [_f(c, x) for c in _LOG_P]
    y = _fma(_fma(t, p[0], p[1]), t, p[2])
    y1 = _fma(_fma(t, p[3], p[4]), t, p[5])
    y2 = _fma(_fma(t, p[6], p[7]), t, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, _f(-2.12194440e-4, x) * e)
    t = _fma(_f(-0.5, x), x2, t) + y
    t = _fma(_f(0.693359375, x), e, t)
    return torch.where(x == 0, _f(-float("inf"), x), t)


def xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """f32 ``log1p`` for x in (-1, inf) as XLA's CPU backend computes it."""
    x2 = x * x
    small = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    small = x + _fma(_f(-0.5, x), x2, (x * x2) * small)
    return torch.where(x.abs() < 0.41421356237309504880, small, xla_log(x + 1.0))


def erf_inv(u: torch.Tensor) -> torch.Tensor:
    """f32 ``lax.erf_inv`` as XLA lowers it (Giles' approximation)."""
    w = -xla_log1p(-(u * u))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    coeff = lambda i: torch.where(lt, _f(_ERFINV_LT5[i], u), _f(_ERFINV_GE5[i], u))
    p = coeff(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma(p, w, coeff(i))
    return torch.where(u.abs() == 1, u * float("inf"), p * u)


def normal(key, shape, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: ``sqrt(2) * erf_inv(u)``
    of a uniform on (nextafter(-1, 0), 1) drawn from the same bits (see the
    module doc for what is promised)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0, device)
    return _f(float(np.float32(np.sqrt(2.0))), u) * erf_inv(u)


def randint(key, shape, low: int, high: int, device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, low, high)`` (int32), bit for bit:
    the key splits in two, each half draws 32 bits a value, and the pair is
    reduced mod the span with uint32 wrap-around, as ``_randint`` does."""
    k1, k2 = split(key)
    hi = random_bits(k1, shape, device)
    lo = random_bits(k2, shape, device)
    span = max(int(high) - int(low), 1)
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _M32) % span
    off = (((hi % span) * mult) & _M32) + lo % span
    return (int(low) + (off & _M32) % span).to(torch.int32)


def permutation(key, n: int, device=None) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` (int64 ids), bit for bit: JAX's
    ``_shuffle`` runs ``ceil(3 ln n / ln(2^32 - 1))`` rounds, each splitting
    the key and sorting the ids by fresh 32-bit ``random_bits``.  The sort is
    stable, as ``lax.sort_key_val`` is: equal 32-bit keys do occur at
    N = 10^6, and then the earlier position goes first."""
    n = int(n)
    x = torch.arange(n, dtype=torch.int64, device=device or key.device)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, (n,), x.device), stable=True).indices
        x = x[order]
    return x


def choice(key, n: int, shape, replace: bool = True, device=None) -> torch.Tensor:
    """``jax.random.choice(key, n, shape, replace=False)``: the first
    ``prod(shape)`` ids of :func:`permutation`.  Sampling with replacement
    is not ported (nothing in the port draws it)."""
    if replace:
        raise NotImplementedError("choice(replace=True) is not ported; pass replace=False")
    shape = tuple(shape)
    k = int(np.prod(shape, dtype=np.int64))
    if k > n:
        raise ValueError(f"cannot take a larger sample ({k}) than the population ({n}) "
                         "when replace=False")
    return permutation(key, n, device)[:k].reshape(shape)


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
