"""Carry state from the JAX package into the port.

The JAX package's objects are handed over as numpy arrays (the caller does
``np.asarray`` on its side), so this module needs neither package's
internals: both then compute on identical data.
"""

from __future__ import annotations

import numpy as np
import torch

from .configs.base import AdaCURConfig
from .data.synthetic import SyntheticCE
from .kernels.approx_topk.quant import QuantizedRanc

SYNTHETIC_CE_FIELDS = ("q_emb", "i_emb", "mix_a", "mix_b", "mix_w")


def _t(x, device, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype).to(device)


def synthetic_ce(fields: dict, device="cpu") -> SyntheticCE:
    """A SyntheticCE from its fields: the five arrays plus gamma and sigma."""
    arrays = {k: _t(fields[k], device, torch.float32) for k in SYNTHETIC_CE_FIELDS}
    return SyntheticCE(**arrays, gamma=float(fields["gamma"]),
                       sigma=float(fields["sigma"]))


def r_anc(x, device="cpu") -> torch.Tensor:
    """An fp32 (k_q, N) payload."""
    return _t(x, device, torch.float32)


def quantized_ranc(codes, scales, tile: int, device="cpu") -> QuantizedRanc:
    """An int8 payload from its codes (k_q, N), tile scales and tile."""
    return QuantizedRanc(_t(codes, device, torch.int8), _t(scales, device, torch.float32),
                         int(tile), "int8")


def config(kwargs: dict) -> AdaCURConfig:
    """An AdaCURConfig from a kwargs dict (the reference's field names)."""
    return AdaCURConfig(**kwargs)


def key(raw) -> torch.Tensor:
    """A raw (2,) uint32 key pair (``jax.random.key_data`` or a legacy
    PRNGKey array, as numpy) as the port's key."""
    return torch.as_tensor(np.array(raw, dtype=np.int64))
