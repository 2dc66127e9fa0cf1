"""Carry state from the JAX package into the port.

The JAX package's objects are handed over as numpy arrays (the caller does
``np.asarray`` on its side), so this module needs neither package's
internals: both then compute on identical data.  Every function follows the
port's device rule (``device.resolve_device``): the state lands on the card
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from .configs.base import AdaCURConfig
from .device import resolve_device
from .data.synthetic import SyntheticCE
from .kernels.approx_topk.quant import QuantizedRanc

SYNTHETIC_CE_FIELDS = ("q_emb", "i_emb", "mix_a", "mix_b", "mix_w")


def _t(x, device, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype).to(resolve_device(device))


def synthetic_ce(fields: dict, device=None) -> SyntheticCE:
    """A SyntheticCE from its fields: the five arrays plus gamma and sigma."""
    arrays = {k: _t(fields[k], device, torch.float32) for k in SYNTHETIC_CE_FIELDS}
    return SyntheticCE(**arrays, gamma=float(fields["gamma"]),
                       sigma=float(fields["sigma"]))


def r_anc(x, device=None) -> torch.Tensor:
    """A dense (k_q, N) payload: bf16 from a bf16 array, else fp32."""
    if np.asarray(x).dtype.name == "bfloat16":
        return _leaf(x, resolve_device(device))
    return _t(x, device, torch.float32)


_CODE_TORCH_DTYPES = {"int8": torch.int8, "int4": torch.uint8, "fp8": torch.float8_e4m3fn}


def quantized_ranc(codes, scales, tile: int, device=None, code_dtype: str = "int8",
                   n_cols: int = -1) -> QuantizedRanc:
    """A coded payload from its codes (int8 or fp8 e4m3 (k_q, N), packed
    int4 (k_q, ceil(N/2)) bytes), tile scales, tile and, for odd-width int4,
    its logical width; the codes' bytes carry over unchanged."""
    raw = np.ascontiguousarray(np.asarray(codes))
    bits = torch.from_numpy(raw.view(np.uint8).copy()).view(_CODE_TORCH_DTYPES[code_dtype])
    return QuantizedRanc(bits.to(resolve_device(device)), _t(scales, device, torch.float32),
                         int(tile), code_dtype, int(n_cols))


def _leaf(x, device) -> torch.Tensor:
    """A numpy array as a tensor of the same dtype (bfloat16 arrays, which
    numpy holds as ``ml_dtypes.bfloat16``, go through their raw bits)."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(x)).to(device)


def _tree(tree, device):
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(v, device) for v in tree]
    return _leaf(tree, device)


def _unstack(tree, device) -> list:
    """A stacked pytree (every leaf with a leading layer axis) as a list of
    per-layer pytrees."""
    stacked = _tree(tree, device)

    def first_leaf(t):
        return first_leaf(next(iter(t.values()))) if isinstance(t, dict) else t

    def layer(i, t):
        return {k: layer(i, v) for k, v in t.items()} if isinstance(t, dict) else t[i]

    return [layer(i, stacked) for i in range(first_leaf(stacked).shape[0])]


def lm_params(tree: dict, device=None) -> dict:
    """The port's LM params from the reference's (``init_lm``'s or
    ``init_cross_encoder``'s pytree as numpy arrays): the stacked ``layers``
    are unstacked into a list of per-layer dicts, ``prefix`` (the dense
    layers of a MoE config, already a list) and every other leaf keep their
    names, layouts and dtypes; a ``score_head`` comes along when present."""
    device = resolve_device(device)
    out = {k: _tree(v, device) for k, v in tree.items() if k != "layers"}
    out["layers"] = _unstack(tree["layers"], device)
    return out


def lm_cache(tree: dict, device=None) -> dict:
    """The port's KV cache from the reference's (``init_cache``'s or a
    prefill's, as numpy): the stacked ``k``/``v`` (n_layers, B, S, KV, hd)
    become ``{"layers": [{"k", "v"}, ...]}``, ``prefix`` stays a list."""
    device = resolve_device(device)
    out = {"layers": _unstack({"k": tree["k"], "v": tree["v"]}, device)}
    if "prefix" in tree:
        out["prefix"] = _tree(tree["prefix"], device)
    return out


def dlrm_params(tree: dict, device=None) -> dict:
    """The port's DLRM params from the reference's (``init_dlrm``'s pytree
    as numpy arrays): ``bot`` and ``top`` keep their ``b{i}_w``/``t{i}_b``
    names and (d_in, d_out) layouts, ``tables`` stays a list of padded
    (rows, dim) tables."""
    device = resolve_device(device)
    return {"bot": _tree(tree["bot"], device), "top": _tree(tree["top"], device),
            "tables": _tree(tree["tables"], device)}


def adamw_state(step, mu, nu, params_fn=None, device=None):
    """The port's ``AdamWState`` from the reference's: its step (a 0-d int)
    and its two moment trees as numpy, each converted by ``params_fn``
    (``dlrm_params`` or ``lm_params``: the moments have their
    parameters' structure), so both packages' optimizers start from the same
    state."""
    from .training.optimizer import AdamWState

    params_fn = dlrm_params if params_fn is None else params_fn
    dev = resolve_device(device)
    return AdamWState(torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=dev),
                      params_fn(mu, dev), params_fn(nu, dev))


def config(kwargs: dict) -> AdaCURConfig:
    """An AdaCURConfig from a kwargs dict (the reference's field names)."""
    return AdaCURConfig(**kwargs)


def key(raw) -> torch.Tensor:
    """A raw (2,) uint32 key pair (``jax.random.key_data`` or a legacy
    PRNGKey array, as numpy) as the port's key."""
    return torch.as_tensor(np.array(raw, dtype=np.int64))
