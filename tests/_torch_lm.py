"""Shared by the port's LM tests: weights drawn once by the port (a seeded
CPU ``torch.Generator``) and handed to the JAX package as numpy arrays in
its own layout (the scanned layers stacked on a leading axis), so neither
package's init has to be compiled per test module."""

import numpy as np
import torch

from repro_torch.models import cross_encoder, transformer


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np(v) for v in tree]
    return tree.detach().numpy().copy()


def _stack(layers):
    if isinstance(layers[0], dict):
        return {k: _stack([lp[k] for lp in layers]) for k in layers[0]}
    return np.stack(layers)


def ref_tree(params: dict) -> dict:
    """The port's LM / CE params as the reference's pytree of numpy arrays."""
    tree = {k: _np(v) for k, v in params.items() if k != "layers"}
    tree["layers"] = _stack(_np(params["layers"]))
    return tree


def lm_params(cfg, seed: int = 0, ce: bool = False) -> dict:
    """Port params of ``cfg`` on the CPU from a seeded generator (with a
    ``score_head`` when ``ce``)."""
    gen = torch.Generator().manual_seed(seed)
    if ce:
        return cross_encoder.init_cross_encoder(cfg, gen, device="cpu")
    return transformer.init_lm(cfg, gen)
