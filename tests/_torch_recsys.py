"""Shared by the port's BST, BERT4Rec and MIND tests: the two sizes they
run at, both packages' weights (drawn by the JAX package's ``init_*``
with ``PRNGKey(0)``, as its ``_recsys_init`` does, and carried across by
``convert``), and the bars.

Bars: logits and scores within 1e-5 of the largest |value| (``close``);
every gradient leaf within 1e-4 of that leaf's largest |value|
(``grads_close``)."""

import dataclasses

import jax
import numpy as np
import torch

from repro.configs.base import RecSysConfig as JRecSysConfig
from repro.models.recsys import bert4rec as j_bert4rec, bst as j_bst, mind as j_mind
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.configs.base import replace
from repro_torch.configs.shapes import RECSYS_SHAPES
from repro_torch.launch import steps
from repro_torch.tree import leaves_with_paths

SIZES = ("smoke", "full_width")
FULL_N_ITEMS = 2048        # the full-width configs' catalogue, cut from 10^6
J_INIT = {"bst": j_bst.init_bst, "bert4rec": j_bert4rec.init_bert4rec,
          "mind": j_mind.init_mind}


def config(arch: str, size: str):
    """``smoke_config``, or the published config at full width (embed_dim,
    seq_len, heads, blocks, mlp_dims) with ``n_items`` cut to 2,048."""
    if size == "smoke":
        return registry.smoke_config(arch)
    return replace(registry.get(arch).config, n_items=FULL_N_ITEMS)


def jcfg(cfg):
    return JRecSysConfig(**dataclasses.asdict(cfg))


def np_tree(tree):
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [np_tree(v) for v in tree]
    if hasattr(tree, "detach"):
        return tree.detach().numpy().copy()
    return np.asarray(tree)


def model(arch: str, size: str) -> dict:
    """Both packages' weights of ``arch`` at ``size``: the reference's
    ``init_*(PRNGKey(0), cfg)`` (jitted) and the port's copy."""
    cfg = config(arch, size)
    jc = jcfg(cfg)
    jparams = jax.jit(lambda k: J_INIT[arch](k, jc)[0])(jax.random.PRNGKey(0))
    tree = np_tree(jparams)
    params = getattr(convert, f"{arch}_params")(tree, device="cpu")
    return dict(arch=arch, size=size, cfg=cfg, jcfg=jc, jparams=jparams, tree=tree,
                params=params)


def history(cfg, b: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.n_items, (b, cfg.seq_len)).astype(np.int32)


def items(cfg, shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.n_items, shape).astype(np.int32)


def close(got, want, rel=1e-5):
    got, want = np.asarray(np_tree(got), np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err, top = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * top, (err, top)


def rel_close(got, want, rtol=1e-5):
    assert abs(float(got) - float(want)) <= rtol * abs(float(want)), (float(got), float(want))


def grads_close(params, jgrads, rel=1e-4):
    """Every port gradient leaf (``p.grad``) within ``rel`` of the
    reference's leaf's largest |value|, leaf for leaf by path."""
    want = dict(leaves_with_paths(np_tree(jgrads)))
    got = dict(leaves_with_paths(params))
    assert got.keys() == want.keys()
    for path, p in got.items():
        w = want[path]
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()   # an unused leaf
        assert g.shape == w.shape, path
        assert np.abs(g - w).max() <= rel * max(np.abs(w).max(), 1e-30), path


def leaves_carried(params, tree, port_init) -> None:
    """``convert`` carried every leaf bit for bit under its path, and the
    port's own init draws the same paths, shapes and dtypes."""
    got, want = dict(leaves_with_paths(params)), dict(leaves_with_paths(tree))
    assert got.keys() == want.keys()
    for path, t in got.items():
        assert t.dtype == torch.float32 and np.array_equal(t.numpy(), want[path]), path
    own = dict(leaves_with_paths(port_init))
    assert {k: (tuple(v.shape), v.dtype) for k, v in own.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in got.items()}


def jmesh():
    """A 1 x 1 (data, model) mesh with Auto axes for the reference's
    builders."""
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def smoke_registry(monkeypatch, arch: str):
    """The registry's ``arch`` entry at its ``smoke_config`` (for
    ``build_cell``, which reads the registry); returns the config."""
    cfg = registry.smoke_config(arch)
    monkeypatch.setitem(registry.REGISTRY, arch,
                        dataclasses.replace(registry.REGISTRY[arch], config=cfg))
    return cfg


def cut_shapes(monkeypatch, batch=64):
    """For the CPU's time: every recsys shape's batch cut to ``batch`` (its
    kind, which picks the builder, kept) and ``K_Q`` to 16 anchors."""
    shapes = {k: dataclasses.replace(v, batch=min(v.batch, batch))
              for k, v in RECSYS_SHAPES.items()}
    monkeypatch.setattr(registry, "shapes_for", lambda arch: shapes)
    monkeypatch.setattr(steps, "K_Q", 16)


def chunked(monkeypatch, rows: int) -> None:
    """Serve steps built after this run in chunks of ``rows`` rows."""
    monkeypatch.setattr(steps, "serve_chunk_rows", lambda cfg, device: rows)
