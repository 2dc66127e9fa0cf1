"""Training over a mesh in the port, held against the JAX package run live
on the same numpy inputs:

- ``tree_specs`` of every registered arch's parameters (the reference's
  ``eval_shape``d, in the port's layout) under each family's
  ``param_specs`` equal the reference's, leaf for leaf, on stub meshes of
  16 x 16, 2 x 16 x 16, 2 x 2 and 1 x 4; ``param_specs`` mirror the port's
  parameter trees; ``batch_spec`` and ``replicated``;
- in one gloo world of 4 CPU ranks, spawned once for the module (each rank
  runs this file as ``python tests/test_torch_mesh_train.py worker DIR``):
  ``make_production_mesh``'s shapes and refusals;
  ``nequip.make_sharded_interact`` on data 2 x model 2 against the
  reference's ``_interact`` on ``check_gnn_interact``'s inputs at the
  reference's multidevice ``TOL``; ``build_gnn_train(mesh=)`` on a small
  graph forced onto the sharded interact and on a molecule batch, and
  DLRM's ``build_recsys_train(mesh=)`` on data 2 x model 2 and pod 2 x
  data 2, each against the reference's step on a 1 x 1 mesh and the
  port's one-device step (loss within 1e-5 relative, every gradient within
  1e-4 of the largest, the clip's norm within 1e-6 relative); an elastic
  round trip of a DLRM train state, 2 x 2 -> 4 x 1 -> one rank (every
  leaf bitwise, the next step within those bars of the uninterrupted
  run's), whose checkpoint the reference's ``Checkpointer.restore`` reads;
  ``run_with_recovery(mesh=)`` through a lost step, bitwise the
  uninterrupted run;
- the reference's own sharded DLRM step on a forced 2 x 2 CPU mesh, in a
  subprocess: it runs with Auto axes, and the port's world is held to it;
  with JAX's default Explicit axes it raises (ROADMAP.md, queue 3).
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
SPAWN_TIMEOUT = 240
TOL = 2e-4                                   # the reference's multidevice TOL
LOSS_REL, GRAD_REL, NORM_REL = 1e-5, 1e-4, 1e-6
DLRM_B = 64
GNN_SMALL = dict(name="g_small", kind="full", n_nodes=1000, n_edges=3000)
GNN_MOL = dict(name="mol_small", kind="molecule", n_nodes=8, n_edges=16, batch_graphs=8)
STUB_MESHES = {"16x16": ((16, 16), ("data", "model")),
               "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
               "2x2": ((2, 2), ("data", "model")), "1x4": ((1, 4), ("data", "model"))}


# ---------------------------------------------------------------------------
# the world's ranks
# ---------------------------------------------------------------------------


def _pieces_whole(tree, shardings):
    from repro_torch.tree import leaves, leaves_with_paths

    return {k: s.gather(x.detach()).clone()
            for (k, x), s in zip(leaves_with_paths(tree), leaves(shardings))}


def _run_step(bundle, grads_too=True):
    """(loss, whole gradients by path, clip norm, pieces after the step)."""
    from repro_torch.tree import leaves

    pieces, state, batch = bundle.args
    out = {}
    if grads_too:
        loss, grads = bundle.step.value_and_grad(pieces, batch)
        out.update(loss=float(loss), grads=_pieces_whole(grads, bundle.shardings))
    _, _, met = bundle.step(pieces, state, batch)
    out.update(norm=float(met["grad_norm"]), step_loss=float(met["loss"]))
    assert all(p.grad is None for p in leaves(pieces))
    return out


def _interact_case(d, res, mesh):
    import torch

    from repro_torch.distributed.sharding import mesh_coordinate
    from repro_torch.models.gnn import nequip

    cfg = _gnn_cfg(d_hidden=int(d["h"]))
    si = nequip.make_sharded_interact(mesh, "data", "model")
    n, h = int(d["n"]), int(d["h"])
    n_l, hl = n // si.n_node_shards, h // si.tp
    lo = si.node_shard * n_l
    e_l = d["send"].shape[0] // si.n_node_shards
    blk = slice(si.node_shard * e_l, (si.node_shard + 1) * e_l)
    x = torch.from_numpy(d["x"])[lo:lo + n_l, :, si.channels(h)].contiguous()
    graph = nequip.edge_graph(torch.from_numpy(d["send"][blk]),
                              torch.from_numpy(d["recv"][blk]) - lo, n_l)
    rhat, y2, rbf = nequip._edge_geometry(torch.from_numpy(d["pos"]), graph, cfg, lo)
    lp = {"lin": {k: torch.from_numpy(d[f"lin_{k}"]) for k in ("w_s", "w_v", "w_t", "w_gate")},
          "radial": {k: torch.from_numpy(d[f"radial_{k}"]) for k in ("w1", "w2")}}
    out = si(lp, x, graph, rhat, y2, rbf)
    assert out.shape == (n_l, 13, hl)
    res.update(out=out, coord=mesh_coordinate(mesh))


def _gnn_case(blob, res, mesh):
    from repro_torch.configs.base import GraphShape
    from repro_torch.launch import steps

    cfg = _gnn_cfg()
    for name, forced in (("small", True), ("molecule", None)):
        shape = GraphShape(**(GNN_SMALL if name == "small" else GNN_MOL))
        b = steps.build_gnn_train("nequip", cfg, shape, params=blob["params"],
                                  batch=blob[name], device="cpu", mesh=mesh,
                                  sharded_interact=forced)
        res[name] = _run_step(b)
        res[name]["edges_local"] = int(b.args[2]["senders"].shape[0])


def _dlrm_case(blob, res, meshes):
    from repro_torch.configs.base import RecSysShape
    from repro_torch.launch import steps

    cfg = _dlrm_cfg()
    for name, mesh in meshes.items():
        b = steps.build_recsys_train("dlrm-mlperf", cfg, RecSysShape("train_batch", "train",
                                                                     DLRM_B),
                                     params=blob["params"], batch=blob["batch"], device="cpu",
                                     mesh=mesh)
        res[name] = _run_step(b)
        res[name]["table_rows_local"] = int(b.args[0]["tables"][0].shape[0])
        res[name]["pieces"] = _pieces_whole(b.args[0], b.shardings)


def _elastic_case(blob, out, res, m22, m41):
    """2 x 2: one step, save; 4 x 1 and one rank: restore, one more step;
    2 x 2 uninterrupted: the same next step."""
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.base import RecSysShape
    from repro_torch.distributed.sharding import replicated
    from repro_torch.launch import steps
    from repro_torch.training import optimizer
    from repro_torch.tree import leaves, leaves_with_paths, tree_map

    cfg, shape = _dlrm_cfg(), RecSysShape("train_batch", "train", DLRM_B)
    kw = dict(params=blob["params"], batch=blob["batch"], device="cpu")
    b22 = steps.build_recsys_train("dlrm-mlperf", cfg, shape, mesh=m22, **kw)
    pieces, state, batch = b22.args
    pieces, state, _ = b22.step(pieces, state, batch)
    tree = {"params": pieces, "opt": state}
    specs = {"params": b22.shardings,
             "opt": optimizer.AdamWState(replicated(m22), b22.shardings, b22.shardings)}
    ckpt_dir = str(out / "ckpt")
    mgr = CheckpointManager(ckpt_dir, save_every=1, async_save=False)
    assert mgr.maybe_save(1, tree, specs, mesh=m22)
    res["saved"] = _pieces_whole(tree, specs)
    like = tree_map(lambda x, sh: torch.empty(sh.whole_shape(x.shape), dtype=x.dtype, device="meta")
                    .requires_grad_(x.requires_grad), tree, specs)
    # the uninterrupted run's next step
    res["next"] = _run_step(steps.StepBundle(b22.name, b22.step, (pieces, state, batch),
                                             b22.model_flops, shardings=b22.shardings))
    # 4 x 1: each rank reads its own piece of every leaf
    start, restored = mgr.resume(like, device="cpu", mesh=m41)
    assert start == 1
    b41 = steps.build_recsys_train("dlrm-mlperf", cfg, shape, mesh=m41, **kw)
    sh41 = Checkpointer(ckpt_dir).shardings(1, like, m41)
    # the saved specs re-resolved on 4 x 1 place every leaf as the 4 x 1
    # step's own specs do (a spec may name the size-1 model axis or not)
    wholes = [tuple(x.shape) for x in leaves(like["params"])]
    assert [s.piece(w) for s, w in zip(leaves(sh41["params"]), wholes)] == \
        [s.piece(w) for s, w in zip(leaves(b41.shardings), wholes)]
    res["restored41"] = _pieces_whole(restored, sh41)
    res["next41"] = _run_step(steps.StepBundle(
        b41.name, b41.step, (restored["params"], restored["opt"], b41.args[2]),
        b41.model_flops, shardings=b41.shardings))
    if dist.get_rank() == 0:
        # one rank: the whole leaves, and the one-device step from them
        _, whole = CheckpointManager(ckpt_dir, async_save=False).resume(like, device="cpu")
        res["restored1"] = {k: v.detach().clone() for k, v in leaves_with_paths(whole)}
        loss = _one_device_loss(whole["params"], blob["batch"], cfg)
        loss.backward()
        res["next1"] = dict(loss=float(loss), grads={k: p.grad.clone() for k, p
                                                     in leaves_with_paths(whole["params"])})


def _recovery_case(blob, out, res, m22):
    """``run_with_recovery(mesh=)`` over data 2 x model 2: a step that
    raises once at step 2 (on every rank, as a collective's failure does)
    restores the sharded checkpoint of step 2 and goes on; the 3-step
    result is bitwise the uninterrupted run's."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.base import RecSysShape
    from repro_torch.distributed.sharding import replicated
    from repro_torch.launch import steps
    from repro_torch.training import optimizer

    cfg, shape = _dlrm_cfg(), RecSysShape("train_batch", "train", DLRM_B)
    kw = dict(params=blob["params"], batch=blob["batch"], device="cpu", mesh=m22)
    b = steps.build_recsys_train("dlrm-mlperf", cfg, shape, **kw)
    pieces, state, batch = b.args
    specs = {"params": b.shardings,
             "opt": optimizer.AdamWState(replicated(m22), b.shardings, b.shardings)}
    tree = {"params": pieces, "opt": state}
    crashed = []

    def step_fn(step, st):
        if step == 2 and not crashed:
            crashed.append(step)
            raise RuntimeError("a step lost at step 2")
        p, o, _ = b.step(st["params"], st["opt"], batch)
        return {"params": p, "opt": o}

    mgr = CheckpointManager(str(out / "recovery"), save_every=1, keep=2, async_save=False)
    got = mgr.run_with_recovery(step_fn, tree, 3, specs=specs, device="cpu", mesh=m22)
    b2 = steps.build_recsys_train("dlrm-mlperf", cfg, shape, **kw)
    p2, s2, _ = b2.args
    for _ in range(3):
        p2, s2, _ = b2.step(p2, s2, batch)
    res.update(crashed=crashed, steps=int(got["opt"].step),
               got=_pieces_whole(got, specs), want=_pieces_whole({"params": p2, "opt": s2}, specs))


def _one_device_loss(params, batch, cfg):
    from repro_torch.models.recsys import dlrm

    return dlrm.bce_loss(params, batch["dense"], batch["sparse"], batch["labels"], cfg)


def _production_case(res):
    from repro_torch.launch.mesh import make_production_mesh

    m = make_production_mesh(shape=(2, 2), device="cpu")
    res["single"] = (tuple(m.mesh_dim_names), tuple(m.shape))
    m = make_production_mesh(multi_pod=True, shape=(2, 2, 1), device="cpu")
    res["multi"] = (tuple(m.mesh_dim_names), tuple(m.shape))
    for name, kw in (("default", {}), ("default_multi", {"multi_pod": True}),
                     ("short", {"shape": (4,)}), ("wrong_size", {"shape": (2, 4)})):
        try:
            make_production_mesh(device="cpu", **kw)
            res[name] = None
        except ValueError as e:
            res[name] = str(e)


def worker(out_dir: str) -> None:
    import faulthandler

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import end_world, make_mesh

    faulthandler.dump_traceback_later(SPAWN_TIMEOUT - 30, exit=True)
    torch.set_num_threads(1)
    out = Path(out_dir)
    m22 = make_mesh((2, 2), ("data", "model"), device="cpu")
    mpod = make_mesh((2, 2), ("pod", "data"), device="cpu")
    m41 = make_mesh((4, 1), ("data", "model"), device="cpu")
    rank = dist.get_rank()
    gnn = torch.load(out / "gnn.pt", weights_only=False)
    dl = torch.load(out / "dlrm.pt", weights_only=False)
    res = {"seconds": {}}
    cases = [("production", lambda r: _production_case(r)),
             ("interact", lambda r: _interact_case(dict(np.load(out / "interact.npz")), r, m22)),
             ("gnn", lambda r: _gnn_case(gnn, r, m22)),
             ("dlrm", lambda r: _dlrm_case(dl, r, {"2x2": m22, "pod2x2": mpod})),
             ("elastic", lambda r: _elastic_case(dl, out, r, m22, m41)),
             ("recovery", lambda r: _recovery_case(dl, out, r, m22))]
    for name, fn in cases:
        t0 = time.monotonic()
        fn(res.setdefault(name, {}))
        res["seconds"][name] = time.monotonic() - t0
    torch.save(res, out / f"rank{rank}.pt")
    end_world()


# ---------------------------------------------------------------------------
# the test process
# ---------------------------------------------------------------------------

if __name__ != "__main__":
    torch = pytest.importorskip("torch")
    torch.set_num_threads(1)   # one intra-op thread: the suite runs a process a core
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp  # noqa: E402


def _gnn_cfg(**kw):
    from repro_torch.configs import registry

    return dataclasses.replace(registry.smoke_config("nequip"), **kw)


def _dlrm_cfg():
    from repro_torch.configs import registry

    return registry.smoke_config("dlrm-mlperf")


class _Stub:
    """A mesh as the spec functions read it: names and sizes."""

    def __init__(self, shape, names):
        self.mesh_dim_names, self.shape = tuple(names), tuple(shape)
        self.axis_names = tuple(names)


class _JStub:
    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))
        self.axis_names = tuple(names)


@functools.lru_cache(maxsize=None)
def _ref_tree(arch):
    """(the reference's eval_shape'd params, its logical specs) of a
    registered arch at its published config."""
    from repro.configs import registry as j_registry
    from repro.models import transformer as j_tr
    from repro.models.gnn import nequip as j_nq
    from repro.models.recsys import bert4rec as j_b4, bst as j_bst, dlrm as j_dl, mind as j_mi

    entry = j_registry.get(arch)
    cfg = entry.config
    init = {"lm": lambda k: j_tr.init_lm(k, cfg), "gnn": lambda k: j_nq.init_nequip(k, cfg)}.get(
        entry.family) or {"dlrm": lambda k: j_dl.init_dlrm(k, cfg),
                          "bst": lambda k: j_bst.init_bst(k, cfg),
                          "bert4rec": lambda k: j_b4.init_bert4rec(k, cfg),
                          "mind": lambda k: j_mi.init_mind(k, cfg)}[cfg.kind]
    box = {}

    def only_params():
        p, s = init(jax.random.PRNGKey(0))
        box["s"] = s
        return p

    return jax.eval_shape(only_params), box["s"]


def _port_specs(arch, cfg):
    from repro_torch.configs import registry
    from repro_torch.models import transformer
    from repro_torch.models.gnn import nequip
    from repro_torch.models.recsys import bert4rec, bst, dlrm, mind

    fam = registry.get(arch).family
    if fam == "lm":
        return transformer.param_specs(cfg)
    if fam == "gnn":
        return nequip.param_specs(cfg)
    return {"dlrm": dlrm, "bst": bst, "bert4rec": bert4rec, "mind": mind}[cfg.kind].param_specs(cfg)


def _port_layout(arch, tree):
    """The reference's shapes in the port's layout (an LM's stacked layers
    as a list of per-layer trees)."""
    from repro_torch.configs import registry

    if registry.get(arch).family != "lm":
        return tree

    def unstack(t, i):
        if isinstance(t, dict):
            return {k: unstack(v, i) for k, v in t.items()}
        return _Shape(t.shape[1:])

    n = jax.tree.leaves(tree["layers"])[0].shape[0]
    return {**tree, "layers": [unstack(tree["layers"], i) for i in range(n)]}


class _Shape:
    def __init__(self, shape):
        self.shape = tuple(shape)


ARCHS = ("qwen3-8b", "qwen1.5-110b", "starcoder2-3b", "moonshot-v1-16b-a3b",
         "granite-moe-1b-a400m", "nequip", "bst", "mind", "bert4rec", "dlrm-mlperf", "ce-tiny")


def _as_tuple(spec):
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in spec)


@pytest.mark.parametrize("mesh_name", list(STUB_MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_tree_specs_are_the_references(arch, mesh_name):
    from repro.distributed import sharding as j_sharding
    from repro_torch.configs import registry
    from repro_torch.distributed import sharding
    from repro_torch.tree import leaves

    shape, names = STUB_MESHES[mesh_name]
    jparams, jspecs = _ref_tree(arch)
    want = j_sharding.tree_specs(_JStub(shape, names), jparams, jspecs)
    cfg = registry.get(arch).config
    got = port = sharding.tree_specs(_Stub(shape, names), _port_layout(arch, jparams),
                                     _port_specs(arch, cfg))
    if registry.get(arch).family == "lm":
        got_layers = got["layers"]
        assert all(lp == got_layers[0] for lp in got_layers)
        got = {**got, "layers": jax.tree.map(
            lambda s: _trim((None,) + s), got_layers[0],
            is_leaf=lambda x: isinstance(x, tuple))}
    flat_w = jax.tree.leaves(want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    flat_g = leaves(_mark(got))
    assert len(flat_w) == len(flat_g)
    for w, g in zip(flat_w, flat_g):
        assert _as_tuple(w) == g.spec
    # the shardings carry the same specs
    sh = sharding.tree_shardings(_Stub(shape, names), _port_layout(arch, jparams),
                                 _port_specs(arch, cfg))
    assert [s.spec for s in leaves(sh)] == [g.spec for g in leaves(_mark(port))]


def _trim(spec):
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


class _Leaf:
    def __init__(self, spec):
        self.spec = spec


def _mark(tree):
    """A spec tree with each spec wrapped, so the port's tree walker keeps
    it a leaf."""
    if isinstance(tree, dict):
        return {k: _mark(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_mark(v) for v in tree]
    return _Leaf(tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_mirror_the_ports_params(arch):
    """Each family's ``param_specs`` names every leaf of the port's init
    (at ``smoke_config``), in the same order, with one logical axis a
    dimension; the LM's stack to the reference's layout."""
    from repro_torch import convert
    from repro_torch.configs import registry
    from repro_torch.distributed import sharding
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.tree import leaves_with_paths

    entry = registry.get(arch)
    cfg = registry.smoke_config(arch)
    if entry.family == "lm":
        params = transformer.init_lm(cfg, torch.Generator().manual_seed(0))
    elif entry.family == "gnn":
        params = steps.gnn_init(cfg, _gnn_shape(), device="cpu")
    else:
        params = steps.recsys_init(cfg, device="cpu")
    specs = _port_specs(arch, cfg)
    by_path = sharding.logical_by_path(specs)
    got = leaves_with_paths(params)
    assert [k for k, _ in got] == list(by_path)
    for k, p in got:
        assert len(by_path[k]) == p.dim(), k
    if entry.family == "lm":
        _, jspecs = _ref_tree(arch)
        stacked = convert.stack_layer_specs(specs)
        assert sharding.logical_by_path(stacked) == sharding.logical_by_path(jspecs)


def _gnn_shape():
    from repro_torch.configs.base import GraphShape

    return GraphShape(**GNN_MOL)


def test_batch_spec_and_replicated_are_the_references():
    from repro.distributed import sharding as j_sharding
    from repro_torch.distributed import sharding

    for shape, names in STUB_MESHES.values():
        assert sharding.batch_spec(_Stub(shape, names), 2) == _as_tuple(
            j_sharding.batch_spec(_JStub(shape, names), 2))
        assert sharding.replicated(_Stub(shape, names)).spec == ()


def test_respec_drops_the_axes_a_mesh_lacks():
    from repro_torch.distributed import sharding

    assert sharding.respec(_Stub((4,), ("data",)), [["data", "model"], None]) == ()
    assert sharding.respec(_Stub((4, 1), ("data", "model")), [["data", "model"], None]) == \
        (("data", "model"),)
    assert sharding.respec(_Stub((2, 2), ("data", "model")), [None, "model"]) == (None, "model")
    assert sharding.respec(None, ["data"]) == ()


def test_build_cell_refuses_the_cells_left_for_later():
    from repro_torch.launch import steps

    stub = _Stub((2, 2), ("data", "model"))
    for arch, shape in (("bst", "train_batch"), ("dlrm-mlperf", "serve_p99"),
                        ("qwen3-8b", "adacur_serve"), ("granite-moe-1b-a400m", "adacur_serve")):
        with pytest.raises(NotImplementedError, match="item 2c"):
            steps.build_cell(arch, shape, mesh=stub, device="cpu")


# -- the world -----------------------------------------------------------------


def _interact_inputs():
    """``check_gnn_interact``'s inputs (tests/test_multidevice.py) on a
    2 x 2 mesh, and the reference's ``_interact`` on them."""
    from repro.configs import registry as j_registry
    from repro.models.gnn import nequip as j_nq

    cfg = dataclasses.replace(j_registry.smoke_config("nequip"), d_hidden=8)
    params, _ = j_nq.init_nequip(jax.random.PRNGKey(0), cfg)
    h, n_per, n_shards, e_per = 8, 8, 2, 16
    n, e = n_per * n_shards, e_per * n_shards
    pos = jax.random.normal(jax.random.PRNGKey(3), (n, 3)) * 2
    recv = jnp.concatenate([
        jax.random.randint(jax.random.PRNGKey(10 + i), (e_per,), i * n_per, (i + 1) * n_per)
        for i in range(n_shards)])
    send = jax.random.randint(jax.random.PRNGKey(4), (e,), 0, n)
    feats = {"s": jax.random.normal(jax.random.PRNGKey(5), (n, h)),
             "v": jax.random.normal(jax.random.PRNGKey(6), (n, h, 3)) * 0.1,
             "t": jax.random.normal(jax.random.PRNGKey(7), (n, h, 3, 3)) * 0.1}
    lp = params["layers"][0]

    @jax.jit
    def ref_block(lp, feats, pos, send, recv):   # one compiled call: eager JAX takes ~10 s
        rhat, y2, rbf = j_nq._edge_geometry(pos, send, recv, cfg)
        return j_nq._interact(lp, feats, send, recv, rhat, y2, rbf, n, h)

    ref = ref_block(lp, feats, pos, send, recv)
    f = {k: np.asarray(v) for k, v in feats.items()}
    x = np.concatenate([f["s"][:, None], f["v"].transpose(0, 2, 1),
                        f["t"].reshape(n, h, 9).transpose(0, 2, 1)], axis=1)
    arrs = dict(x=x, pos=np.asarray(pos), send=np.asarray(send, np.int32),
                recv=np.asarray(recv, np.int32), n=n, h=h,
                **{f"lin_{k}": np.asarray(v) for k, v in lp["lin"].items()},
                **{f"radial_{k}": np.asarray(v) for k, v in lp["radial"].items()})
    return arrs, {k: np.asarray(v) for k, v in ref.items()}


def _ref_gnn(jparams, jcfg, shape, batch):
    """The reference's step on a 1 x 1 Auto mesh (loss, clip norm) and its
    loss gradients, on the port's batch."""
    from repro.configs.base import GraphShape as JGraphShape
    from repro.launch import steps as j_steps
    from repro.models.gnn import nequip as j_nq
    from repro.training import optimizer as j_opt

    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    jb = j_steps.build_gnn_train("nequip", jcfg, JGraphShape(**shape), mesh)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    n_graphs = jbatch["energy"].shape[0]
    with jax.set_mesh(mesh):
        _, _, jm = jax.jit(jb.step)(jparams, j_opt.init_adamw(jparams), jbatch)
    grads = jax.jit(jax.grad(lambda p: j_nq.energy_mse_loss(p, jcfg, jbatch,
                                                              n_graphs=n_graphs)))(jparams)
    return dict(loss=float(jm["loss"]), norm=float(jm["grad_norm"]),
                grads=jax.tree.map(np.asarray, grads))


def _ref_dlrm(jparams, jcfg, batch):
    from repro.configs.shapes import RecSysShape as JRecSysShape
    from repro.launch import steps as j_steps
    from repro.models.recsys import dlrm as j_dl
    from repro.training import optimizer as j_opt

    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    jb = j_steps.build_recsys_train("dlrm-mlperf", jcfg,
                                    JRecSysShape("train_batch", "train", DLRM_B), mesh)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    with jax.set_mesh(mesh):
        _, _, jm = jax.jit(jb.step)(jparams, j_opt.init_adamw(jparams), jbatch)
    grads = jax.jit(jax.grad(lambda p: j_dl.bce_loss(p, jbatch["dense"], jbatch["sparse"],
                                                      jbatch["labels"], jcfg)))(jparams)
    return dict(loss=float(jm["loss"]), norm=float(jm["grad_norm"]),
                grads=jax.tree.map(np.asarray, grads))


def _port_one_device(bundle, loss_fn):
    """The port's one-device step: (loss, gradients by path, clip norm)."""
    from repro_torch.tree import leaves, leaves_with_paths

    params, state, batch = bundle.args
    loss = loss_fn(params, batch)
    loss.backward()
    grads = {k: p.grad.clone() for k, p in leaves_with_paths(params)}
    for p in leaves(params):
        p.grad = None
    _, _, met = bundle.step(params, state, batch)
    return dict(loss=float(loss.detach()), grads=grads, norm=float(met["grad_norm"]))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs, then three things side by side: the 4-rank world, the
    reference's sharded step in its subprocess, and (here) the reference's
    and the port's one-device steps."""
    from concurrent.futures import ThreadPoolExecutor

    from repro.configs.base import GNNConfig as JGNNConfig, RecSysConfig as JRecSysConfig
    from repro.models.gnn import nequip as j_nq
    from repro.models.recsys import dlrm as j_dl
    from repro_torch import convert
    from repro_torch.configs.base import GraphShape, RecSysShape
    from repro_torch.launch import steps
    from repro_torch.models.gnn import nequip
    from repro_torch.testing import run_world

    out = tmp_path_factory.mktemp("mesh_train")
    arrs, interact_ref = _interact_inputs()
    np.savez(out / "interact.npz", **arrs)
    gcfg = _gnn_cfg()
    jgcfg = JGNNConfig(**dataclasses.asdict(gcfg))
    jgp, _ = j_nq.init_nequip(jax.random.PRNGKey(0), jgcfg)
    gtree = jax.tree.map(np.asarray, jgp)
    gnn = {"params": convert.nequip_params(gtree, device="cpu")}
    for name, shape in (("small", GNN_SMALL), ("molecule", GNN_MOL)):
        gnn[name] = steps.gnn_inputs(gcfg, GraphShape(**shape), seed=2, device="cpu")
    torch.save(gnn, out / "gnn.pt")
    dcfg = _dlrm_cfg()
    jdcfg = JRecSysConfig(**dataclasses.asdict(dcfg))
    jdp, _ = j_dl.init_dlrm(jax.random.PRNGKey(0), jdcfg)
    dtree = jax.tree.map(np.asarray, jdp)
    dbatch = steps.recsys_train_inputs(dcfg, DLRM_B, seed=3, device="cpu")
    torch.save({"params": convert.dlrm_params(dtree, device="cpu"), "batch": dbatch},
               out / "dlrm.pt")
    np.savez(out / "dlrm_batch.npz", **{k: v.numpy() for k, v in dbatch.items()})

    t0 = time.monotonic()
    with ThreadPoolExecutor(2) as pool:
        ranks_f = pool.submit(run_world, [sys.executable, __file__, "worker", str(out)], WORLD,
                              SPAWN_TIMEOUT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        sharded_f = pool.submit(_ref_sharded_steps, out)
        ref, one = {}, {}
        for name, shape in (("small", GNN_SMALL), ("molecule", GNN_MOL)):
            gs = GraphShape(**shape)
            ref[name] = _ref_gnn(jgp, jgcfg, shape, gnn[name])
            _, _, n_graphs = steps.gnn_sizes(gs)
            b = steps.build_gnn_train("nequip", gcfg, gs, params=convert.nequip_params(
                gtree, device="cpu"), batch=gnn[name], device="cpu")
            one[name] = _port_one_device(b, lambda p, bt, n_graphs=n_graphs:
                                         nequip.energy_mse_loss(p, gcfg, bt, n_graphs=n_graphs))
        ref["dlrm"] = _ref_dlrm(jdp, jdcfg, dbatch)
        b = steps.build_recsys_train("dlrm-mlperf", dcfg,
                                     RecSysShape("train_batch", "train", DLRM_B),
                                     params=convert.dlrm_params(dtree, device="cpu"),
                                     device="cpu")
        b.args = (b.args[0], b.args[1], dbatch)
        one["dlrm"] = _port_one_device(b, lambda p, bt: _one_device_loss(p, bt, dcfg))
        ranks, sharded = ranks_f.result(), sharded_f.result()
    spawn_s = time.monotonic() - t0
    for r, (rc, o, e) in enumerate(ranks):
        assert rc == 0, f"rank {r} exited {rc}\n{o}\n{e[-6000:]}"
        assert "terminate called" not in e, f"rank {r}\n{e[-4000:]}"
    return dict(out=out, spawn_s=spawn_s, interact_ref=interact_ref, ref=ref, one=one,
                dtree=dtree, jdcfg=jdcfg, dbatch=dbatch, sharded=sharded,
                ranks=[torch.load(out / f"rank{r}.pt", weights_only=False)
                       for r in range(WORLD)])


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _grads_close(got: dict, want, what):
    """Every gradient within GRAD_REL of the largest |gradient|; ``want`` a
    dict by path or a reference (numpy) tree."""
    from repro_torch.tree import leaves_with_paths

    if not isinstance(want, dict) or set(want) != set(got):
        want = dict(leaves_with_paths(want))
    assert list(got) == list(want), what
    top = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for k, g in got.items():
        err = float(np.abs(g.numpy() - np.asarray(want[k])).max())
        assert err <= GRAD_REL * top, (what, k, err, top)


def test_production_mesh_shapes_and_refusals(world):
    res = world["ranks"][0]["production"]
    assert res["single"] == (("data", "model"), (2, 2))
    assert res["multi"] == (("pod", "data", "model"), (2, 2, 1))
    assert "needs 256 ranks" in res["default"]
    assert "needs 512 ranks" in res["default_multi"]
    assert "positive sizes" in res["short"]
    assert "needs 8 ranks" in res["wrong_size"]


def test_sharded_interact_matches_the_references_interact(world):
    """Each rank's (node shard, channel block) of the block's output, at the
    reference's multidevice TOL."""
    from repro_torch.models.gnn import nequip

    want = world["interact_ref"]
    n, h = want["s"].shape
    x = torch.zeros((n, 13, h))
    seen = set()
    for res in world["ranks"]:
        r = res["interact"]
        d, c = r["coord"]["data"], r["coord"]["model"]
        n_l, _, hl = r["out"].shape
        x[d * n_l:(d + 1) * n_l, :, c * hl:(c + 1) * hl] = r["out"]
        seen.add((d, c))
    assert len(seen) == 4
    got = nequip.features(x)
    for k in ("s", "v", "t"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=TOL, atol=TOL, err_msg=k)


@pytest.mark.parametrize("case", ["small", "molecule"])
def test_gnn_train_over_the_mesh_matches_both_steps(world, case):
    ref, one = world["ref"][case], world["one"][case]
    for r, res in enumerate(world["ranks"]):
        got = res["gnn"][case]
        assert _rel(got["loss"], ref["loss"]) <= LOSS_REL, (r, got["loss"], ref["loss"])
        assert _rel(got["loss"], one["loss"]) <= LOSS_REL
        assert got["step_loss"] == got["loss"]
        assert _rel(got["norm"], one["norm"]) <= NORM_REL, (got["norm"], one["norm"])
        assert _rel(got["norm"], ref["norm"]) <= NORM_REL, (got["norm"], ref["norm"])
        _grads_close(got["grads"], one["grads"], f"{case} port")
        _grads_close(got["grads"], ref["grads"], f"{case} reference")


def test_gnn_small_graph_is_receiver_partitioned(world):
    """The forced sharded interact's edge blocks hold each shard's real edges
    (padded to the largest); the molecule's are the edges spread over all
    four ranks."""
    from repro_torch.configs.base import GraphShape
    from repro_torch.launch import steps

    batch = torch.load(world["out"] / "gnn.pt", weights_only=False)["small"]
    n_l = batch["positions"].shape[0] // 2
    shard = batch["receivers"].long() // n_l
    real = batch["edge_mask"] != 0
    width = int(torch.bincount(shard[real], minlength=2).max())
    assert all(res["gnn"]["small"]["edges_local"] == width for res in world["ranks"])
    _, e, _ = steps.gnn_sizes(GraphShape(**GNN_MOL))
    assert all(res["gnn"]["molecule"]["edges_local"] == e // 4 for res in world["ranks"])


@pytest.mark.parametrize("mesh_name", ["2x2", "pod2x2"])
def test_dlrm_train_over_the_mesh_matches_both_steps(world, mesh_name):
    ref, one = world["ref"]["dlrm"], world["one"]["dlrm"]
    rows = {"2x2": 4, "pod2x2": 2}[mesh_name]
    for res in world["ranks"]:
        got = res["dlrm"][mesh_name]
        assert _rel(got["loss"], ref["loss"]) <= LOSS_REL
        assert _rel(got["loss"], one["loss"]) <= LOSS_REL
        assert _rel(got["norm"], one["norm"]) <= NORM_REL, (got["norm"], one["norm"])
        assert _rel(got["norm"], ref["norm"]) <= NORM_REL, (got["norm"], ref["norm"])
        _grads_close(got["grads"], one["grads"], f"{mesh_name} port")
        _grads_close(got["grads"], ref["grads"], f"{mesh_name} reference")
        # each rank holds its rows of the tables (table_rows' rule), no more
        full = world["dtree"]["tables"][0].shape[0]
        assert got["table_rows_local"] == full // rows


def test_elastic_restore_round_trip(world):
    """2 x 2 -> 4 x 1 -> one rank: every leaf bitwise the saved one, and the
    next step within the bars of the uninterrupted run's."""
    r0 = world["ranks"][0]["elastic"]
    for res in world["ranks"]:
        e = res["elastic"]
        assert set(e["restored41"]) == set(r0["saved"])
        for k, v in r0["saved"].items():
            assert torch.equal(e["restored41"][k], v), k
        assert _rel(e["next41"]["loss"], r0["next"]["loss"]) <= LOSS_REL
        assert _rel(e["next41"]["norm"], r0["next"]["norm"]) <= NORM_REL
        _grads_close(e["next41"]["grads"], r0["next"]["grads"], "4x1")
    for k, v in r0["saved"].items():
        assert torch.equal(r0["restored1"][k], v), k
    assert _rel(r0["next1"]["loss"], r0["next"]["loss"]) <= LOSS_REL
    _grads_close(r0["next1"]["grads"], r0["next"]["grads"], "one rank")


def test_run_with_recovery_over_the_mesh_is_bitwise_the_uninterrupted_run(world):
    for res in world["ranks"]:
        r = res["recovery"]
        assert r["crashed"] == [2] and r["steps"] == 3
        assert set(r["got"]) == set(r["want"])
        for k, v in r["want"].items():
            assert torch.equal(r["got"][k], v), k


def test_the_references_checkpointer_reads_the_sharded_save(world):
    from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
    from repro.models.recsys import dlrm as j_dl
    from repro.training import optimizer as j_opt

    jp, _ = j_dl.init_dlrm(jax.random.PRNGKey(0), world["jdcfg"])
    like = {"params": jp, "opt": j_opt.init_adamw(jp)}
    tree = JCheckpointer(str(world["out"] / "ckpt")).restore(1, like)
    saved = world["ranks"][0]["elastic"]["saved"]
    got = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    flat = {"/".join(_key(p) for p in path): np.asarray(v) for path, v in got.items()}
    assert set(flat) == set(saved)
    for k, v in saved.items():
        assert np.array_equal(flat[k], v.numpy()), k
    with open(world["out"] / "ckpt" / "step_1" / "manifest.json") as f:
        manifest = json.load(f)["leaves"]
    assert manifest["params/tables/0"]["spec"] == [["data", "model"]]


def _key(p):
    if hasattr(p, "key"):
        return str(p.key)
    if hasattr(p, "name"):
        return f".{p.name}"
    return str(p.idx)


def test_every_rank_ran_every_case(world):
    """Each rank ran the world's cases in order (its seconds a case are
    printed; the world's wall time is bounded by ``SPAWN_TIMEOUT`` alone)."""
    names = ["production", "interact", "gnn", "dlrm", "elastic", "recovery"]
    for r, res in enumerate(world["ranks"]):
        assert list(res["seconds"]) == names, r
        assert all(s >= 0 for s in res["seconds"].values()), r
    print("world", world["spawn_s"], [res["seconds"] for res in world["ranks"]])


# -- the reference's own sharded step ------------------------------------------


def _ref_sharded_steps(out: Path) -> dict:
    """The reference's ``build_recsys_train`` step on a forced 2 x 2 CPU
    mesh, of Auto and of Explicit axes, in a subprocess of 4 host
    devices: {axis type: its loss and clip norm, or what it raised}."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, __file__, "reference", str(out)],
                          env=env, capture_output=True, text=True, timeout=SPAWN_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def reference_worker(out_dir: str) -> None:
    import jax
    import jax.numpy as jnp

    from repro.configs import registry as j_registry
    from repro.configs.shapes import RecSysShape as JRecSysShape
    from repro.launch import steps as j_steps
    from repro.models.recsys import dlrm as j_dl
    from repro.training import optimizer as j_opt

    cfg = j_registry.smoke_config("dlrm-mlperf")
    batch = {k: jnp.asarray(v) for k, v in np.load(Path(out_dir) / "dlrm_batch.npz").items()}
    params, _ = j_dl.init_dlrm(jax.random.PRNGKey(0), cfg)
    res = {}
    for name, kind in (("auto", jax.sharding.AxisType.Auto),
                       ("explicit", jax.sharding.AxisType.Explicit)):
        mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(kind,) * 2)
        jb = j_steps.build_recsys_train("dlrm-mlperf", cfg,
                                        JRecSysShape("train_batch", "train", DLRM_B), mesh)
        try:
            with jax.set_mesh(mesh):
                args = jax.device_put((params, j_opt.init_adamw(params), batch), jb.in_shardings)
                _, _, m = jax.jit(jb.step, in_shardings=jb.in_shardings,
                                  out_shardings=jb.out_shardings)(*args)
            res[name] = {"loss": float(m["loss"]), "norm": float(m["grad_norm"])}
        except Exception as e:  # noqa: BLE001 — the raise is the result
            res[name] = {"raised": f"{type(e).__name__}: {e}"[:400]}
    print(json.dumps(res))


def test_the_references_sharded_step_runs_on_auto_axes_and_holds_the_port(world):
    got = world["sharded"]["auto"]
    assert "raised" not in got, got
    for res in world["ranks"]:
        assert _rel(res["dlrm"]["2x2"]["loss"], got["loss"]) <= LOSS_REL
        assert _rel(res["dlrm"]["2x2"]["norm"], got["norm"]) <= NORM_REL


def test_the_references_sharded_step_raises_on_explicit_axes(world):
    """ROADMAP.md, queue 3: JAX's default (Explicit) axes refuse the
    reference's sharded step (the MLP weights' contraction meets two
    shardings), so its sharded train steps run only on Auto meshes."""
    got = world["sharded"]["explicit"]
    assert "ShardingTypeError" in got.get("raised", ""), got


if __name__ == "__main__" and len(sys.argv) == 3 and sys.argv[1] == "worker":
    sys.path.insert(0, str(ROOT / "src"))
    worker(sys.argv[2])
elif __name__ == "__main__" and len(sys.argv) == 3 and sys.argv[1] == "reference":
    sys.path.insert(0, str(ROOT / "src"))
    reference_worker(sys.argv[2])
