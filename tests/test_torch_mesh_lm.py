"""The LM family over a mesh in the port (``build_lm_train`` /
``build_lm_prefill`` / ``build_lm_decode`` with ``mesh=``: the
tensor-parallel layer, FSDP, the trainable expert-parallel MoE, remat and
the vocab-parallel loss), held against the port's one-device steps and the
JAX package's ``build_lm_train`` step run live on the same numpy inputs
and weights, for the registry's five LMs at ``smoke_config`` in fp32.

One gloo world of 4 CPU ranks, spawned once for the module (each rank runs
this file as ``python tests/test_torch_mesh_lm.py worker DIR``):

- ``build_lm_train(mesh=)`` on data 2 x model 2 for every arch, on data
  1 x model 4 for a dense one, with FSDP forced on 2 x 2, with
  ``n_micro=2``, and for a MoE arch with ``scatter_tokens`` off (the
  builder's choice patched): the loss within 1e-5 relative and every
  gradient leaf within 1e-4 of the largest |gradient|, against the mean of
  the one-device steps over the data shards (the reference's MoE aux and
  capacity are per data shard, so a data-parallel step is that mean; for a
  dense model it is the whole batch's step) and against the reference's
  step on a 1 x 1 mesh, shard by shard; two runs bitwise, remat on against
  off bitwise;
- a bf16 model at ``n_micro=2``: fp32 gradients against the one-device
  ``optimizer.accumulate_grads`` (microbatches added in fp32), and the
  accumulation's bits on a leaf where a bf16 sum would drop the second
  microbatch;
- ``fsdp.reduce_scatter`` of bf16 blocks over four ranks: an fp32 sum cast
  back once, bitwise;
- each rank's pieces of the drawn parameters equal to ``Sharding.local``
  of the whole leaves, and no piece larger than its share;
- ``build_lm_prefill(mesh=)``: the last logits and the gathered cache
  against one device's prefill, then a mesh decode from that cache against
  one device's decode (2e-4 of the largest |logit|);
- ``build_lm_decode(mesh=)`` with its weights placed by ``tree_specs``
  against one device's decode and the parent's mesh decode (dense weights
  whole on every rank);
- ``build_cell(mesh=)`` dispatching every LM shape kind (train, prefill,
  decode, long_500k) to its mesh builder at ``smoke_config``.
"""

import dataclasses
import os
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
SPAWN_TIMEOUT = 240
LOSS_REL, GRAD_REL = 1e-5, 1e-4
LOGIT_TOL = 2e-4                  # of the largest |logit| (the reference's multidevice TOL)
ARCHS = ("qwen3-8b", "qwen1.5-110b", "starcoder2-3b", "moonshot-v1-16b-a3b",
         "granite-moe-1b-a400m")
DENSE, FSDP_ARCH, MOE = "qwen3-8b", "starcoder2-3b", "granite-moe-1b-a400m"
L, B = 16, 4                      # train and prefill tokens a sequence, global batch
DECODE_POS = 9                    # the placed decode's position in a 16-entry cache
MOE_D, MOE_T = 12, 32             # the EP MoE's width and a data shard's tokens
RS_N = 256                        # a rank's block of the bf16 reduce-scatter
# the variants on top of every arch's data 2 x model 2 step: (name, arch, mesh, kwargs)
VARIANTS = (("1x4", DENSE, "1x4", {}),
            ("fsdp", FSDP_ARCH, "2x2", {"use_fsdp": True}),
            ("fsdp_moe", MOE, "2x2", {"use_fsdp": True}),
            ("micro", DENSE, "2x2", {"n_micro": 2}),
            ("no_scatter", MOE, "2x2", {"scatter_tokens": False}),
            ("no_remat", MOE, "2x2", {"remat": False}),
            ("no_remat_dense", DENSE, "2x2", {"remat": False}),
            ("vocab_whole", MOE, "2x2", {"vocab_whole": True}))
# a bf16 model's microbatches, held to one device's fp32-accumulated step
BF16_VARIANTS = (("micro_bf16", DENSE, "2x2", {"n_micro": 2, "bf16": True}),)
# configs and lengths that leave a split whole: (name, arch, mesh, config
# changes, sequence length) -- six heads on four model ranks (attention whole
# on each, its output's sequence chunk kept), and 18 tokens on four (the
# residual whole, the combines all-reduced; granite's two kv heads whole)
SHAPE_VARIANTS = (("heads_whole", DENSE, "1x4", {"n_heads": 6}, L),
                  ("seq_whole", DENSE, "1x4", {}, 18),
                  ("seq_whole_moe", MOE, "1x4", {}, 18))


# ---------------------------------------------------------------------------
# the world's ranks
# ---------------------------------------------------------------------------


def _whole(tree, shardings) -> dict:
    from repro_torch.tree import leaves, leaves_with_paths

    return {k: s.gather(x.detach()).clone()
            for (k, x), s in zip(leaves_with_paths(tree), leaves(shardings))}


def _train(arch, cfg, params, batch, mesh, **kw):
    """Two value-and-gradient calls at the initial state, then one step."""
    from repro_torch.configs.base import LMShape
    from repro_torch.launch import steps

    from repro_torch.distributed import sharding

    from repro_torch.tree import tree_map

    remat = kw.pop("remat", True)
    c = dataclasses.replace(cfg, remat=remat)
    if kw.pop("bf16", False):
        c = dataclasses.replace(c, dtype="bfloat16")
        params = tree_map(lambda x: x.to(bf16()), params)
    shape = LMShape("train_small", "train", batch["tokens"].shape[1], B)
    rules, moe_fn = dict(sharding.DEFAULT_RULES), steps._lm_moe_fn
    if kw.pop("vocab_whole", False):    # as a model axis that does not divide the vocab
        sharding.DEFAULT_RULES["vocab"] = (None,)
    if not kw.pop("scatter_tokens", True):      # the combine all-reduced, as a whole residual's
        steps._lm_moe_fn = lambda *a: moe_fn(*a[:4], False)
    try:
        b = steps.build_lm_train(arch, c, shape, params=params, batch=batch, device="cpu",
                                 mesh=mesh, **kw)
    finally:
        sharding.DEFAULT_RULES.update(rules)
        steps._lm_moe_fn = moe_fn
    vocab_split = b.shardings["embed"].spec[:1] == ("model",)
    pieces, state, bt = b.args
    loss, grads = b.step.value_and_grad(pieces, bt)
    loss2, grads2 = b.step.value_and_grad(pieces, bt)
    whole, whole2 = _whole(grads, b.shardings), _whole(grads2, b.shardings)
    _, _, met = b.step(pieces, state, bt)
    return dict(loss=float(loss), grads=whole, step_loss=float(met["loss"]),
                norm=float(met["grad_norm"]), vocab_split=vocab_split,
                grad_dtypes={str(g.dtype) for g in whole.values()},
                bitwise=bool(loss.item() == loss2.item() and all(
                    torch_equal(whole[k], whole2[k]) for k in whole)))


def bf16():
    import torch

    return torch.bfloat16


def torch_equal(a, b) -> bool:
    import torch

    return bool(torch.equal(a, b))


def _pieces_case(res, meshes):
    """Pieces drawn by the place hook against the whole draws' slices."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.configs.base import LMShape
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.tree import leaves, leaves_with_paths

    for name, arch, kw in (("tp", DENSE, {}), ("fsdp", FSDP_ARCH, {"use_fsdp": True}),
                           ("moe", MOE, {})):
        cfg = registry.smoke_config(arch)
        b = steps.build_lm_train(arch, cfg, LMShape("train_small", "train", L, B), seed=5,
                                 device="cpu", mesh=meshes["2x2"], **kw)
        whole = transformer.init_lm(cfg, torch.Generator().manual_seed(5))
        ok, split, sizes = True, 0, True
        for (path, piece), sh, w in zip(leaves_with_paths(b.args[0]), leaves(b.shardings),
                                        leaves(whole)):
            ok &= torch.equal(piece.detach(), sh.local(w))
            split += piece.numel() < w.numel()
            sizes &= tuple(piece.shape) == sh.local_shape(w.shape)
        res[name] = dict(equal=bool(ok), split_leaves=split, sizes=bool(sizes),
                         specs={k: s.spec for k, s in leaves_with_paths(b.shardings)})


def _prefill_case(blob, res, mesh):
    """The mesh prefill, then a mesh decode at the last position from its
    cache (the last token again: the entry is rewritten with itself)."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.configs.base import LMShape
    from repro_torch.launch import steps

    for arch in ARCHS:
        cfg = registry.smoke_config(arch)
        tokens = blob["tokens"][arch]
        p = steps.build_lm_prefill(arch, cfg, LMShape("prefill_small", "prefill", L, B),
                                   params=blob["params"][arch], tokens=tokens, device="cpu",
                                   mesh=mesh)
        logits, cache = p.step(*p.args)
        d = steps.build_lm_decode(arch, cfg, LMShape("decode_small", "decode", L, B),
                                  params=blob["params"][arch], device="cpu", mesh=mesh)
        rows = steps._rows(tokens, mesh, ("data",))
        dec, _ = d.step(d.args[0], {k: [{kv: c[kv].clone() for kv in c} for c in v]
                                     for k, v in cache.items()},
                        rows[:, L - 1], torch.tensor(L - 1))
        res[arch] = dict(logits=logits, cache=cache, decode=dec,
                         local_len=d.args[1]["layers"][0]["k"].shape[1])


def _decode_case(blob, res, mesh):
    """The placed mesh decode at DECODE_POS of a seeded 16-entry cache, and
    the parent's: the same core and experts, the dense weights whole."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import registry
    from repro_torch.configs.base import LMShape
    from repro_torch.distributed.decode_attention import make_decode_core
    from repro_torch.launch import steps
    from repro_torch.models import moe, transformer
    from repro_torch.tree import leaves

    di, mi = divmod(dist.get_rank(), 2)
    for arch in ARCHS:
        cfg = registry.smoke_config(arch)
        params = blob["params"][arch]
        d = steps.build_lm_decode(arch, cfg, LMShape("decode_small", "decode", L, B),
                                  params=params, device="cpu", mesh=mesh)
        lo, n = mi * L // 2, L // 2

        def chunk(c):
            return {kv: c[kv][di * 2:(di + 1) * 2, lo:lo + n].clone() for kv in c}

        cache = {k: [chunk(c) for c in v] for k, v in blob["cache"][arch].items()}
        token = blob["decode_token"][arch][di * 2:(di + 1) * 2]
        placed, _ = d.step(d.args[0], cache, token, torch.tensor(DECODE_POS))
        # the parent's mesh decode: dense weights whole, experts sliced
        core = make_decode_core(mesh, ("data",), ("model",), L, device="cpu")
        mine = dict(params)
        for part in ("prefix", "layers"):
            mine[part] = [dict(lp, moe=moe.expert_slice(lp["moe"], mesh)) if "moe" in lp
                          else lp for lp in params.get(part, [])]
        kw = dict(decode_core=core)
        if cfg.moe is not None:
            kw["moe_fn"] = moe.make_moe_fn(mesh, cfg.moe, ("data",), device="cpu")
        cache = {k: [chunk(c) for c in v] for k, v in blob["cache"][arch].items()}
        with torch.no_grad():
            parent, _ = transformer.decode_step(mine, cache, token, torch.tensor(DECODE_POS),
                                                cfg, **kw)
        res[arch] = dict(placed=placed, parent=parent,
                         dense_bytes=sum(p.numel() * p.element_size()
                                         for p in leaves(d.args[0])),
                         parent_bytes=sum(p.numel() * p.element_size()
                                          for p in leaves(mine)))


def _moe_grad_case(blob, res, mesh):
    """The trainable expert-parallel MoE on data 2 x model 2, its weights
    this rank's pieces under ``tree_specs`` (experts, router columns and
    the shared experts' columns on ``model``): the gradients of J = sum
    over the data shards of y . w + 0.01 x aux, each rank backpropagating
    its share, with the combine all-reduced and reduce-scattered."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import fsdp, sharding
    from repro_torch.models import moe
    from repro_torch.tree import leaves

    d = blob["moe"]
    cfg = d["cfg"]
    di, mi = divmod(dist.get_rank(), 2)
    model = fsdp.mesh_group(mesh, ("model",))
    shardings = sharding.tree_shardings(mesh, d["params"], moe.moe_specs(cfg))
    rows = d["x"].shape[0] // 2
    for scatter in (False, True):
        pieces = fsdp.shard_tree(d["params"], shardings)
        for p in leaves(pieces):
            p.requires_grad_(True)
        x = d["x"][di * rows:(di + 1) * rows].clone().requires_grad_(True)
        w = d["w"][di * rows:(di + 1) * rows]
        fn = moe.make_moe_fn(mesh, cfg, ("data",), scatter_tokens=scatter, device="cpu")
        fetched = {k: (fsdp.gather(v, shardings[k], keep=("model",)) if not isinstance(v, dict)
                       else {kk: fsdp.gather(vv, shardings[k][kk], keep=("model",))
                             for kk, vv in v.items()})
                   for k, v in pieces.items()}
        y, aux = fn(fetched, x)
        if scatter:
            part = (y * w[mi * rows // 2:(mi + 1) * rows // 2]).sum()
        else:
            part = (y * w).sum() / 2
        (part + 0.01 * aux / 4).backward()
        grads = fsdp.sync_grads(pieces, shardings)
        res[scatter] = dict(
            x_grad=fsdp._all_reduce_raw(x.grad, model),
            grads=[s.gather(g) for g, s in zip(grads, leaves(shardings))],
            specs=[s.spec for s in leaves(shardings)])


def _accumulate_case(res, mesh):
    """``sharded_value_and_grad(n_micro=2)`` on a bf16 leaf replicated over
    2 x 2 whose two microbatch gradients are 1 and 2^-9: added in fp32
    the mean keeps the second (0.5 + 2^-10 after the share and the sync);
    added in bf16 it would be lost (0.5)."""
    import torch

    from repro_torch.distributed import fsdp, sharding

    w = torch.ones(4, dtype=torch.bfloat16, requires_grad=True)
    vg = fsdp.sharded_value_and_grad(lambda p, mb: (p["w"] * mb["x"][0]).sum(),
                                     {"w": sharding.replicated(mesh)}, mesh, n_micro=2)
    x = torch.tensor([[1.0] * 4, [2.0 ** -9] * 4], dtype=torch.bfloat16)
    loss, grads = vg({"w": w}, {"x": x})
    res.update(grad=grads["w"].clone(), loss=float(loss))


def _reduce_scatter_case(res, mesh):
    """bf16 blocks reduce-scattered over the four model ranks of 1 x 4."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import fsdp

    x = rs_input(dist.get_rank())
    res["out"] = fsdp.reduce_scatter(x, fsdp.mesh_group(mesh, ("model",)), 0).clone()


def rs_input(rank: int):
    import torch

    rng = np.random.default_rng(100 + rank)
    return torch.tensor(rng.standard_normal(4 * RS_N).astype(np.float32)).to(torch.bfloat16)


def _cells_case(res, mesh):
    """``build_cell`` with the registry's arch at ``smoke_config`` and the
    LM shapes cut: each shape kind lands in its mesh builder."""
    import torch

    from repro_torch.configs import registry, shapes
    from repro_torch.configs.base import LMShape
    from repro_torch.launch import steps

    arch = MOE
    registry.REGISTRY[arch] = dataclasses.replace(registry.REGISTRY[arch],
                                                  config=registry.smoke_config(arch))
    cut = {"train_4k": LMShape("train_4k", "train", L, B),
           "prefill_32k": LMShape("prefill_32k", "prefill", L, B),
           "decode_32k": LMShape("decode_32k", "decode", L, B),
           "long_500k": LMShape("long_500k", "decode", 4 * L, 1)}
    shapes.LM_SHAPES.update(cut)
    for name in cut:
        b = steps.build_cell(arch, name, mesh=mesh, device="cpu")
        out = dict(bundle=b.name, sharded=b.shardings is not None)
        if name == "train_4k":
            loss, _ = b.step.value_and_grad(b.args[0], b.args[2])
            out.update(loss=float(loss), rows=int(b.args[2]["tokens"].shape[0]))
        elif name == "prefill_32k":
            logits, cache = b.step(*b.args)
            out.update(rows=int(logits.shape[0]), cache_len=int(cache["layers"][0]["k"].shape[1]))
        else:
            logits, _ = b.step(*b.args)
            out.update(rows=int(logits.shape[0]), finite=bool(torch.isfinite(logits).all()),
                       cache_len=int(b.args[1]["layers"][0]["k"].shape[1]))
        res[name] = out
    try:
        steps.build_cell(arch, "adacur_serve", mesh=mesh, device="cpu")
        res["adacur_serve"] = None
    except NotImplementedError as e:
        res["adacur_serve"] = str(e)


def worker(out_dir: str) -> None:
    import faulthandler

    import torch
    import torch.distributed as dist

    from repro_torch.configs import registry
    from repro_torch.launch.mesh import end_world, make_mesh

    faulthandler.dump_traceback_later(SPAWN_TIMEOUT - 30, exit=True)
    torch.set_num_threads(1)
    out = Path(out_dir)
    meshes = {"2x2": make_mesh((2, 2), ("data", "model"), device="cpu"),
              "1x4": make_mesh((1, 4), ("data", "model"), device="cpu")}
    blob = torch.load(out / "lm.pt", weights_only=False)
    res = {"seconds": {}}

    def train_all(r):
        for arch in ARCHS:
            r[arch] = _train(arch, registry.smoke_config(arch), blob["params"][arch],
                             blob["batch"][arch], meshes["2x2"])

    def variants(r):
        for name, arch, mesh, kw in VARIANTS + BF16_VARIANTS:
            r[name] = _train(arch, registry.smoke_config(arch), blob["params"][arch],
                             blob["batch"][arch], meshes[mesh], **kw)
        for name, arch, mesh, cfg_kw, _ in SHAPE_VARIANTS:
            v = blob["shape_variants"][name]
            r[name] = _train(arch, dataclasses.replace(registry.smoke_config(arch), **cfg_kw),
                             v["params"], v["batch"], meshes[mesh])

    cases = [("train", train_all), ("variants", variants),
             ("pieces", lambda r: _pieces_case(r, meshes)),
             ("prefill", lambda r: _prefill_case(blob, r, meshes["2x2"])),
             ("decode", lambda r: _decode_case(blob, r, meshes["2x2"])),
             ("moe_grad", lambda r: _moe_grad_case(blob, r, meshes["2x2"])),
             ("accumulate", lambda r: _accumulate_case(r, meshes["2x2"])),
             ("reduce_scatter", lambda r: _reduce_scatter_case(r, meshes["1x4"])),
             ("cells", lambda r: _cells_case(r, meshes["2x2"]))]
    for name, fn in cases:
        t0 = time.monotonic()
        fn(res.setdefault(name, {}))
        res["seconds"][name] = time.monotonic() - t0
    torch.save(res, out / f"rank{dist.get_rank()}.pt")
    end_world()


# ---------------------------------------------------------------------------
# the test process
# ---------------------------------------------------------------------------

if __name__ != "__main__":
    torch = pytest.importorskip("torch")
    torch.set_num_threads(1)   # one intra-op thread: the suite runs a process a core
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp  # noqa: E402


def _j_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _port_grads(tree) -> dict:
    from repro_torch.tree import leaves_with_paths

    return {k: v.detach().clone() for k, v in leaves_with_paths(tree)}


def _one_device(arch, cfg, params, batch, shards: int = 2) -> dict:
    """The port's one-device loss and gradients, the mean over the data
    shards' parts of the batch."""
    from repro_torch.launch import steps
    from repro_torch.tree import leaves, unflatten_like

    for p in leaves(params):
        p.requires_grad_(True)
    ps = leaves(params)
    loss_fn = steps._lm_loss_fn(cfg)
    losses, acc, rows = [], None, B // shards
    for d in range(shards):
        loss = loss_fn(params, {k: v[d * rows:(d + 1) * rows] for k, v in batch.items()})
        gs = torch.autograd.grad(loss, ps)
        losses.append(float(loss.detach()))
        acc = list(gs) if acc is None else [a + g for a, g in zip(acc, gs)]
    for p in ps:
        p.requires_grad_(False)
    return dict(loss=sum(losses) / shards,
                grads=_port_grads(unflatten_like(params, [a / shards for a in acc])))


def _one_device_micro(arch, cfg, params, batch, n_micro: int, shards: int = 2) -> dict:
    """The port's one-device step over ``n_micro`` microbatches a data shard
    (``optimizer.accumulate_grads``: their gradients added in fp32), the
    mean over the data shards."""
    from repro_torch.launch import steps
    from repro_torch.training import optimizer
    from repro_torch.tree import leaves, tree_map, unflatten_like

    params = tree_map(lambda x: x.clone().requires_grad_(True), params)
    losses, acc, rows = [], None, B // shards
    for d in range(shards):
        micro = {k: v[d * rows:(d + 1) * rows].reshape((n_micro, rows // n_micro) + v.shape[1:])
                 for k, v in batch.items()}
        g, loss = optimizer.accumulate_grads(steps._lm_loss_fn(cfg), params, micro, n_micro)
        losses.append(float(loss))
        acc = leaves(g) if acc is None else [a + b for a, b in zip(acc, leaves(g))]
    return dict(loss=sum(losses) / shards,
                grads=_port_grads(unflatten_like(params, [a / shards for a in acc])))


def _reference(arch, jcfg, params, batch, shards: int = 2) -> dict:
    """The reference's ``build_lm_train`` step on a 1 x 1 mesh (its loss)
    and its loss's gradients, data shard by data shard, their mean."""
    from repro.configs.shapes import LMShape as JLMShape
    from repro.launch import steps as j_steps
    from repro.training import optimizer as j_opt
    from repro_torch import convert
    from _torch_lm import ref_tree

    jparams = jax.tree.map(jnp.asarray, ref_tree(params))
    mesh, rows = _j_mesh(), B // shards
    jb = j_steps.build_lm_train(arch, jcfg, JLMShape("train_small", "train",
                                                     batch["tokens"].shape[1], rows), mesh)
    loss_fn = j_steps._lm_loss_fn(jcfg, None, mesh)
    step = jax.jit(jb.step)
    grad = jax.jit(jax.grad(loss_fn))
    losses, acc = [], None
    with jax.set_mesh(mesh):
        for d in range(shards):
            jbatch = {k: jnp.asarray(v[d * rows:(d + 1) * rows].numpy())
                      for k, v in batch.items()}
            _, _, m = step(jparams, j_opt.init_adamw(jparams), jbatch)
            g = jax.tree.map(np.asarray, grad(jparams, jbatch))
            losses.append(float(m["loss"]))
            acc = g if acc is None else jax.tree.map(lambda a, b: a + b, acc, g)
    grads = convert.lm_params(jax.tree.map(lambda a: a / shards, acc), device="cpu")
    return dict(loss=sum(losses) / shards, grads=_port_grads(grads))


def _inputs(out: Path) -> dict:
    """Every arch's weights (drawn by the port), batch, prompt tokens and a
    seeded cache, saved for the ranks."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import MoEConfig
    from repro_torch.launch import steps
    from repro_torch.models import moe, transformer
    from _torch_lm import lm_params

    blob = {"params": {}, "batch": {}, "tokens": {}, "cache": {}, "decode_token": {}}
    rng = np.random.default_rng(0)
    for i, arch in enumerate(ARCHS):
        cfg = registry.smoke_config(arch)
        blob["params"][arch] = lm_params(cfg, seed=10 + i)
        tokens = torch.tensor(rng.integers(4, cfg.vocab_size, (B, L)).astype(np.int32))
        blob["batch"][arch] = {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}
        blob["tokens"][arch] = torch.tensor(rng.integers(4, cfg.vocab_size, (B, L))
                                            .astype(np.int32))
        cache = transformer.init_cache(cfg, B, L, device="cpu")
        for part in cache.values():
            for c in part:
                for kv in c:
                    c[kv].copy_(torch.tensor(rng.standard_normal(c[kv].shape)
                                             .astype(np.float32)))
        blob["cache"][arch] = cache
        blob["decode_token"][arch] = steps.lm_tokens(cfg, (B,), 7, "cpu")
    blob["shape_variants"] = {}
    for i, (name, arch, _, cfg_kw, n) in enumerate(SHAPE_VARIANTS):
        cfg = dataclasses.replace(registry.smoke_config(arch), **cfg_kw)
        tokens = torch.tensor(rng.integers(4, cfg.vocab_size, (B, n)).astype(np.int32))
        blob["shape_variants"][name] = dict(
            params=lm_params(cfg, seed=30 + i),
            batch={"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)})
    cfg = MoEConfig(n_experts=4, top_k=2, d_expert=16, n_shared_experts=1)
    blob["moe"] = dict(cfg=cfg, params=moe.moe_init(torch.Generator().manual_seed(3), MOE_D,
                                                    cfg),
                       x=torch.tensor(rng.standard_normal((2 * MOE_T, MOE_D)), dtype=torch.float32),
                       w=torch.tensor(rng.standard_normal((2 * MOE_T, MOE_D)), dtype=torch.float32))
    torch.save(blob, out / "lm.pt")
    return blob


def _local_moe_grads(d) -> dict:
    """J's gradients through the one-device MoE, data shard by shard."""
    from repro_torch.models import moe
    from repro_torch.tree import leaves

    params = {k: (v.clone().requires_grad_(True) if not isinstance(v, dict)
                  else {kk: vv.clone().requires_grad_(True) for kk, vv in v.items()})
              for k, v in d["params"].items()}
    x = d["x"].clone().requires_grad_(True)
    total, auxes = 0.0, []
    for s in range(2):
        rows = slice(s * MOE_T, (s + 1) * MOE_T)
        y, aux = moe.moe_apply_local(params, x[rows], d["cfg"])
        total = total + (y * d["w"][rows]).sum()
        auxes.append(aux)
    (total + 0.01 * (auxes[0] + auxes[1]) / 2).backward()
    return dict(x_grad=x.grad, grads=[p.grad for p in leaves(params)])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs, then the 4-rank world beside (here) the one-device and
    the reference's steps."""
    from concurrent.futures import ThreadPoolExecutor

    from repro.configs import registry as j_registry
    from repro.configs.base import replace as j_replace
    from repro_torch.configs import registry
    from repro_torch.configs.base import LMShape
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.testing import run_world

    out = tmp_path_factory.mktemp("mesh_lm")
    blob = _inputs(out)
    t0 = time.monotonic()
    with ThreadPoolExecutor(1) as pool:
        ranks_f = pool.submit(run_world, [sys.executable, __file__, "worker", str(out)], WORLD,
                              SPAWN_TIMEOUT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        one, ref, prefill, decode = {}, {}, {}, {}
        for name, arch, _, kw in BF16_VARIANTS:
            cfg = dataclasses.replace(registry.smoke_config(arch), dtype="bfloat16")
            weights = _bf16_tree(blob["params"][arch])
            one[name] = _one_device_micro(arch, cfg, weights, blob["batch"][arch],
                                          kw["n_micro"])
            one[name + "_fp32"] = _one_device(arch, registry.smoke_config(arch),
                                              _float_tree(weights), blob["batch"][arch])
        for name, arch, mesh, cfg_kw, _ in SHAPE_VARIANTS:
            v, shards = blob["shape_variants"][name], int(mesh[0])
            cfg = dataclasses.replace(registry.smoke_config(arch), **cfg_kw)
            one[name] = _one_device(arch, cfg, v["params"], v["batch"], shards)
            ref[name] = _reference(arch, j_replace(j_registry.smoke_config(arch), **cfg_kw),
                                   v["params"], v["batch"], shards)
        for arch in ARCHS:
            cfg, params = registry.smoke_config(arch), blob["params"][arch]
            one[arch] = _one_device(arch, cfg, params, blob["batch"][arch])
            ref[arch] = _reference(arch, j_registry.smoke_config(arch), params,
                                   blob["batch"][arch])
            pb = steps.build_lm_prefill(arch, cfg, LMShape("prefill_small", "prefill", L, B),
                                        params=params, tokens=blob["tokens"][arch],
                                        device="cpu")
            logits, cache = pb.step(*pb.args)
            with torch.no_grad():
                dec, _ = transformer.decode_step(
                    params, {k: [{kv: c[kv].clone() for kv in c} for c in v]
                             for k, v in cache.items()},
                    blob["tokens"][arch][:, L - 1], torch.tensor(L - 1), cfg)
            prefill[arch] = dict(logits=logits, cache=cache, decode=dec)
            with torch.no_grad():
                decode[arch] = transformer.decode_step(
                    params, {k: [{kv: c[kv].clone() for kv in c} for c in v]
                             for k, v in blob["cache"][arch].items()},
                    blob["decode_token"][arch], torch.tensor(DECODE_POS), cfg)[0]
        ranks = ranks_f.result()
    spawn_s = time.monotonic() - t0
    for r, (rc, o, e) in enumerate(ranks):
        assert rc == 0, f"rank {r} exited {rc}\n{o}\n{e[-6000:]}"
        assert "terminate called" not in e, f"rank {r}\n{e[-4000:]}"
    return dict(spawn_s=spawn_s, one=one, ref=ref, prefill=prefill, decode=decode, blob=blob,
                moe_local=_local_moe_grads(blob["moe"]),
                ranks=[torch.load(out / f"rank{r}.pt", weights_only=False)
                       for r in range(WORLD)])


def _bf16_tree(tree):
    from repro_torch.tree import tree_map

    return tree_map(lambda x: x.to(torch.bfloat16), tree)


def _float_tree(tree):
    from repro_torch.tree import tree_map

    return tree_map(lambda x: x.float(), tree)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _grads_close(got: dict, want: dict, what):
    assert list(got) == list(want), what
    top = max(float(w.abs().max()) for w in want.values())
    for k, g in got.items():
        err = float((g - want[k]).abs().max())
        assert err <= GRAD_REL * top, (what, k, err, top)


def _held(res, world, arch, what):
    for name in ("one", "ref"):
        want = world[name][arch]
        assert _rel(res["loss"], want["loss"]) <= LOSS_REL, (what, name, res["loss"],
                                                             want["loss"])
        _grads_close(res["grads"], want["grads"], (what, name))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_over_data_2_x_model_2_matches_both_steps(world, arch):
    for r, res in enumerate(world["ranks"]):
        _held(res["train"][arch], world, arch, f"rank {r}")
        assert _rel(res["train"][arch]["step_loss"], world["one"][arch]["loss"]) <= LOSS_REL


@pytest.mark.parametrize("name", [v[0] for v in VARIANTS])
def test_train_variants_match_both_steps(world, name):
    """data 1 x model 4, FSDP forced, two microbatches, the MoE's combine
    all-reduced, remat off, and the vocab whole over ``model`` (the
    embedding and the loss on the rank's sequence chunk): each within the
    bars of both steps."""
    arch = next(v[1] for v in VARIANTS if v[0] == name)
    for r, res in enumerate(world["ranks"]):
        _held(res["variants"][name], world, arch, f"{name} rank {r}")
        assert res["variants"][name]["vocab_split"] == (name != "vocab_whole")


@pytest.mark.parametrize("name", [v[0] for v in BF16_VARIANTS])
def test_bf16_microbatches_add_in_fp32_as_one_device_does(world, name):
    """A bf16 model at ``n_micro=2`` on 2 x 2: fp32 gradients and a loss
    within twice the bf16 noise of one device's step, whose microbatch
    gradients ``optimizer.accumulate_grads`` adds in fp32 (the noise: that
    step's largest distance from the fp32 step on the same weights; both
    bf16 steps are within it of the fp32 one, so of each other within
    twice it)."""
    want, exact = world["one"][name], world["one"][name + "_fp32"]
    noise = max(float((w - exact["grads"][k]).abs().max()) for k, w in want["grads"].items())
    loss_noise = abs(want["loss"] - exact["loss"])
    errs = {}
    for r, res in enumerate(world["ranks"]):
        got = res["variants"][name]
        assert got["grad_dtypes"] == {"torch.float32"}, (r, got["grad_dtypes"])
        assert abs(got["loss"] - want["loss"]) <= 2 * loss_noise, (r, got["loss"], want, exact)
        assert list(got["grads"]) == list(want["grads"])
        for k, g in got["grads"].items():
            errs[k] = max(errs.get(k, 0.0), float((g - want["grads"][k]).abs().max()))
    print("bf16 micro: largest error", max(errs.values()), "noise", noise,
          "loss", [res["variants"][name]["loss"] for res in world["ranks"]], want["loss"],
          exact["loss"])
    assert max(errs.values()) <= 2 * noise, sorted(errs.items(), key=lambda e: -e[1])[:3]


def test_microbatch_gradients_accumulate_in_fp32(world):
    """Two microbatch gradients 1 and 2^-9 of a bf16 leaf: their fp32 sum's
    mean, 0.5 + 2^-10 after the world's shares, where a bf16 sum gives 0.5."""
    for res in world["ranks"]:
        got = res["accumulate"]["grad"]
        assert got.dtype == torch.float32
        assert torch.equal(got, torch.full((4,), 0.5 + 2.0 ** -10)), got
    assert torch.tensor(0.125, dtype=torch.bfloat16) + 2.0 ** -12 == 0.125   # bf16 drops it


def test_bf16_reduce_scatter_rounds_once_over_four_ranks(world):
    """bf16 blocks over the four ranks of 1 x 4: the fp32 sum in rank order
    cast back once, bitwise (a bf16 sum in rank order rounds three times
    and differs)."""
    xs = [rs_input(r) for r in range(WORLD)]
    want = (xs[0].float() + xs[1].float() + xs[2].float() + xs[3].float()).to(torch.bfloat16)
    chained = xs[0] + xs[1] + xs[2] + xs[3]
    assert not torch.equal(chained, want)           # the case tells the two apart
    for r, res in enumerate(world["ranks"]):
        got = res["reduce_scatter"]["out"]
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, want[r * RS_N:(r + 1) * RS_N]), r


@pytest.mark.parametrize("name", [v[0] for v in SHAPE_VARIANTS])
def test_train_with_a_split_left_whole_matches_both_steps(world, name):
    """Heads that do not divide ``model`` and a sequence that does not:
    within the bars of both steps (their data shards: one on 1 x 4)."""
    for r, res in enumerate(world["ranks"]):
        _held(res["variants"][name], world, name, f"{name} rank {r}")


@pytest.mark.parametrize("arch", ARCHS)
def test_two_runs_are_bitwise(world, arch):
    for res in world["ranks"]:
        assert res["train"][arch]["bitwise"]
    assert all(res["variants"][name]["bitwise"] for res in world["ranks"]
               for name, *_ in VARIANTS + BF16_VARIANTS + SHAPE_VARIANTS)


@pytest.mark.parametrize("name,arch", [("no_remat", MOE), ("no_remat_dense", DENSE)])
def test_remat_on_and_off_are_bitwise(world, name, arch):
    for res in world["ranks"]:
        on, off = res["train"][arch], res["variants"][name]
        assert on["loss"] == off["loss"]
        assert all(torch.equal(on["grads"][k], off["grads"][k]) for k in on["grads"])


def test_model_replicas_agree_and_the_loss_is_the_data_mean(world):
    """The two model ranks of a data group return the same loss (the data
    shard's), and a step's reported loss is the mean over the data
    groups (equal on every rank)."""
    for arch in ARCHS:
        losses = [res["train"][arch]["loss"] for res in world["ranks"]]
        assert len(set(losses)) == 1, (arch, losses)


@pytest.mark.parametrize("name", ["tp", "fsdp", "moe"])
def test_each_ranks_pieces_are_the_whole_leaves_slices(world, name):
    for res in world["ranks"]:
        got = res["pieces"][name]
        assert got["equal"] and got["sizes"] and got["split_leaves"] > 0
    specs = world["ranks"][0]["pieces"][name]["specs"]
    assert specs["layers/0/attn/wq"][-1] == "model"          # heads used in place
    if name == "fsdp":
        assert specs["layers/0/attn/wq"][0] == "data" and specs["embed"][-1] == "data"
    else:                                                    # under 2e9: TP only
        assert all("data" not in (s if isinstance(s, tuple) else (s,))
                   for spec in specs.values() for s in spec if s is not None)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_over_the_mesh_matches_one_device(world, arch):
    want = world["prefill"][arch]
    v = registry_vocab(arch)
    top = float(want["logits"][:, :v].abs().max())
    for r, res in enumerate(world["ranks"]):
        di, mi = divmod(r, 2)
        got = res["prefill"][arch]
        rows = slice(di * B // 2, (di + 1) * B // 2)
        assert float((got["logits"][:, :v] - want["logits"][rows, :v]).abs().max()) <= \
            LOGIT_TOL * top
        assert got["local_len"] == L // 2
        for part in want["cache"]:
            for c, w in zip(got["cache"][part], want["cache"][part]):
                for kv in ("k", "v"):
                    chunk = w[kv][rows, mi * L // 2:(mi + 1) * L // 2]
                    assert c[kv].shape == chunk.shape, (part, kv)
                    scale = float(w[kv].abs().max())
                    assert float((c[kv] - chunk).abs().max()) <= LOGIT_TOL * scale


@pytest.mark.parametrize("arch", ARCHS)
def test_a_mesh_decode_continues_from_the_mesh_prefill(world, arch):
    want = world["prefill"][arch]["decode"]
    v = registry_vocab(arch)
    top = float(want[:, :v].abs().max())
    for r, res in enumerate(world["ranks"]):
        rows = slice(r // 2 * B // 2, (r // 2 + 1) * B // 2)
        got = res["prefill"][arch]["decode"]
        assert float((got[:, :v] - want[rows, :v]).abs().max()) <= LOGIT_TOL * top


@pytest.mark.parametrize("arch", ARCHS)
def test_placed_decode_matches_one_device_and_the_parents(world, arch):
    want = world["decode"][arch]
    v = registry_vocab(arch)
    top = float(want[:, :v].abs().max())
    for r, res in enumerate(world["ranks"]):
        rows = slice(r // 2 * B // 2, (r // 2 + 1) * B // 2)
        got = res["decode"][arch]
        assert float((got["placed"][:, :v] - want[rows, :v]).abs().max()) <= LOGIT_TOL * top
        assert float((got["placed"][:, :v] - got["parent"][:, :v]).abs().max()) <= \
            LOGIT_TOL * top
        assert got["dense_bytes"] < got["parent_bytes"]


def registry_vocab(arch) -> int:
    from repro_torch.configs import registry

    return registry.smoke_config(arch).vocab_size


@pytest.mark.parametrize("scatter", [False, True])
def test_trainable_ep_moe_gradients_equal_the_local_moes(world, scatter):
    """The input's and every weight's gradient of the expert-parallel MoE
    (pieces on 2 x 2) against the one-device MoE's, data shard by shard
    (within 1e-5 of the largest)."""
    want = world["moe_local"]
    for r, res in enumerate(world["ranks"]):
        got = res["moe_grad"][scatter]
        assert any("model" in (s if isinstance(s, tuple) else (s,))
                   for spec in got["specs"] for s in spec if s is not None)
        di = r // 2
        wx = want["x_grad"][di * MOE_T:(di + 1) * MOE_T]
        assert float((got["x_grad"] - wx).abs().max()) <= 1e-5 * float(wx.abs().max())
        top = max(float(g.abs().max()) for g in want["grads"])
        for g, w in zip(got["grads"], want["grads"]):
            assert g.shape == w.shape and float((g - w).abs().max()) <= 1e-5 * top


def test_build_cell_dispatches_every_lm_shape_kind_to_its_mesh_builder(world):
    for res in world["ranks"]:
        got = res["cells"]
        for name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            assert got[name]["bundle"] == f"{MOE}:{name}" and got[name]["sharded"], name
        assert got["train_4k"]["rows"] == B // 2 and np.isfinite(got["train_4k"]["loss"])
        assert got["prefill_32k"]["rows"] == B // 2
        assert got["prefill_32k"]["cache_len"] == L // 2
        assert got["decode_32k"]["rows"] == B // 2 and got["decode_32k"]["cache_len"] == L // 2
        assert got["long_500k"]["rows"] == 1 and got["long_500k"]["cache_len"] == L
        assert got["decode_32k"]["finite"] and got["long_500k"]["finite"]
        assert "item 2c" in got["adacur_serve"]


def test_every_rank_ran_every_case(world):
    names = ["train", "variants", "pieces", "prefill", "decode", "moe_grad", "accumulate",
             "reduce_scatter", "cells"]
    for r, res in enumerate(world["ranks"]):
        assert list(res["seconds"]) == names, r
    print("world", world["spawn_s"], [res["seconds"] for res in world["ranks"]])


if __name__ == "__main__" and len(sys.argv) == 3 and sys.argv[1] == "worker":
    sys.path.insert(0, str(ROOT / "src"))
    worker(sys.argv[2])
