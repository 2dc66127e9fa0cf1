"""The port's GNN family (``models/gnn/{nequip,sampler}.py``,
``steps.build_gnn_train``, the tensor-product op and the bag-kernel gather
and segment sum) on the CPU, against the JAX package run live on the same
numpy inputs, at ``smoke_config("nequip")`` (2 layers, d_hidden 4, 4
radial bases, 8 species) on seeded graphs of 16-64 nodes.

Weights are the reference's ``init_nequip(PRNGKey(0))`` carried across by
``convert.nequip_params``.  Bars (fp32; sums by receiver, matrix products
and the channel mixes run in another order than XLA's):

- energies and the loss within 1e-5 relative (of the largest |energy|);
- forces and every gradient leaf within 1e-4 of its largest |value|;
- one interaction block's node features within 1e-5 of their largest
  |value|, in one chunk and in edge chunks of 7;
- one ``build_gnn_train`` step: the loss within 1e-5 relative, every
  parameter within 1e-5 of the largest |parameter| (the bar of
  ``tests/test_torch_training.py``'s train steps);
- the sampler and the CSR form bit for bit; the segment sum's plain
  version against the backward kernel's emulated order within 1e-6 of the
  largest |sum| (bit for bit on integer-valued rows), and against
  ``jax.ops.segment_sum``.

The reference's rotation and translation properties
(``tests/test_substrate.py:316-351``) hold on the port at their bars.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # one intra-op thread: the suite runs a process a core
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import GNNConfig as JGNNConfig, GraphShape as JGraphShape  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.models.gnn import nequip as j_nequip, sampler as j_sampler  # noqa: E402
from repro.training import optimizer as j_opt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import GraphShape  # noqa: E402
from repro_torch.kernels.embedding_bag import ref as bag_ref  # noqa: E402
from repro_torch.kernels.embedding_bag.ops import gather_rows, segment_sum  # noqa: E402
from repro_torch.kernels.tensor_product import ops as tp_ops, ref as tp_ref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models.gnn import nequip, sampler  # noqa: E402
from repro_torch.tree import leaves, leaves_with_paths  # noqa: E402

ARCH = "nequip"
N_NODES, N_EDGES = 24, 80
D_FEAT = 6
N_GRAPHS = 3


def _cfg():
    cfg = registry.smoke_config(ARCH)
    return cfg, JGNNConfig(**dataclasses.asdict(cfg))


def _graph(seed, n=N_NODES, e=N_EDGES):
    """A seeded graph without self-loops: a self-loop's edge vector is 0, its
    rhat's gradient 1/r = 1e6, and its two equal and opposite terms in the
    forces cancel to fp32 noise (~5e-4) in an order each package picks."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e)
    return dict(pos=(rng.standard_normal((n, 3)) * 1.5).astype(np.float32),
                species=rng.integers(0, 8, n).astype(np.int32),
                feat=rng.standard_normal((n, D_FEAT)).astype(np.float32),
                s=s.astype(np.int32),
                r=((s + rng.integers(1, n, e)) % n).astype(np.int32),
                edge_mask=(rng.random(e) < 0.9).astype(np.float32),
                node_mask=(rng.random(n) < 0.9).astype(np.float32),
                graph_ids=np.sort(rng.integers(0, N_GRAPHS, n)).astype(np.int32),
                energy=rng.standard_normal(N_GRAPHS).astype(np.float32))


def _t(x):
    return torch.from_numpy(np.array(x))


def _params(jparams):
    return convert.nequip_params(jax.tree.map(np.asarray, jparams), device="cpu")


def _close(got, want, rel, what=""):
    got = got.detach().numpy() if hasattr(got, "detach") else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = rel * max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol, (what, float(np.abs(got - want).max()), tol)


# name -> (node features, forward kwargs on top of the edges)
FORMS = {
    "species": ("species", ()),
    "d_feat": ("feat", ()),
    "masked": ("species", ("edge_mask", "node_mask")),
    "graph_ids": ("species", ("edge_mask", "node_mask", "graph_ids")),
}


@pytest.fixture(scope="module")
def model():
    cfg, jcfg = _cfg()
    out = {}
    for d_feat in (0, D_FEAT):
        jp, _ = j_nequip.init_nequip(jax.random.PRNGKey(0), jcfg, d_feat=d_feat)
        out[d_feat] = (jp, _params(jp))
    return cfg, jcfg, out


def _kw(g, keys, torch_side):
    kw = {k: (_t(g[k]) if torch_side else jnp.asarray(g[k])) for k in keys}
    if "graph_ids" in keys:
        kw["n_graphs"] = N_GRAPHS
    return kw


@pytest.fixture(scope="module")
def forms(model):
    """Per form: the reference's energies, forces, loss and loss gradients
    (one jitted call each) and the port's."""
    cfg, jcfg, params = model
    g = _graph(0)
    out = {}
    for name, (attr, keys) in FORMS.items():
        jp, tp = params[D_FEAT if attr == "feat" else 0]
        jkw, tkw = _kw(g, keys, False), _kw(g, keys, True)
        n_graphs = jkw.pop("n_graphs", 1)
        tkw.pop("n_graphs", None)
        jargs = (jnp.asarray(g["pos"]), jnp.asarray(g[attr]), jnp.asarray(g["s"]),
                 jnp.asarray(g["r"]))
        targs = (_t(g["pos"]), _t(g[attr]), _t(g["s"]), _t(g["r"]))

        @jax.jit
        def ref(jp, pos, attr_, s, r, jkw=jkw, n_graphs=n_graphs):
            e = j_nequip.forward(jp, jcfg, pos, attr_, s, r, n_graphs=n_graphs, **jkw)
            _, f = j_nequip.energy_and_forces(jp, jcfg, pos, attr_, s, r, n_graphs=n_graphs,
                                              **jkw)
            batch = dict(positions=pos, node_attr=attr_, senders=s, receivers=r,
                         energy=jnp.asarray(g["energy"][:e.shape[0]]), **jkw)
            loss, grads = jax.value_and_grad(j_nequip.energy_mse_loss)(
                jp, jcfg, batch, n_graphs=n_graphs)
            return e, f, loss, grads

        je, jf, jl, jg = ref(jp, *jargs)
        te = nequip.forward(tp, cfg, *targs, n_graphs=n_graphs, **tkw)
        _, tf = nequip.energy_and_forces(tp, cfg, *targs, n_graphs=n_graphs, **tkw)
        steps.require_grad(tp)
        batch = dict(positions=targs[0], node_attr=targs[1], senders=targs[2],
                     receivers=targs[3], energy=_t(g["energy"][:te.shape[0]]), **tkw)
        tl = nequip.energy_mse_loss(tp, cfg, batch, n_graphs=n_graphs)
        tg = torch.autograd.grad(tl, leaves(tp))
        for p in leaves(tp):
            p.requires_grad_(False)
        out[name] = dict(je=je, jf=jf, jl=jl, jg=jax.tree.map(np.asarray, jg), te=te, tf=tf,
                         tl=tl, tg=tg, tp=tp)
    return out


@pytest.mark.parametrize("form", list(FORMS))
def test_energies_match_jax(forms, form):
    r = forms[form]
    assert r["te"].shape == r["je"].shape
    _close(r["te"], r["je"], 1e-5, form)


@pytest.mark.parametrize("form", list(FORMS))
def test_forces_match_jax(forms, form):
    _close(forms[form]["tf"], forms[form]["jf"], 1e-4, form)


@pytest.mark.parametrize("form", list(FORMS))
def test_loss_and_gradients_match_jax(forms, form):
    r = forms[form]
    assert abs(float(r["tl"]) - float(r["jl"])) <= 1e-5 * abs(float(r["jl"])), form
    want = leaves_with_paths(r["jg"])
    got = leaves_with_paths(r["tp"])
    assert [k for k, _ in want] == [k for k, _ in got]
    for (key, w), g in zip(want, r["tg"]):
        _close(g, w, 1e-4, f"{form} {key}")


@pytest.mark.parametrize("edge_chunk", [None, 7])
def test_interaction_block_matches_jax(model, edge_chunk):
    """One block on random irrep features: the port's (one chunk, or
    chunks of 7 edges, so the receiver ranges of neighbouring chunks share
    a boundary node) against the reference's ``_interact`` and its chunked
    ``_interact_inner_tp`` on one rank (identity radial slice, plain mix)."""
    cfg, jcfg, params = model
    jp, tp = params[0]
    g = _graph(3)
    rng = np.random.default_rng(4)
    h = cfg.d_hidden
    feats = dict(s=rng.standard_normal((N_NODES, h)), v=rng.standard_normal((N_NODES, h, 3)),
                 t=rng.standard_normal((N_NODES, h, 3, 3)))
    feats = {k: v.astype(np.float32) for k, v in feats.items()}
    feats["t"] = np.asarray(j_nequip._sym_traceless(jnp.asarray(feats["t"])))
    jf = jax.tree.map(jnp.asarray, feats)
    s, r = jnp.asarray(g["s"]), jnp.asarray(g["r"])
    rhat, y2, rbf = j_nequip._edge_geometry(jnp.asarray(g["pos"]), s, r, jcfg)
    lp = jp["layers"][0]
    if edge_chunk is None:
        want = j_nequip._interact(lp, jf, s, r, rhat, y2, rbf, N_NODES, h)
    else:
        def radial(rb):
            return j_nequip._radial_mlp(lp["radial"], rb).reshape(-1, len(tp_ref.PATHS), h)

        want = j_nequip._interact_inner_tp(lp, jf, jf, s, r, rhat, y2, rbf, N_NODES, radial,
                                           lambda cs, w, _: cs @ w, edge_chunk=edge_chunk)
    x = torch.cat([_t(feats["s"])[:, None], _t(feats["v"]).transpose(1, 2),
                   _t(feats["t"]).reshape(N_NODES, h, 9).transpose(1, 2)], dim=1)
    graph = nequip.edge_graph(_t(g["s"]), _t(g["r"]), N_NODES, edge_chunk)
    assert len(graph.chunks) == (1 if edge_chunk is None else -(-N_EDGES // 7))
    trhat, ty2, trbf = nequip._edge_geometry(_t(g["pos"]), graph, cfg)
    got = nequip.features(nequip._interact(tp["layers"][0], x, graph, trhat, ty2, trbf))
    for k in ("s", "v", "t"):
        _close(got[k], want[k], 1e-5, k)


@pytest.mark.parametrize("edge_chunk", [None, 5])
def test_message_passing_gradients_match_autograd_of_the_plain_messages(edge_chunk):
    """``message_passing``'s backward (sender-ordered chunks, geometry
    included) against autograd through an unchunked sum of the plain
    messages (``index_add_``)."""
    rng = np.random.default_rng(5)
    n, e, h, nb = 10, 40, 3, 4
    s, r = (torch.from_numpy(rng.integers(0, n, e).astype(np.int32)) for _ in range(2))
    table = torch.from_numpy(rng.standard_normal((n, 13 * h)).astype(np.float32))
    w1 = torch.from_numpy(rng.standard_normal((nb, 16)).astype(np.float32))
    w2 = torch.from_numpy(rng.standard_normal((16, 11 * h)).astype(np.float32))
    rel = torch.from_numpy(rng.standard_normal((e, 3)).astype(np.float32))
    rhat = rel / rel.norm(dim=1, keepdim=True)
    y2 = nequip._sym_traceless(rhat[:, :, None] * rhat[:, None, :])
    rbf = torch.from_numpy(rng.standard_normal((e, nb)).astype(np.float32))
    graph = nequip.edge_graph(s, r, n, edge_chunk)
    o = graph.order
    leaves_ = [t.clone().requires_grad_() for t in (table, w1, w2, rhat[o], y2[o], rbf[o])]
    got = nequip.message_passing(leaves_[0], {"w1": leaves_[1], "w2": leaves_[2]},
                                 *leaves_[3:], graph, h)
    gout = torch.from_numpy(rng.standard_normal(got.shape).astype(np.float32))
    gg = torch.autograd.grad(got, leaves_, gout)
    ref_leaves = [t.clone().requires_grad_() for t in (table, w1, w2, rhat, y2, rbf)]
    x = ref_leaves[0][s.long()].view(e, 13, h)
    w = nequip._radial_mlp(ref_leaves[1], ref_leaves[2], ref_leaves[5]).view(e, 11, h)
    m = tp_ref.tensor_product_plain(x, w, ref_leaves[3], ref_leaves[4]).reshape(e, -1)
    want = torch.zeros(n, 13 * h).index_add(0, r.long(), m)
    _close(got, want.detach(), 1e-5, "agg")
    wg = torch.autograd.grad(want, ref_leaves, gout)
    for i, (a, b) in enumerate(zip(gg, wg)):
        b = b[o] if i >= 3 else b
        _close(a, b.detach(), 1e-5, f"grad {i}")


def test_tensor_product_op_is_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(6)
    e, h = 9, 5
    x, w = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((e, 13, h), (e, 11, h)))
    rel = torch.from_numpy(rng.standard_normal((e, 3)).astype(np.float32))
    rhat = rel / rel.norm(dim=1, keepdim=True)
    y2 = nequip._sym_traceless(rhat[:, :, None] * rhat[:, None, :])
    assert torch.equal(tp_ops.tensor_product(x, w, rhat, y2),
                       tp_ref.tensor_product_plain(x, w, rhat, y2))
    g = torch.randn(e, 13, h, generator=torch.Generator().manual_seed(0))
    dx, dw, dr, dy = tp_ops.tensor_product_backward(x, w, rhat, y2, g, geometry=True)
    assert dx.shape == x.shape and dw.shape == w.shape and dr.shape == (e, 3)
    assert dy.shape == (e, 3, 3)
    assert tp_ops.tensor_product_backward(x, w, rhat, y2, g)[2] is None
    with pytest.raises(ValueError, match="w must be"):
        tp_ops.tensor_product(x, w[:, :10], rhat, y2)


@pytest.mark.parametrize("seed", [0, 1])
def test_rotation_invariant_energy(model, seed):
    """The reference's property (``test_property_rotation_invariant_energy``)
    on the port, at its bars."""
    cfg, _, params = model
    tp = params[0][1]
    g = _graph(10 + seed, n=16, e=50)
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    q = torch.from_numpy(q.astype(np.float32))
    pos, sp, s, r = _t(g["pos"]), _t(g["species"]), _t(g["s"]), _t(g["r"])
    e1 = nequip.forward(tp, cfg, pos, sp, s, r)
    e2 = nequip.forward(tp, cfg, pos @ q.T, sp, s, r)
    np.testing.assert_allclose(e1.numpy(), e2.numpy(), atol=3e-5, rtol=1e-4)


def test_translation_invariant(model):
    cfg, _, params = model
    tp = params[0][1]
    g = _graph(12, n=16, e=50)
    pos, sp, s, r = _t(g["pos"]), _t(g["species"]), _t(g["s"]), _t(g["r"])
    e1 = nequip.forward(tp, cfg, pos, sp, s, r)
    e2 = nequip.forward(tp, cfg, pos + 7.5, sp, s, r)
    np.testing.assert_allclose(e1.numpy(), e2.numpy(), atol=3e-5, rtol=1e-4)


def test_forces_rotate_covariantly(model):
    cfg, _, params = model
    tp = params[0][1]
    g = _graph(13, n=16, e=50)
    q, _ = np.linalg.qr(np.random.default_rng(7).normal(size=(3, 3)))
    q = torch.from_numpy(q.astype(np.float32))
    pos, sp, s, r = _t(g["pos"]), _t(g["species"]), _t(g["s"]), _t(g["r"])
    _, f1 = nequip.energy_and_forces(tp, cfg, pos, sp, s, r)
    _, f2 = nequip.energy_and_forces(tp, cfg, pos @ q.T, sp, s, r)
    np.testing.assert_allclose((f1 @ q.T).numpy(), f2.numpy(), atol=5e-4, rtol=5e-3)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

SMALL = dict(name="mol_small", kind="molecule", n_nodes=8, n_edges=16, batch_graphs=4)


@pytest.fixture(scope="module")
def train(model):
    """One step of the reference's ``build_gnn_train`` (jitted on a 1 x 1
    Auto mesh) and of the port's, from the same weights and batch."""
    cfg, jcfg, params = model
    shape = GraphShape(**SMALL)
    jp = params[0][0]
    batch = steps.gnn_inputs(cfg, shape, seed=2, device="cpu")
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    jb = j_steps.build_gnn_train(ARCH, jcfg, JGraphShape(**SMALL), mesh)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    with jax.set_mesh(mesh):
        jp1, js1, jm = jax.jit(jb.step)(jp, j_opt.init_adamw(jp), jbatch)
    b = steps.build_gnn_train(ARCH, cfg, shape, params=_params(jp), batch=batch, device="cpu")
    tp1, ts1, tm = b.step(*b.args)
    return dict(jp=jax.tree.map(np.asarray, jp1), jm=jm, tp=tp1, ts=ts1, tm=tm, b=b, jb=jb,
                batch=batch)


def test_train_step_matches_jax(train):
    r = train
    assert abs(float(r["tm"]["loss"]) - float(r["jm"]["loss"])) <= 1e-5 * abs(
        float(r["jm"]["loss"]))
    top = max(float(np.abs(x).max()) for x in leaves(r["jp"]))
    for (key, a), (_, w) in zip(leaves_with_paths(r["tp"]), leaves_with_paths(r["jp"])):
        assert float(np.abs(a.detach().numpy() - w).max()) <= 1e-5 * top, key
    assert int(r["ts"].step) == 1


def test_train_bundle_is_the_references(train):
    b, jb, batch = train["b"], train["jb"], train["batch"]
    assert b.model_flops == jb.model_flops
    want = jb.abstract_args[2]
    assert set(batch) == set(want)
    for k, v in want.items():
        assert tuple(batch[k].shape) == tuple(v.shape), k
        assert str(batch[k].dtype).split(".")[-1] == str(v.dtype), k


def test_molecule_batch_keeps_edges_inside_their_graphs():
    cfg, _ = _cfg()
    shape = GraphShape(**SMALL)
    b = steps.gnn_inputs(cfg, shape, seed=3, device="cpu")
    n_real, e_real = 4 * 8, 4 * 16
    gid = b["graph_ids"]
    assert torch.equal(gid[b["senders"][:e_real].long()], gid[b["receivers"][:e_real].long()])
    assert b["edge_mask"].sum() == e_real and b["node_mask"].sum() == n_real
    assert b["positions"].shape == (512, 3) and b["senders"].shape == (512,)


def test_build_cell_builds_the_molecule_cell():
    b = steps.build_cell(ARCH, "molecule", device="cpu")
    assert b.name == "nequip:molecule"
    params, state, batch = b.args
    assert batch["senders"].shape == (8192,) and batch["graph_ids"].shape == (4096,)
    assert b.model_flops == 2.0 * 8192 * 11 * 9 * 32 * 5


def test_gnn_sizes_pad_as_the_reference():
    for name, shape in registry.shapes_for(ARCH).items():
        n, e, g = steps.gnn_sizes(shape)
        assert n % 512 == 0 and e % 512 == 0, name
    ogb = registry.shapes_for(ARCH)["ogb_products"]
    assert steps.gnn_sizes(ogb) == (2449408, 61859328, 1)


# ---------------------------------------------------------------------------
# the sampler and the CSR form
# ---------------------------------------------------------------------------


def test_random_graph_is_the_references():
    for a, b in zip(sampler.random_graph(500, 3000, 4), j_sampler.random_graph(500, 3000, 4)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("fanouts", [(5, 3), (15, 10)])
def test_sample_subgraph_is_the_references_bit_for_bit(fanouts):
    sd, rc = j_sampler.random_graph(2000, 16000, 1)
    jg = j_sampler.CSRGraph.from_edge_index(sd, rc, 2000)
    tg = sampler.CSRGraph.from_edge_index(sd, rc, 2000)
    seeds = np.random.default_rng(9).choice(2000, 64, replace=False)
    a = j_sampler.sample_subgraph(jg, seeds, fanouts, 1500, 3000, np.random.default_rng(0))
    b = sampler.sample_subgraph(tg, seeds, fanouts, 1500, 3000, np.random.default_rng(0))
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype and np.array_equal(x, y), f.name
    assert b.seed_mask.sum() == 64 and b.edge_mask.sum() > 0


def test_csr_from_edge_index_is_the_numpy_form():
    sd, rc = j_sampler.random_graph(700, 9000, 2)
    want = j_sampler.CSRGraph.from_edge_index(sd, rc, 700)
    indptr, indices = sampler.csr_from_edge_index(torch.from_numpy(sd), torch.from_numpy(rc),
                                                  700)
    assert indptr.dtype == torch.int64 and indices.dtype == torch.int32
    assert np.array_equal(indptr.numpy(), want.indptr)
    assert np.array_equal(indices.numpy(), want.indices)
    host = sampler.to_host_csr(indptr, indices, 700)
    assert host.n_nodes == 700 and np.array_equal(host.indices, want.indices)


def test_random_graph_device_follows_the_degree_law():
    sd, rc = sampler.random_graph_device(5000, 200000, torch.Generator().manual_seed(0))
    assert sd.dtype == torch.int32 and rc.dtype == torch.int32
    assert int(sd.min()) >= 0 and int(sd.max()) < 5000 and int(rc.max()) < 5000
    js, jr = j_sampler.random_graph(5000, 200000, 0)
    # Pareto(2) + 1 senders are skewed like the reference's (the top 1% of
    # nodes send ~4-5% of the edges, against 1% for the uniform receivers)
    top = lambda x: np.sort(np.bincount(x, minlength=5000))[-50:].sum() / x.size  # noqa: E731
    assert abs(top(sd.numpy()) - top(js)) < 0.25 * top(js)
    assert top(sd.numpy()) > 3 * top(rc.numpy())
    assert abs(top(rc.numpy()) - top(jr)) < 0.25 * top(jr)


def test_gnn_sample_pads_one_subgraph():
    shape = GraphShape("mb_small", "minibatch", n_nodes=3000, n_edges=30000, batch_nodes=64,
                       fanout=(15, 10))
    sd, rc = steps.gnn_graph(shape, seed=0, device="cpu")
    sub = steps.gnn_sample(shape, sd, rc, seed=1)
    assert sub.senders.shape == (steps.MINIBATCH_PAD,) and sub.seed_mask.sum() == 64
    ne = int(sub.edge_mask.sum())
    assert 0 < ne <= 64 * 15 + 64 * 15 * 10
    assert int(sub.senders[:ne].max()) < int(sub.node_mask.sum())


# ---------------------------------------------------------------------------
# the gather and the segment sum
# ---------------------------------------------------------------------------


def _segment_data(seed, m=300, dim=7, n=40, integer=False):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n, m).astype(np.int32)
    ids[: m // 3] = 5                                          # a heavy row
    data = (rng.integers(-4, 5, (m, dim)) if integer else rng.standard_normal((m, dim)))
    return torch.from_numpy(data.astype(np.float32)), torch.from_numpy(ids), n


@pytest.mark.parametrize("integer", [False, True])
def test_segment_sum_plain_against_the_kernels_emulated_order(integer):
    data, ids, n = _segment_data(0, integer=integer)
    got = segment_sum(data, ids, n)
    want = bag_ref.embedding_bag_backward_emulated(data, ids[:, None], n)
    if integer:
        assert torch.equal(got, want)
    else:
        _close(got, want, 1e-6)
    assert torch.equal(got[~torch.isin(torch.arange(n), ids.long())], torch.zeros(1, 7).expand(
        n - len(set(ids.tolist())), 7))


def test_segment_sum_and_gather_match_jax_with_gradients():
    data, ids, n = _segment_data(1)
    want = jax.ops.segment_sum(jnp.asarray(data.numpy()), jnp.asarray(ids.numpy()),
                               num_segments=n)
    d = data.clone().requires_grad_()
    got = segment_sum(d, ids, n)
    _close(got, want, 1e-6)
    g = torch.from_numpy(np.random.default_rng(2).standard_normal((n, 7)).astype(np.float32))
    (dd,) = torch.autograd.grad(got, d, g)
    assert torch.equal(dd, g[ids.long()])
    table = torch.from_numpy(np.random.default_rng(3).standard_normal((n, 7)).astype(
        np.float32)).requires_grad_()
    rows = gather_rows(table, ids)
    assert torch.equal(rows, table.detach()[ids.long()])
    (dt,) = torch.autograd.grad(rows, table, data)
    _close(dt, want, 1e-6)
