"""The port's BST and BERT4Rec (``models/recsys/{bst,bert4rec}.py``, their
configs, ``convert.bst_params`` / ``bert4rec_params`` and their
``launch/steps.py`` serve, retrieval and train steps), on the CPU, against
the JAX package run live.

Two sizes (``tests/_torch_recsys.py``): ``smoke_config``, and the
published config at full width (embed_dim, seq_len, heads, blocks,
mlp_dims) with ``n_items`` cut to 2,048, at B = 8.  Weights are drawn by
the JAX package (``init_*(PRNGKey(0), cfg)``) and carried across by
``convert``; inputs are drawn with numpy (or by the port's seeded
builders) and handed to both.  The reference's functions of one model run
in one jitted call a module (its per-op eager dispatch costs seconds a
call on the CPU).  Bars:

- logits and scores within 1e-5 of the largest |value|;
- losses within rtol 1e-5, every gradient leaf within 1e-4 of that
  leaf's largest |value|;
- BERT4Rec's negatives bitwise (``prng.randint`` is JAX's ``randint``);
- the retrieval steps' top-100 against the reference's step (same R_anc,
  same key) at overlap >= 0.99, with 500 CE calls a context;
- ``model_flops`` equal; ``convert`` carrying every leaf.

R_anc here is a seeded standard normal: the port's ``anchor_scores``
(500 anchor histories x the catalogue, ~20 s of CPU softmax at smoke
size) is held to the reference's scores on three anchor rows, and built
whole at a cut ``K_Q`` by ``build_cell``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # one intra-op thread: the suite runs a process a core
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as j_registry  # noqa: E402
from repro.configs.shapes import RECSYS_SHAPES as J_SHAPES  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.models.recsys import bert4rec as j_bert4rec, bst as j_bst  # noqa: E402
from repro.training import optimizer as j_opt  # noqa: E402
from repro_torch.configs import bert4rec as bert4rec_cfg, bst as bst_cfg, registry  # noqa: E402
from repro_torch.configs.shapes import RECSYS_SHAPES  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models.recsys import bert4rec, bst  # noqa: E402
from repro_torch.testing import topk_overlap  # noqa: E402
from repro_torch.tree import leaves, leaves_with_paths  # noqa: E402
from _torch_recsys import (  # noqa: E402
    SIZES, chunked, close, config, cut_shapes, grads_close, history, items, jcfg, jmesh,
    leaves_carried, model, np_tree, rel_close, smoke_registry,
)

ARCHS = ("bst", "bert4rec")
B = 8
MODULES = {"bst": (bst, j_bst), "bert4rec": (bert4rec, j_bert4rec)}


def _reference(arch, jc):
    """One jitted call of the reference: the serve function, candidate
    scores, BERT4Rec's ``user_logits`` and the loss with its gradient."""
    jmod = MODULES[arch][1]

    def fn(p, h, t, cand, labels):
        if arch == "bst":
            serve = jmod.forward(p, h, t, jc)
            loss = lambda q: jmod.bce_loss(q, h, t, labels, jc)        # noqa: E731
            user = None
        else:
            serve = jmod.score_candidates(p, h, t[:, None], jc)[:, 0]
            loss = lambda q: jmod.mlm_loss(q, h, t, jc)                 # noqa: E731
            user = jmod.user_logits(p, h, jc)
        return dict(serve=serve, score=jmod.score_candidates(p, h[:4], cand, jc),
                    user=user, loss_grad=jax.value_and_grad(loss)(p))

    return jax.jit(fn)


@pytest.fixture(scope="module", params=[(a, s) for a in ARCHS for s in SIZES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def m(request):
    out = model(*request.param)
    cfg = out["cfg"]
    h, t = history(cfg, B, 3), items(cfg, (B,), 4)
    cand = items(cfg, (4, 6), 6)
    cand[0, :2] = [0, cfg.n_items - 1]
    labels = (np.arange(B) % 2).astype(np.float32)
    ref = _reference(out["arch"], out["jcfg"])(out["jparams"], h, t, cand, labels)
    out.update(h=h, t=t, cand=cand, labels=labels, ref=jax.tree.map(
        lambda x: x if x is None else np.asarray(x), ref))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_copies(arch):
    from repro.configs import bert4rec as j_b4, bst as j_b

    port, ref = {"bst": (bst_cfg, j_b), "bert4rec": (bert4rec_cfg, j_b4)}[arch]
    assert dataclasses.asdict(port.CONFIG) == dataclasses.asdict(ref.CONFIG)
    entry, j_entry = registry.get(arch), j_registry.get(arch)
    assert (entry.family, entry.adacur_applicable, entry.notes) == (
        j_entry.family, j_entry.adacur_applicable, j_entry.notes)
    assert dataclasses.asdict(entry.config) == dataclasses.asdict(j_entry.config)
    assert (dataclasses.asdict(registry.smoke_config(arch))
            == dataclasses.asdict(j_registry.smoke_config(arch)))
    assert registry.shapes_for(arch).keys() == j_registry.shapes_for(arch).keys()


def test_convert_carries_every_leaf(m):
    init = {"bst": bst.init_bst, "bert4rec": bert4rec.init_bert4rec}[m["arch"]]
    own = init(m["cfg"], torch.Generator().manual_seed(0), "cpu")
    leaves_carried(m["params"], m["tree"], own)
    assert isinstance(m["params"]["blocks"], list)
    assert len(m["params"]["blocks"]) == m["cfg"].n_blocks


def test_serve_builder_matches(m, monkeypatch):
    """``build_recsys_serve``'s step (BST's logit of (history, target);
    BERT4Rec's joint score of the target in the [MASK] slot), whole (the
    CPU's default) and in chunks of 3 rows, on the reference's inputs."""
    shape = dataclasses.replace(RECSYS_SHAPES["serve_p99"], batch=B)
    jb = j_steps.build_recsys_serve(m["arch"], m["jcfg"],
                                    dataclasses.replace(J_SHAPES["serve_p99"], batch=B), jmesh())
    batch = {"history": torch.from_numpy(m["h"]), "target": torch.from_numpy(m["t"])}
    assert steps.serve_chunk_rows(m["cfg"], "cpu") is None
    for rows in (None, 3):
        if rows:
            chunked(monkeypatch, rows)
        bundle = steps.build_recsys_serve(m["arch"], m["cfg"], shape, params=m["params"],
                                          device="cpu")
        assert bundle.name == jb.name and bundle.model_flops == jb.model_flops
        assert set(bundle.args[1]) == {"history", "target"}
        assert bundle.args[1]["history"].dtype == torch.int32
        got = bundle.step(m["params"], batch)
        assert got.shape == (B,)
        close(got, m["ref"]["serve"])


def test_score_candidates_match(m):
    mod = MODULES[m["arch"]][0]
    got = mod.score_candidates(m["params"], torch.from_numpy(m["h"][:4]),
                               torch.from_numpy(m["cand"]), m["cfg"])
    assert got.shape == (4, 6)
    close(got, m["ref"]["score"])


def test_bert4rec_user_logits_match(m):
    if m["arch"] != "bert4rec":
        assert m["ref"]["user"] is None
        return
    got = bert4rec.user_logits(m["params"], torch.from_numpy(m["h"]), m["cfg"])
    want, n = m["ref"]["user"], m["cfg"].n_items
    assert got.shape == want.shape
    assert np.array_equal(got[:, n:].numpy(), want[:, n:])          # pad rows at -1e30
    close(got[:, :n], want[:, :n])


def test_loss_and_gradient_match(m):
    """BST's BCE, BERT4Rec's sampled-softmax MLM loss (its negatives drawn
    inside from ``PRNGKey(0)`` in both packages)."""
    cfg = m["cfg"]
    h, t = torch.from_numpy(m["h"]), torch.from_numpy(m["t"])
    params = steps.require_grad(m["params"])
    try:
        if m["arch"] == "bst":
            loss = bst.bce_loss(params, h, t, torch.from_numpy(m["labels"]), cfg)
        else:
            loss = bert4rec.mlm_loss(params, h, t, cfg)
        loss.backward()
        jl, jg = m["ref"]["loss_grad"]
        rel_close(loss.detach(), jl)
        grads_close(params, jg)
    finally:
        for p in leaves(params):
            p.grad = None
            p.requires_grad_(False)


@pytest.mark.parametrize("b", [3, 64])
def test_bert4rec_negatives_are_bitwise(b):
    cfg = registry.get("bert4rec").config
    got = bert4rec.negatives(b, cfg, device="cpu")
    want = jax.random.randint(jax.random.PRNGKey(0), (b, bert4rec.N_NEG), 0, cfg.n_items)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("size", SIZES)
def test_bert4rec_microbatched_step_keeps_the_reference_loss(size):
    """The train batch draws the negatives once for the whole batch and a
    microbatched step slices them, so two microbatches give the
    reference's full-batch loss.  A (B/2, 512) draw a microbatch instead
    repeats the first rows' negatives in each: another loss, ten times
    the bar away."""
    mm = model("bert4rec", size)
    cfg = mm["cfg"]
    h, t = history(cfg, B, 3), items(cfg, (B,), 4)
    want = float(jax.jit(lambda p: j_bert4rec.mlm_loss(p, h, t, mm["jcfg"]))(mm["jparams"]))
    shape = dataclasses.replace(RECSYS_SHAPES["train_batch"], batch=B)
    bundle = steps.build_recsys_train("bert4rec", cfg, shape, params=mm["params"],
                                      n_micro=2, device="cpu")
    params, state, batch = bundle.args
    neg = bert4rec.negatives(B, cfg, device="cpu")
    assert torch.equal(batch["neg"], neg)
    half = bert4rec.negatives(B // 2, cfg, device="cpu")
    hh, tt = torch.from_numpy(h), torch.from_numpy(t)
    with torch.no_grad():
        per_micro = np.mean([float(bert4rec.mlm_loss(params, hh[s], tt[s], cfg, neg=half))
                             for s in (slice(0, B // 2), slice(B // 2, B))])
    _, _, met = bundle.step(params, state, {"history": hh, "target": tt, "neg": neg})
    rel_close(met["loss"], want)
    assert abs(per_micro - want) > 10 * 1e-5 * abs(want)   # well past the loss bar


def test_anchor_scores_are_the_models_scores(m):
    """``anchor_scores``: each anchor history's exact scores against items
    0..N-1, the padded columns 0."""
    n = 64
    anchors = {"history": torch.from_numpy(m["h"][:3])}
    r = steps.anchor_scores(m["params"], m["cfg"], anchors, n)
    assert r.shape == (3, -(-n // 512) * 512) and not r[:, n:].any()
    jmod = MODULES[m["arch"]][1]
    cand = np.broadcast_to(np.arange(n, dtype=np.int32), (3, n))
    close(r[:, :n], jax.jit(lambda p: jmod.score_candidates(p, m["h"][:3], cand, m["jcfg"]))(
        m["jparams"]))


def test_retrieval_builder_matches(m):
    cfg = m["cfg"]
    n = cfg.n_items
    shape = dataclasses.replace(RECSYS_SHAPES["retrieval_cand"], n_candidates=n)
    r_anc = torch.randn((steps.K_Q, -(-n // 512) * 512), generator=torch.Generator()
                        .manual_seed(11))
    r_anc[:, n:] = 0.0
    bundle = steps.build_recsys_retrieval(m["arch"], cfg, shape, params=m["params"],
                                          r_anc=r_anc, device="cpu")
    jb = j_steps.build_recsys_retrieval(
        m["arch"], m["jcfg"], dataclasses.replace(J_SHAPES["retrieval_cand"], n_candidates=n),
        jmesh())
    assert bundle.name == jb.name and bundle.model_flops == jb.model_flops
    params, batch, key = bundle.args
    assert set(batch) == {"history", "r_anc"} and batch["r_anc"] is r_anc
    idx, scores = bundle.step(params, batch, key)
    assert bundle.stats.ce_calls == 500 and idx.shape == (1, 100)
    assert (idx < n).all() and len(set(idx[0].tolist())) == 100
    jidx, jscores = jax.jit(jb.step)(m["jparams"],
                                     {k: jnp.asarray(v.numpy()) for k, v in batch.items()},
                                     jnp.asarray(key.numpy().astype(np.uint32)))
    assert topk_overlap(np.asarray(jidx), idx) >= 0.99
    close(scores[0, :10], np.asarray(jscores)[0, :10])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", SIZES)
def test_flops_equal_the_reference(arch, size):
    cfg = config(arch, size)
    for b in (1, 512, 65536):
        assert steps.recsys_flops(cfg, b) == j_steps._recsys_flops(jcfg(cfg), b)


def test_bst_flops_formula_overstates_its_forward():
    """The reference's formula counts BST's FFN at ``mlp_dims[0]`` = 1,024
    wide over L = 20 positions; the model's FFN is 4d = 128 wide over 21.
    Kept for parity: 5.5 against 3.3 MFLOP a row, ~1.7x."""
    cfg = registry.get("bst").config
    d, pos = cfg.embed_dim, cfg.seq_len + 1
    widths = (d * pos,) + tuple(cfg.mlp_dims) + (1,)
    true = 2.0 * (4 * pos * d * d + 2 * pos * pos * d + 2 * pos * d * 4 * d
                  + sum(a * b for a, b in zip(widths[:-1], widths[1:])))
    assert 5.4e6 < steps.recsys_flops(cfg, 1) < 5.6e6 and 3.2e6 < true < 3.4e6
    assert 1.6 < steps.recsys_flops(cfg, 1) / true < 1.8


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_the_reference(arch):
    """Two steps of the reference's ``build_recsys_train`` (jitted on a 1 x 1
    mesh) and the port's from the same weights and batch, at smoke size:
    losses within rtol 1e-5, the weights after within 1e-5 of each leaf's
    largest |value|, and the loss falls."""
    mm = model(arch, "smoke")
    shape = dataclasses.replace(RECSYS_SHAPES["train_batch"], batch=B)
    tb = steps.build_recsys_train(arch, mm["cfg"], shape, params=mm["params"], device="cpu")
    jb = j_steps.build_recsys_train(arch, mm["jcfg"],
                                    dataclasses.replace(J_SHAPES["train_batch"], batch=B),
                                    jmesh())
    assert tb.model_flops == jb.model_flops
    params, state, batch = tb.args
    assert set(batch) == ({"history", "target", "labels"} if arch == "bst"
                          else {"history", "target", "neg"})
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jp, js, jl = mm["jparams"], j_opt.init_adamw(mm["jparams"]), []
    with jax.set_mesh(jmesh()):
        fn = jax.jit(jb.step)
        for _ in range(2):
            jp, js, met = fn(jp, js, jbatch)
            jl.append(float(met["loss"]))
    tl = []
    for _ in range(2):
        params, state, met = tb.step(params, state, batch)
        tl.append(float(met["loss"]))
    for a, b in zip(tl, jl):
        rel_close(a, b)
    assert tl[1] < tl[0]
    want = dict(leaves_with_paths(np_tree(jp)))
    for path, p in leaves_with_paths(params):
        w = want[path]
        assert np.abs(p.detach().numpy() - w).max() <= 1e-5 * np.abs(w).max(), path


@pytest.mark.parametrize("arch", ARCHS)
def test_build_cell_serves_every_shape(arch, monkeypatch):
    """``build_cell`` at ``smoke_config`` for every recsys shape kind, the
    retrieval cell's R_anc built by ``anchor_scores`` over the smoke
    catalogue (``cut_shapes``)."""
    cut_shapes(monkeypatch)
    cfg = smoke_registry(monkeypatch, arch)
    params = steps.recsys_init(cfg, device="cpu")
    for name, shape in registry.shapes_for(arch).items():
        b = steps.build_cell(arch, name, params=params, device="cpu")
        assert b.name == f"{arch}:{name}" and b.model_flops > 0
        if shape.kind == "retrieval":
            r_anc = b.args[1]["r_anc"]
            assert r_anc.shape == (16, 1024) and bool(r_anc[:, :1000].ne(0).all())
        if shape.kind == "serve":
            assert b.args[1]["history"].shape == (shape.batch, cfg.seq_len)
    for p in leaves(params):
        p.requires_grad_(False)
