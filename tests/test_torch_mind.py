"""The port's MIND (``models/recsys/mind.py``, its config,
``convert.mind_params`` and its ``launch/steps.py`` serve, retrieval and
train steps), on the CPU, against the JAX package run live.

Two sizes (``tests/_torch_recsys.py``): ``smoke_config`` and the published
config at full width (embed_dim 64, seq_len 50, 4 interests, 3 routing
iterations) with ``n_items`` cut to 2,048, at B = 8.  Weights are drawn by
the JAX package (``init_mind(PRNGKey(0), cfg)``) and carried across by
``convert``.  Bars: interest vectors and scores within 1e-5 of the largest
|value|; the loss within rtol 1e-5, every gradient leaf within 1e-4 of
that leaf's largest |value|; ``retrieve``'s ids equal to the reference's
under the tie-aware comparator (``testing.topk_report``, which re-reads
every id in the score field) where whole tiles cover the table, and equal
to an index-stable top-k of ``score_all_items`` everywhere.

``test_retrieve_drops_the_tail_in_the_reference_only`` shows the
reference's truncation: its ``retrieve`` scans ``n_rows // item_tile``
whole tiles, so an item past the last one never wins.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # one intra-op thread: the suite runs a process a core
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import mind as j_mind_cfg, registry as j_registry  # noqa: E402
from repro.configs.shapes import RECSYS_SHAPES as J_SHAPES  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.models.recsys import mind as j_mind  # noqa: E402
from repro.training import optimizer as j_opt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import mind as mind_cfg, registry  # noqa: E402
from repro_torch.configs.shapes import RECSYS_SHAPES  # noqa: E402
from repro_torch.kernels.approx_topk.select import stable_topk  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models.recsys import mind  # noqa: E402
from repro_torch.testing import assert_topk_agree  # noqa: E402
from repro_torch.tree import leaves, leaves_with_paths  # noqa: E402
from _torch_recsys import (  # noqa: E402
    SIZES, chunked, close, config, cut_shapes, grads_close, history, items, jcfg, jmesh,
    leaves_carried, model, np_tree, rel_close, smoke_registry,
)

B = 8
K = 20


def _tiles(cfg):
    """(whole, partial) item tiles: the first divides the padded table, the
    second leaves a partial last tile."""
    rows = -(-cfg.n_items // 512) * 512
    return rows // 4, rows * 3 // 8


@pytest.fixture(scope="module", params=SIZES)
def m(request):
    out = model("mind", request.param)
    cfg, jc = out["cfg"], out["jcfg"]
    h = history(cfg, B, 3)
    t = items(cfg, (B,), 4)
    neg = items(cfg, (B, steps.MIND_NEGATIVES), 5)
    whole, partial = _tiles(cfg)

    def ref(p):
        loss = lambda q: j_mind.sampled_softmax_loss(q, h, t, neg, jc)     # noqa: E731
        return dict(v=j_mind.interest_vectors(p, h, jc), s=j_mind.score_all_items(p, h, jc),
                    whole=j_mind.retrieve(p, h, K, jc, item_tile=whole),
                    partial=j_mind.retrieve(p, h, K, jc, item_tile=partial),
                    loss_grad=jax.value_and_grad(loss)(p))

    out.update(h=h, t=t, neg=neg, whole=whole, partial=partial,
               ref=jax.tree.map(np.asarray, jax.jit(ref)(out["jparams"])))
    return out


def test_configs_are_copies():
    assert dataclasses.asdict(mind_cfg.CONFIG) == dataclasses.asdict(j_mind_cfg.CONFIG)
    entry, j_entry = registry.get("mind"), j_registry.get("mind")
    assert (entry.family, entry.adacur_applicable, entry.notes) == (
        j_entry.family, j_entry.adacur_applicable, j_entry.notes)
    assert dataclasses.asdict(entry.config) == dataclasses.asdict(j_entry.config)
    assert (dataclasses.asdict(registry.smoke_config("mind"))
            == dataclasses.asdict(j_registry.smoke_config("mind")))


def test_convert_carries_every_leaf(m):
    own = mind.init_mind(m["cfg"], torch.Generator().manual_seed(0), "cpu")
    leaves_carried(m["params"], m["tree"], own)


def test_interest_vectors_match(m):
    got = mind.interest_vectors(m["params"], torch.from_numpy(m["h"]), m["cfg"])
    assert got.shape == (B, m["cfg"].n_interests, m["cfg"].embed_dim)
    close(got, m["ref"]["v"])


def test_score_all_items_match(m):
    n = m["cfg"].n_items
    got = mind.score_all_items(m["params"], torch.from_numpy(m["h"]), m["cfg"])
    want = m["ref"]["s"]
    assert got.shape == want.shape
    assert np.array_equal(got[:, n:].numpy(), want[:, n:])          # pad rows at -1e30
    close(got[:, :n], want[:, :n])


def test_retrieve_matches_the_reference_on_whole_tiles(m):
    h = torch.from_numpy(m["h"])
    vals, ids = mind.retrieve(m["params"], h, K, m["cfg"], item_tile=m["whole"])
    jv, ji = m["ref"]["whole"]
    assert ids.dtype == torch.int32 and ids.shape == (B, K)
    assert_topk_agree(ids, vals, ji, jv, mind.score_all_items(m["params"], h, m["cfg"]))


def test_retrieve_covers_every_row(m):
    """A partial last tile: the port's ids are an index-stable top-k of
    ``score_all_items`` (bitwise the same values) and agree with the
    reference's own ``score_all_items`` ranked by ``lax.top_k``."""
    h = torch.from_numpy(m["h"])
    vals, ids = mind.retrieve(m["params"], h, K, m["cfg"], item_tile=m["partial"])
    scores = mind.score_all_items(m["params"], h, m["cfg"])
    sv, si = stable_topk(scores, K)
    assert torch.equal(ids, si) and torch.equal(vals, sv)
    jv, ji = jax.lax.top_k(jnp.asarray(m["ref"]["s"]), K)
    assert_topk_agree(ids, vals, np.asarray(ji), np.asarray(jv), scores)


@pytest.mark.parametrize("ties", ["none", "at_the_boundary"])
def test_retrieve_breaks_ties_by_the_lower_id(ties):
    """A tile's ``torch.topk`` may cut a tie at its k-th value anyhow:
    ``_sweep`` flags such rows ``loose`` and ``retrieve`` sweeps them again
    with the composite keys.  201 equal rows (ids 499-699), the best match
    of history 0, straddle the first two tiles of 384: its top-20 is ids
    499-518, as an index-stable top-k of ``score_all_items``."""
    cfg = registry.smoke_config("mind")
    params = mind.init_mind(cfg, torch.Generator().manual_seed(0), "cpu")
    h = torch.from_numpy(history(cfg, 4, 8))
    h[(h >= 499) & (h < 700)] = 1
    if ties != "none":
        v = mind.interest_vectors(params, h[:1], cfg)[0, 0]
        params["item_emb"][499:700] = v / v.norm() * 1e3
    v = mind.interest_vectors(params, h, cfg)
    _, _, loose = mind._sweep(v, params["item_emb"], 20, cfg.n_items, 384, exact=False)
    assert bool(loose[0]) == (ties != "none") and (ties != "none" or not loose.any())
    vals, ids = mind.retrieve(params, h, 20, cfg, item_tile=384)
    sv, si = stable_topk(mind.score_all_items(params, h, cfg), 20)
    assert torch.equal(ids, si) and torch.equal(vals, sv)
    if ties != "none":
        assert ids[0].tolist() == list(range(499, 519))


def test_retrieve_drops_the_tail_in_the_reference_only():
    """Item 900 made the best match of every history (its row set along the
    first history's first interest, scaled up); with tiles of 384 over the
    smoke table's 1,024 rows, the reference scans 2 whole tiles (rows
    0-767) and never returns it, the port ranks it first.  At the
    published size the reference's 61 tiles of 16,384 cover 999,424 of
    1,000,448 rows: items 999,424-999,999 can never be retrieved there."""
    mm = model("mind", "smoke")
    cfg = mm["cfg"]
    h = history(cfg, 4, 7)
    h[h == 900] = 1
    v = mind.interest_vectors(mm["params"], torch.from_numpy(h), cfg)[0, 0]
    tree = dict(mm["tree"], item_emb=mm["tree"]["item_emb"].copy())
    tree["item_emb"][900] = (v / v.norm() * 1e3).numpy()
    params = convert.mind_params(tree, device="cpu")
    ht = torch.from_numpy(h)
    _, ids = mind.retrieve(params, ht, K, cfg, item_tile=384)
    _, jids = j_mind.retrieve(jax.tree.map(jnp.asarray, tree), jnp.asarray(h), K, mm["jcfg"],
                              item_tile=384)
    assert int(ids[0, 0]) == 900 and int(stable_topk(
        mind.score_all_items(params, ht, cfg), 1)[1][0, 0]) == 900
    assert 900 not in np.asarray(jids) and np.asarray(jids).max() < 768
    full = registry.get("mind").config
    rows = -(-full.n_items // 512) * 512
    assert rows == 1_000_448 and rows // mind.ITEM_TILE * mind.ITEM_TILE == 999_424


def test_loss_and_gradient_match(m):
    params = steps.require_grad(m["params"])
    try:
        loss = mind.sampled_softmax_loss(params, torch.from_numpy(m["h"]),
                                         torch.from_numpy(m["t"]), torch.from_numpy(m["neg"]),
                                         m["cfg"])
        loss.backward()
        jl, jg = m["ref"]["loss_grad"]
        rel_close(loss.detach(), jl)
        grads_close(params, jg)
    finally:
        for p in leaves(params):
            p.grad = None
            p.requires_grad_(False)


def _shape(name, **kw):
    return (dataclasses.replace(RECSYS_SHAPES[name], **kw),
            dataclasses.replace(J_SHAPES[name], **kw))


def test_serve_and_retrieval_builders_match(m, monkeypatch):
    """``build_recsys_serve`` (``retrieve(history, 100)``, whole and in
    chunks of 3 rows) against the reference's serve step (its shard_map
    over a 1 x 1 mesh), and ``build_recsys_retrieval``'s native retrieval
    at B = 1 against the reference's, on the port's seeded batches."""
    cfg, jc = m["cfg"], m["jcfg"]
    shape, jshape = _shape("serve_p99", batch=B)
    jb = j_steps.build_recsys_serve("mind", jc, jshape, jmesh())
    for rows in (None, 3):
        if rows:
            chunked(monkeypatch, rows)
        bundle = steps.build_recsys_serve("mind", cfg, shape, params=m["params"],
                                          device="cpu")
        assert bundle.name == jb.name and bundle.model_flops == jb.model_flops
        params, batch = bundle.args
        assert set(batch) == {"history"}
        vals, ids = bundle.step(params, batch)
        if rows is None:
            with jax.set_mesh(jmesh()):
                jv, ji = jax.jit(jb.step)(m["jparams"], {"history": jnp.asarray(
                    batch["history"].numpy())})
        assert ids.shape == (B, 100)
        assert_topk_agree(ids, vals, np.asarray(ji), np.asarray(jv),
                          mind.score_all_items(params, batch["history"], cfg))
    shape, jshape = _shape("retrieval_cand")
    rb = steps.build_recsys_retrieval("mind", cfg, shape, params=m["params"], device="cpu")
    jrb = j_steps.build_recsys_retrieval("mind", jc, jshape, jmesh())
    assert rb.name == jrb.name and rb.model_flops == jrb.model_flops
    params, batch = rb.args
    vals, ids = rb.step(params, batch)
    jv, ji = jax.jit(jrb.step)(m["jparams"], {"history": jnp.asarray(batch["history"].numpy())})
    assert ids.shape == (1, 100)
    assert_topk_agree(ids, vals, np.asarray(ji), np.asarray(jv),
                      mind.score_all_items(params, batch["history"], cfg))


@pytest.mark.parametrize("size", SIZES)
def test_flops_equal_the_reference(size):
    cfg = config("mind", size)
    for b in (1, 512, 65536):
        assert steps.recsys_flops(cfg, b) == j_steps._recsys_flops(jcfg(cfg), b)


def test_train_steps_match_the_reference():
    """Two steps of the reference's ``build_recsys_train`` (jitted on a 1 x 1
    mesh) and the port's from the same weights and batch (``neg_ids`` (B,
    64)), at smoke size: losses within rtol 1e-5, the weights after within
    1e-5 of each leaf's largest |value|, and the loss falls."""
    mm = model("mind", "smoke")
    shape, jshape = _shape("train_batch", batch=B)
    tb = steps.build_recsys_train("mind", mm["cfg"], shape, params=mm["params"], device="cpu")
    jb = j_steps.build_recsys_train("mind", mm["jcfg"], jshape, jmesh())
    assert tb.model_flops == jb.model_flops
    params, state, batch = tb.args
    assert set(batch) == {"history", "target", "neg_ids"}
    assert batch["neg_ids"].shape == (B, 64)
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


def test_build_cell_serves_every_shape(monkeypatch):
    cut_shapes(monkeypatch)
    cfg = smoke_registry(monkeypatch, "mind")
    params = steps.recsys_init(cfg, device="cpu")
    for name in RECSYS_SHAPES:
        b = steps.build_cell("mind", name, params=params, device="cpu")
        assert b.name == f"mind:{name}" and b.model_flops > 0
    for p in leaves(params):
        p.requires_grad_(False)


def test_unknown_kind_raises_key_error():
    cfg = dataclasses.replace(registry.smoke_config("mind"), kind="gru4rec")
    for call in (lambda: steps.recsys_init(cfg, device="cpu"),
                 lambda: steps.recsys_inputs(cfg, 2, device="cpu"),
                 lambda: steps.recsys_flops(cfg, 2),
                 lambda: steps.score_fn(cfg)):
        with pytest.raises(KeyError, match="gru4rec"):
            call()
    with pytest.raises(ValueError, match="cross-encoder"):
        steps.score_fn(registry.smoke_config("mind"))
