"""The port's recsys slice (plain versions, on the CPU) against the JAX
package run live: ``models/recsys/embedding.py``, ``dlrm.forward`` and
``score_candidates``, and the ``launch/steps.py`` builders they serve.

Weights are drawn by the JAX package (``init_dlrm(PRNGKey(0), cfg)``, as
``steps.py::_recsys_init`` does) and carried across by
``convert.dlrm_params``; contexts are drawn with numpy (or by the port's
seeded ``recsys_inputs``) and handed to both.  Bars:

- gathers (``lookup_all_tables``, ``multihot_bag`` max) bitwise: both
  copy the same fp32 rows;
- reductions (bag sum/mean, the segment bag) fp32 ``atol = rtol = 1e-5``;
- DLRM logits and candidate scores fp32 within 1e-5 of the largest
  |value| (matrix products summed in another order);
- the retrieval step's top-100 ids: overlap >= 0.99, the engine tests' bar.
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
from repro.models.recsys import dlrm as j_dlrm, embedding as j_emb  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import dlrm_mlperf, registry  # noqa: E402
from repro_torch.configs.base import RecSysConfig, replace  # noqa: E402
from repro_torch.configs.shapes import RECSYS_SHAPES  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models.recsys import dlrm, embedding  # noqa: E402
from repro_torch.testing import topk_overlap  # noqa: E402

ARCH = "dlrm-mlperf"


def _configs():
    smoke = registry.smoke_config(ARCH)
    full = dlrm_mlperf.capped(max_rows=512)
    return {"smoke": smoke, "full_width": full}


def _jcfg(cfg):
    from repro.configs.base import RecSysConfig as JRecSysConfig

    return JRecSysConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module", params=["smoke", "full_width"])
def model(request):
    cfg = _configs()[request.param]
    jcfg = _jcfg(cfg)
    jparams, _ = j_dlrm.init_dlrm(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return dict(cfg=cfg, jcfg=jcfg, jparams=jparams,
                params=convert.dlrm_params(tree, device="cpu"))


def _contexts(cfg, b, seed):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((b, cfg.n_dense)).astype(np.float32)
    sparse = rng.integers(0, 2 ** 31, (b, cfg.n_sparse)).astype(np.int32)
    return dense, sparse


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def test_configs_are_copies():
    from repro.configs import dlrm_mlperf as j_mlperf

    assert dataclasses.asdict(dlrm_mlperf.CONFIG) == dataclasses.asdict(j_mlperf.CONFIG)
    assert (dataclasses.asdict(registry.smoke_config(ARCH))
            == dataclasses.asdict(j_registry.smoke_config(ARCH)))
    assert {k: dataclasses.asdict(v) for k, v in RECSYS_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    assert sum(dlrm_mlperf.CRITEO_TABLE_SIZES) == 187_767_399
    capped = dlrm_mlperf.capped()
    assert [i for i, (a, b) in enumerate(zip(dlrm_mlperf.CRITEO_TABLE_SIZES,
                                             capped.table_sizes)) if a != b] == [0, 9, 19, 20, 21]
    assert sum(embedding.padded_rows(s) for s in capped.table_sizes) == 87_956_992


@pytest.mark.parametrize("n", [2, 5, 27])
def test_triu_order_is_row_major_as_in_jnp(n):
    iu, ju = torch.triu_indices(n, n, offset=1)
    jiu, jju = jnp.triu_indices(n, k=1)
    assert np.array_equal(iu.numpy(), np.asarray(jiu))
    assert np.array_equal(ju.numpy(), np.asarray(jju))


def test_lookup_all_tables_is_bitwise(model):
    _, sparse = _contexts(model["cfg"], 64, 0)
    sparse[0, :] = -5                     # floor-mod, as jnp's % takes it
    sparse[1, :] = 2 ** 31 - 1
    want = j_emb.lookup_all_tables(model["jparams"]["tables"], jnp.asarray(sparse))
    got = embedding.lookup_all_tables(model["params"]["tables"], torch.from_numpy(sparse))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_multihot_bag_matches(mode):
    rng = np.random.default_rng(1)
    table = rng.standard_normal((300, 32)).astype(np.float32)
    ids = rng.integers(0, 300, (40, 6)).astype(np.int32)
    want = np.asarray(j_emb.multihot_bag(jnp.asarray(table), jnp.asarray(ids), mode))
    got = embedding.multihot_bag(torch.from_numpy(table), torch.from_numpy(ids), mode).numpy()
    if mode == "max":
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_segment_embedding_bag_matches(mode, weighted):
    rng = np.random.default_rng(2)
    table = rng.standard_normal((200, 16)).astype(np.float32)
    idx = rng.integers(0, 200, 90).astype(np.int32)
    seg = rng.integers(0, 12, 90).astype(np.int32)      # unsorted; bag 12 empty
    w = rng.random(90).astype(np.float32) if weighted else None
    want = np.asarray(j_emb.embedding_bag(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(seg), 13, mode,
        None if w is None else jnp.asarray(w)))
    got = embedding.embedding_bag(
        torch.from_numpy(table), torch.from_numpy(idx), torch.from_numpy(seg), 13, mode,
        None if w is None else torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_init_tables_pads_and_scales():
    g = torch.Generator().manual_seed(0)
    tables = embedding.init_tables(g, (3, 512, 513), 64)
    assert [t.shape for t in tables] == [(512, 64), (512, 64), (1024, 64)]
    std = torch.cat(tables).std().item()
    assert abs(std - 1 / 8) < 0.01
    jt, _ = j_emb.init_tables(jax.random.PRNGKey(0), (3, 512, 513), 64)
    assert [t.shape for t in tables] == [tuple(t.shape) for t in jt]


def test_dlrm_forward_matches(model):
    cfg = model["cfg"]
    dense, sparse = _contexts(cfg, 64, 3)
    want = j_dlrm.forward(model["jparams"], jnp.asarray(dense), jnp.asarray(sparse),
                          model["jcfg"])
    got = dlrm.forward(model["params"], torch.from_numpy(dense), torch.from_numpy(sparse), cfg)
    assert got.shape == (64,)
    _close(got, want)


def test_score_candidates_matches(model):
    cfg = model["cfg"]
    dense, sparse = _contexts(cfg, 8, 4)
    cands = np.random.default_rng(5).integers(0, 10 ** 6, (8, 16)).astype(np.int32)
    want = j_dlrm.score_candidates(model["jparams"], jnp.asarray(dense), jnp.asarray(sparse),
                                   jnp.asarray(cands), model["jcfg"])
    s = torch.from_numpy(sparse)
    got = dlrm.score_candidates(model["params"], torch.from_numpy(dense), s,
                                torch.from_numpy(cands), cfg)
    assert got.shape == (8, 16)
    assert torch.equal(s, torch.from_numpy(sparse)), "the context's ids were written to"
    _close(got, want)


def test_init_dlrm_shapes_and_devices():
    cfg = registry.smoke_config(ARCH)
    params = dlrm.init_dlrm(cfg, torch.Generator().manual_seed(0), "cpu")
    jparams, _ = j_dlrm.init_dlrm(jax.random.PRNGKey(0), _jcfg(cfg))
    for part in ("bot", "top"):
        assert {k: tuple(v.shape) for k, v in params[part].items()} == {
            k: tuple(v.shape) for k, v in jparams[part].items()}
    assert [tuple(t.shape) for t in params["tables"]] == [
        tuple(t.shape) for t in jparams["tables"]]
    with pytest.raises(ValueError, match="dlrm"):
        dlrm.init_dlrm(replace(cfg, kind="bst"), torch.Generator(), "cpu")


def _jmesh():
    return jax.make_mesh((1, 1), ("data", "model"))


def test_serve_builder_matches(model):
    cfg = model["cfg"]
    shape = RECSYS_SHAPES["serve_p99"]
    bundle = steps.build_recsys_serve(ARCH, cfg, shape, params=model["params"], device="cpu")
    jb = j_steps.build_recsys_serve(ARCH, model["jcfg"], J_SHAPES["serve_p99"], _jmesh())
    assert bundle.name == jb.name and bundle.model_flops == jb.model_flops
    params, batch = bundle.args
    assert batch["dense"].shape == (512, cfg.n_dense) and batch["sparse"].dtype == torch.int32
    assert int(batch["sparse"].min()) >= 0
    got = bundle.step(params, batch)
    want = jb.step(model["jparams"], {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    _close(got, want)


def retrieval_smoke_config():
    """The smoke config with the item table (field 0) at 2,048 rows.  At
    its smoke size of 100 rows (512 padded) candidates j and j + 512 share a
    row, so R_anc holds near-duplicate columns and Algorithm 1's bordered
    pinv goes non-finite in both packages alike (held by
    ``tests/test_torch_adacur.py::test_smoke_item_table_breaks_algorithm_1_in_both_packages``)."""
    smoke = registry.smoke_config(ARCH)
    return replace(smoke, table_sizes=(2048,) + smoke.table_sizes[1:])


def test_retrieval_builder_matches():
    cfg = retrieval_smoke_config()
    jcfg = _jcfg(cfg)
    jparams, _ = j_dlrm.init_dlrm(jax.random.PRNGKey(0), jcfg)
    params = convert.dlrm_params(jax.tree.map(np.asarray, jparams), device="cpu")
    shape = dataclasses.replace(RECSYS_SHAPES["retrieval_cand"], n_candidates=1000)
    bundle = steps.build_recsys_retrieval(ARCH, cfg, shape, params=params, device="cpu")
    jb = j_steps.build_recsys_retrieval(
        ARCH, jcfg, dataclasses.replace(J_SHAPES["retrieval_cand"], n_candidates=1000),
        _jmesh())
    assert bundle.name == jb.name and bundle.model_flops == jb.model_flops
    params, batch, key = bundle.args
    r_anc = batch["r_anc"]
    assert r_anc.shape == (steps.K_Q, 1024) and not r_anc[:, 1000:].any()
    # R_anc is DLRM's own scores of the anchor contexts
    anchors = steps.recsys_inputs(cfg, steps.K_Q, 2, "cpu")
    cand = torch.arange(1000, dtype=torch.int32)[None, :].expand(3, -1)
    _close(r_anc[:3, :1000], j_dlrm.score_candidates(
        jparams, jnp.asarray(anchors["dense"][:3].numpy()),
        jnp.asarray(anchors["sparse"][:3].numpy()), jnp.asarray(cand.numpy()), jcfg))
    idx, scores = bundle.step(params, batch, key)
    assert bundle.stats.ce_calls == 500 and idx.shape == (1, 100)
    assert (idx < 1000).all() and len(set(idx[0].tolist())) == 100
    jidx, jscores = jb.step(jparams, {k: jnp.asarray(v.numpy()) for k, v in batch.items()},
                            jnp.asarray(key.numpy().astype(np.uint32)))
    assert topk_overlap(np.asarray(jidx), idx) >= 0.99
    _close(scores[0, :10], np.asarray(jscores)[0, :10])


def test_builders_refuse_other_kinds():
    """An unknown kind raises ``KeyError``, as the reference's dispatch
    does (every kind the reference has is served)."""
    cfg = RecSysConfig(name="gru4rec", kind="gru4rec", embed_dim=8)
    with pytest.raises(KeyError, match="gru4rec"):
        steps.recsys_flops(cfg, 4)
    with pytest.raises(KeyError, match="gru4rec"):
        steps.build_recsys_serve("gru4rec", cfg, RECSYS_SHAPES["serve_p99"], device="cpu")
    with pytest.raises(KeyError, match="gru4rec"):
        j_steps._recsys_init("gru4rec", _jcfg(cfg))


def test_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch):
    cfg = registry.smoke_config(ARCH)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: steps.recsys_init(cfg),
                 lambda: steps.recsys_inputs(cfg, 4),
                 lambda: steps.build_recsys_serve(ARCH, cfg, RECSYS_SHAPES["serve_p99"]),
                 lambda: dlrm.init_dlrm(cfg, torch.Generator())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert prng.PRNGKey(0).shape == (2,)
