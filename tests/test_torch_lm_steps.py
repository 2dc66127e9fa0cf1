"""The port's LM step builders (``launch/steps.py``: ``build_lm_prefill``,
``build_lm_decode``, ``build_lm_adacur_serve``, ``build_cell``) and the
MoE aux term of its LM loss, on the CPU, against the JAX package's
builders run live on a 1 x 1 (data, model) mesh, for the registry's five
LMs at ``smoke_config``.

Weights are drawn by the port and handed over as numpy arrays
(``tests/_torch_lm.py``); each builder's seeded inputs (tokens, cache,
corpus, queries, R_anc) are the port bundle's, handed over as numpy too.
The port prefills through the flash kernel's plain version, the reference
through ``ref`` (the same function on unpadded tokens).  Bars: logits,
caches and losses within 2e-5 of the largest |value| (fp32, two layers);
``build_lm_adacur_serve`` (the non-causal qwen3-8b smoke config, N =
2,048, B = 2) to the engine contract: top-100 overlap >= 0.99 against the
reference's ids, every returned score carried by its id in the exact CE
score field (``testing.topk_report``), and measured CE calls equal to the
plan.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # one intra-op thread: the suite runs a process a core
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as j_registry  # noqa: E402
from repro.configs.base import replace as j_replace  # noqa: E402
from repro.configs.shapes import LMShape as JLMShape  # noqa: E402
from repro.core.engine import ce_call_plan as j_ce_call_plan  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import LMShape, replace  # noqa: E402
from repro_torch.core.engine import ce_call_plan  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import cross_encoder, transformer  # noqa: E402
from repro_torch.testing import topk_overlap, topk_report  # noqa: E402
from _torch_lm import lm_params, ref_tree  # noqa: E402

LM_ARCHS = list(registry.LM_ARCHS)
TOL = 2e-5
PREFILL = dict(name="prefill_small", kind="prefill", seq_len=16, global_batch=2)
DECODE = dict(name="decode_small", kind="decode", seq_len=12, global_batch=2)
DECODE_POS = 7                 # the new token's position: entries 8..11 stay masked


def _mesh():
    """A 1 x 1 (data, model) mesh with Auto axes: the reference's builders
    constrain shardings by PartitionSpec inside their steps."""
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return tree.detach().numpy().copy() if hasattr(tree, "detach") else np.asarray(tree)


def _close(got, want, rel=TOL, what=""):
    got, want = np.asarray(_np(got), np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all(), (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1.0), (what, err)


def _close_cache(got, want, what):
    """A port cache ({"layers": [{"k", "v"}], "prefix": [...]}) against the
    reference's (stacked k/v, prefix list), leaf by leaf."""
    assert len(got["layers"]) == want["k"].shape[0]
    for i, c in enumerate(got["layers"]):
        _close(c["k"], want["k"][i], what=f"{what} layer {i} k")
        _close(c["v"], want["v"][i], what=f"{what} layer {i} v")
    assert len(got.get("prefix", [])) == len(want.get("prefix", []))
    for i, (c, w) in enumerate(zip(got.get("prefix", []), want.get("prefix", []))):
        _close(c["k"], w["k"], what=f"{what} prefix {i} k")
        _close(c["v"], w["v"], what=f"{what} prefix {i} v")


def _run(step, *args):
    with jax.set_mesh(_mesh()):
        return jax.jit(step)(*args)


@pytest.fixture(scope="module", params=LM_ARCHS)
def arch(request):
    cfg = registry.smoke_config(request.param)
    params = lm_params(cfg)
    return dict(arch=request.param, cfg=cfg, jcfg=j_registry.smoke_config(request.param),
                params=params, jparams=jax.tree.map(jnp.asarray, ref_tree(params)))


def test_prefill_builder_matches(arch):
    cfg, name = arch["cfg"], arch["arch"]
    b = steps.build_lm_prefill(name, cfg, LMShape(**PREFILL), params=arch["params"],
                               device="cpu")
    jb = j_steps.build_lm_prefill(name, arch["jcfg"], JLMShape(**PREFILL), _mesh())
    assert b.name == jb.name and b.model_flops == jb.model_flops
    params, tokens = b.args
    assert tokens.shape == (2, 16) and tokens.dtype == torch.int32
    logits, cache = b.step(params, tokens)
    jlogits, jcache = _run(jb.step, arch["jparams"], jnp.asarray(tokens.numpy()))
    v = cfg.vocab_size
    _close(logits[:, :v], np.asarray(jlogits)[:, :v], what="last logits")
    _close_cache(cache, _np(jcache), "prefill")


def test_decode_builder_matches(arch):
    """One step at position 7 of a 12-entry cache filled with seeded values
    (the entries past the position are masked), in place in the port."""
    cfg, name = arch["cfg"], arch["arch"]
    b = steps.build_lm_decode(name, cfg, LMShape(**DECODE), params=arch["params"],
                              device="cpu")
    jb = j_steps.build_lm_decode(name, arch["jcfg"], JLMShape(**DECODE), _mesh())
    assert b.name == jb.name and b.model_flops == jb.model_flops
    params, cache, token, pos = b.args
    assert int(pos) == DECODE["seq_len"] - 1 and not cache["layers"][0]["k"].any()
    rng = np.random.default_rng(5)
    for part in cache.values():
        for c in part:
            for t in c.values():
                t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
    jcache = {"k": np.stack([c["k"].numpy() for c in cache["layers"]]),
              "v": np.stack([c["v"].numpy() for c in cache["layers"]])}
    if "prefix" in cache:
        jcache["prefix"] = _np(cache["prefix"])
    jlogits, jnew = _run(jb.step, arch["jparams"], jax.tree.map(jnp.asarray, jcache),
                         jnp.asarray(token.numpy()), jnp.int32(DECODE_POS))
    logits, new = b.step(params, cache, token, torch.tensor(DECODE_POS))
    assert new is cache
    v = cfg.vocab_size
    _close(logits[:, :v], np.asarray(jlogits)[:, :v], what="decode logits")
    _close_cache(new, _np(jnew), "decode")


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "moonshot-v1-16b-a3b"])
def test_lm_loss_adds_the_moe_aux_term(name):
    """``_lm_loss_fn`` on a MoE config: the next-token NLL plus
    ``aux_loss_coef`` x the summed aux loss, equal to the reference's; and
    one ``build_lm_train`` step trains the MoE smoke model (finite loss,
    every expert weight moved)."""
    cfg = registry.smoke_config(name)
    params = lm_params(cfg)
    rng = np.random.default_rng(11)
    tokens = rng.integers(4, cfg.vocab_size, (2, 32)).astype(np.int32)
    batch = {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1)}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jparams = jax.tree.map(jnp.asarray, ref_tree(params))
    with jax.set_mesh(_mesh()):
        jloss = float(jax.jit(j_steps._lm_loss_fn(j_registry.smoke_config(name), None,
                                                  _mesh()))(jparams, batch))
    with torch.no_grad():
        loss = float(steps._lm_loss_fn(cfg)(params, tbatch))
        h, aux = transformer.encode(params, tbatch["tokens"], cfg)
        nll = float(steps._chunked_nll(params, h, tbatch["targets"], cfg))
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    assert float(aux) > 0 and loss - nll == pytest.approx(cfg.moe.aux_loss_coef * float(aux),
                                                          rel=1e-4)
    b = steps.build_lm_train(name, cfg, LMShape("train_small", "train", 32, 2), params=params,
                             device="cpu")
    before = params["layers"][-1]["moe"]["wg"].detach().clone()
    p, _, met = b.step(*b.args[:2], tbatch)
    assert np.isfinite(float(met["loss"]))
    assert (p["layers"][-1]["moe"]["wg"] != before).any(dim=(1, 2)).all()


def test_build_cell_dispatches_and_refuses_unported_families(monkeypatch):
    ce = registry.CE_TINY
    for shape, fn in (("train_4k", "build_lm_train"), ("prefill_32k", "build_lm_prefill"),
                      ("decode_32k", "build_lm_decode")):
        b = steps.build_cell("ce-tiny", shape, global_batch=1, device="cpu")
        assert b.name == f"ce-tiny:{shape}"
        want = getattr(steps, fn)("ce-tiny", ce, registry.shapes_for("ce-tiny")[shape],
                                  params=b.args[0], global_batch=1, device="cpu")
        assert b.model_flops == want.model_flops
    smoke = registry.smoke_config("dlrm-mlperf")
    dlrm_params = steps.recsys_init(smoke, device="cpu")
    assert steps.build_cell("dlrm-mlperf", "serve_p99", params=dlrm_params,
                            device="cpu").name == "dlrm-mlperf:serve_p99"
    gnn = steps.build_cell("nequip", "molecule", device="cpu")     # served since the GNN slice
    assert gnn.name == "nequip:molecule" and gnn.model_flops == 2.0 * 8192 * 11 * 9 * 32 * 5
    from _torch_recsys import smoke_registry

    for arch in ("bst", "mind", "bert4rec"):      # served since the recsys slice
        cfg = smoke_registry(monkeypatch, arch)
        b = steps.build_cell(arch, "serve_p99", device="cpu")
        assert b.name == f"{arch}:serve_p99" and b.args[1]["history"].shape == (512, cfg.seq_len)


@pytest.fixture(scope="module")
def adacur_serve():
    """Both packages' ``build_lm_adacur_serve`` on the qwen3-8b smoke config
    made bidirectional, N = 2,048, B = 2 (k_q 500, budget 500 in 5 rounds,
    top 100), on the port bundle's corpus, queries, R_anc and key."""
    name = "qwen3-8b"
    cfg = replace(registry.smoke_config(name), causal=False)
    jcfg = j_replace(j_registry.smoke_config(name), causal=False)
    params = lm_params(cfg, seed=1, ce=True)
    b = steps.build_lm_adacur_serve(name, cfg, params=params, n_items=2048, batch=2,
                                    device="cpu")
    jb = j_steps.build_lm_adacur_serve(name, jcfg, _mesh(), n_items=2048, batch=2)
    params, batch_in, key = b.args
    idx, scores = b.step(params, batch_in, key)
    jparams = jax.tree.map(jnp.asarray, ref_tree(params))
    jidx, jscores = _run(jb.step, jparams,
                         {k: jnp.asarray(v.numpy()) for k, v in batch_in.items()},
                         jnp.asarray(key.numpy().astype(np.uint32)))
    # the field each returned id's score is held to: the exact CE score of
    # every (query, item) pair either package returned (NaN elsewhere: no
    # other entry is read)
    field = torch.full((2, 2048), float("nan"))
    pair_len = batch_in["query_tokens"].shape[1] + batch_in["corpus_tokens"].shape[1] + 3
    with torch.no_grad():
        for i in range(2):
            ids = torch.as_tensor(sorted(set(idx[i].tolist()) | set(np.asarray(jidx)[i].tolist())))
            pairs = cross_encoder.build_pair_tokens(batch_in["query_tokens"][i:i + 1],
                                                    batch_in["corpus_tokens"][ids][None],
                                                    pad_to=pair_len)
            field[i, ids] = cross_encoder.score_tokens(params, pairs[0], cfg)
    return dict(b=b, jb=jb, cfg=cfg, idx=idx, scores=scores, jidx=np.asarray(jidx),
                jscores=np.asarray(jscores), field=field, batch_in=batch_in)


def test_adacur_serve_inputs_and_plan(adacur_serve):
    b, jb, batch_in = adacur_serve["b"], adacur_serve["jb"], adacur_serve["batch_in"]
    assert b.name == jb.name == "qwen3-8b:adacur_serve"
    assert b.model_flops == jb.model_flops
    assert batch_in["corpus_tokens"].shape == (2048, 48)
    assert batch_in["query_tokens"].shape == (2, 16)
    assert batch_in["r_anc"].shape == (500, 2048)
    # no pad id 0 inside a pair: the flash path's length mask stays trailing
    assert int(batch_in["corpus_tokens"].min()) >= 3 and int(batch_in["query_tokens"].min()) >= 3
    plan = ce_call_plan(steps.ADACUR_SERVE_CFG)
    from repro.configs.base import AdaCURConfig as JConfig
    assert plan == j_ce_call_plan(JConfig(**dataclasses.asdict(steps.ADACUR_SERVE_CFG))) == 500
    assert b.stats.ce_calls == plan * 2 and b.stats.pairs == plan * 2


def test_adacur_serve_matches_the_reference(adacur_serve):
    r = adacur_serve
    idx, scores = r["idx"], r["scores"]
    assert idx.shape == (2, 100) and (idx < 2048).all()
    assert all(len(set(row)) == 100 for row in idx.tolist())
    assert topk_overlap(r["jidx"], idx) >= 0.99
    rep = topk_report(idx, scores, r["jidx"], r["jscores"], r["field"])
    assert rep["ok"], rep
