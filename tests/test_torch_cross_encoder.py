"""The port's real cross-encoder path against the JAX package, on the CPU:
layers, the ZESHEL-like token data, ``score_tokens`` through
``convert.cross_encoder_params``, the ``CrossEncoderScorer`` and
``CachingScorer`` and a real-CE engine search.

The model is the reference scorer tests' CE (``tests/test_scorer.py``:
``ce-tiny`` at 2 layers, d_model 64, 4/2 heads, head_dim 16, fp32), its
weights drawn by the JAX package and carried across as numpy arrays.
Bars: fp32 scores within 1e-5 of the reference's (the same arithmetic,
summed in another order); bf16 scores within 2e-2 (see the bf16 test);
engine searches as in ``tests/test_scorer.py`` (identical ids and scores
within 1e-4 against the tabulated matrix) and top-k overlap >= 0.99
against the JAX search.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # one intra-op thread: the suite runs a process a core
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as j_registry  # noqa: E402
from repro.configs.base import AdaCURConfig as JConfig, replace as j_replace  # noqa: E402
from repro.core import engine as j_engine  # noqa: E402
from repro.core.scorer import CrossEncoderScorer as JCEScorer  # noqa: E402
from repro.data import synthetic as j_synth  # noqa: E402
from repro.models import cross_encoder as j_ce, layers as j_layers  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import AdaCURConfig, LMConfig  # noqa: E402
from repro_torch.configs.registry import CE_TINY  # noqa: E402
from repro_torch.core.engine import ce_call_plan, make_engine  # noqa: E402
from repro_torch.core.scorer import (  # noqa: E402
    CachingScorer, CrossEncoderScorer, TabulatedScorer, bucket_for,
)
from repro_torch.data import synthetic as t_synth  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import cross_encoder as t_ce, layers as t_layers  # noqa: E402
from repro_torch.testing import topk_overlap  # noqa: E402


N_ITEMS, N_Q = 80, 24
ENGINE_CFG = dict(k_anchor=12, n_rounds=3, budget_ce=24, k_retrieve=10)


def _lm_cfg(dtype="float32", vocab=256):
    return j_replace(j_registry.CE_TINY, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                     head_dim=16, d_ff=128, vocab_size=vocab, dtype=dtype, remat=False)


def _port_cfg(jcfg):
    return LMConfig(**dataclasses.asdict(jcfg))


def _carry(jparams):
    return convert.cross_encoder_params(jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.fixture(scope="module")
def ce():
    jds = j_synth.make_zeshel_like(0, n_items=N_ITEMS, n_queries=N_Q, item_len=12,
                                   query_len=8)
    tds = t_synth.make_zeshel_like(0, n_items=N_ITEMS, n_queries=N_Q, item_len=12,
                                   query_len=8)
    jcfg = _lm_cfg(vocab=jds.vocab_size)
    jparams, _ = j_ce.init_cross_encoder(jax.random.PRNGKey(0), jcfg)
    cfg = _port_cfg(jcfg)
    params = _carry(jparams)
    scorer = CrossEncoderScorer(params, cfg, tds.pair_tokens, micro_batch=16,
                                flash_block=(16, 16), len_buckets=(32, 64))
    m = scorer._host(np.arange(N_Q), np.tile(np.arange(N_ITEMS), (N_Q, 1))).numpy()
    scorer.reset_stats()
    return dict(jds=jds, tds=tds, jcfg=jcfg, jparams=jparams, cfg=cfg, params=params,
                scorer=scorer, m=m)


def _mixed_pairs(ds, n=12, seed=0):
    """(n, 32) pair tokens of mixed valid lengths (trailing PAD), plus one
    all-PAD row (a micro-batch pad row)."""
    rng = np.random.default_rng(seed)
    toks = ds.pair_tokens(rng.integers(0, N_Q, n), rng.integers(0, N_ITEMS, (n, 1)))[:, 0]
    out = np.zeros((n + 1, 32), np.int32)
    for i, length in enumerate(rng.integers(5, toks.shape[1] + 1, n)):
        out[i, :length] = toks[i, :length]
    return out


# ---------------------------------------------------------------- layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 7, 64), dtype=np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    ref = np.asarray(j_layers.rmsnorm(jx, jnp.asarray(w)).astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    out = t_layers.rmsnorm(tx, torch.from_numpy(w)).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)
    else:   # the same rounding points: at most one bf16 ulp apart
        np.testing.assert_allclose(out, ref, atol=0, rtol=2 ** -7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 3, 16), dtype=np.float32)
    pos = np.broadcast_to(np.arange(9)[None], (2, 9))
    ref = np.asarray(j_layers.apply_rope(jnp.asarray(x).astype(dtype), jnp.asarray(pos),
                                         1e4).astype(jnp.float32))
    out = t_layers.apply_rope(torch.from_numpy(x).to(getattr(torch, dtype)),
                              torch.from_numpy(pos.copy()), 1e4).float().numpy()
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(out, ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_apply_matches(act):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((10, 32), dtype=np.float32)
    p = {"wg": rng.standard_normal((32, 48), dtype=np.float32) / 6,
         "wu": rng.standard_normal((32, 48), dtype=np.float32) / 6,
         "wd": rng.standard_normal((48, 32), dtype=np.float32) / 7}
    ref = np.asarray(j_layers.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                                        jnp.asarray(x), act))
    out = t_layers.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x), act).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------------ data


def test_zeshel_like_tokens_are_bit_equal(ce):
    jds, tds = ce["jds"], ce["tds"]
    for f in ("item_tokens", "query_tokens", "gold"):
        assert np.array_equal(getattr(jds, f), getattr(tds, f)), f
    q, items = np.array([3, 0, 23]), np.array([[1, 79], [0, 5], [44, 44]])
    pairs = tds.pair_tokens(q, items)
    assert np.array_equal(pairs, jds.pair_tokens(q, items))
    built = t_ce.build_pair_tokens(torch.from_numpy(tds.query_tokens[q]),
                                   torch.from_numpy(tds.item_tokens[items]), pad_to=32)
    jbuilt = j_ce.build_pair_tokens(jnp.asarray(jds.query_tokens[q]),
                                    jnp.asarray(jds.item_tokens[items]), pad_to=32)
    assert np.array_equal(built.numpy(), np.asarray(jbuilt))
    assert np.array_equal(built.numpy()[..., :pairs.shape[-1]], pairs)
    with pytest.raises(ValueError, match="cannot hold"):
        t_ce.build_pair_tokens(torch.from_numpy(tds.query_tokens[q]),
                               torch.from_numpy(tds.item_tokens[items]), pad_to=20)


def test_config_copies_the_reference():
    assert dataclasses.asdict(CE_TINY) == dataclasses.asdict(j_registry.CE_TINY)
    assert CE_TINY.n_params() == j_registry.CE_TINY.n_params()
    assert CE_TINY.resolved_head_dim == 32 and CE_TINY.q_per_kv == 2
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LMConfig(**{**dataclasses.asdict(CE_TINY), "moe": object()})


# ---------------------------------------------------------------- scores


@pytest.mark.parametrize("impl", ["ref", "flash"])
def test_score_tokens_matches_fp32(ce, impl):
    toks = _mixed_pairs(ce["tds"])[:-1]
    ref = np.asarray(j_ce.score_tokens(ce["jparams"], jnp.asarray(toks), ce["jcfg"],
                                       attn_impl=impl, flash_block=(16, 16)))
    out = t_ce.score_tokens(ce["params"], torch.from_numpy(toks), ce["cfg"],
                            attn_impl=impl, flash_block=(16, 16)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_flash_and_ref_agree_on_valid_rows(ce):
    """The pad row (every token PAD) is the one exception: flash gives its
    attention zeros (the Pallas kernel's rule), the reference path the mean
    of v; the scorer discards pad-row scores either way."""
    toks = torch.from_numpy(_mixed_pairs(ce["tds"], seed=1))
    ref = t_ce.score_tokens(ce["params"], toks, ce["cfg"], attn_impl="ref")
    flash = t_ce.score_tokens(ce["params"], toks, ce["cfg"], attn_impl="flash",
                              flash_block=(16, 16))
    np.testing.assert_allclose(flash[:-1].numpy(), ref[:-1].numpy(), atol=1e-5, rtol=1e-5)


def test_score_tokens_matches_bf16():
    """bf16 weights and activations: the two frameworks round bf16 at
    different places (XLA may keep a fused chain in fp32), so the CLS
    hidden state can differ by a few bf16 ulps; the bar is 2e-2 of the
    largest score plus 2e-2 relative."""
    jds = j_synth.make_zeshel_like(0, n_items=N_ITEMS, n_queries=N_Q, item_len=12,
                                   query_len=8)
    jcfg = _lm_cfg("bfloat16", jds.vocab_size)
    jparams, _ = j_ce.init_cross_encoder(jax.random.PRNGKey(1), jcfg)
    params = _carry(jparams)
    assert params["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    toks = _mixed_pairs(jds, seed=2)[:-1]
    ref = np.asarray(j_ce.score_tokens(jparams, jnp.asarray(toks), jcfg,
                                       attn_impl="flash", flash_block=(16, 16)))
    out = t_ce.score_tokens(params, torch.from_numpy(toks), _port_cfg(jcfg),
                            attn_impl="flash", flash_block=(16, 16)).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-2 * np.abs(ref).max(), rtol=2e-2)


# --------------------------------------------------------------- scorers


def test_scorer_matches_reference_scorer(ce):
    jsc = JCEScorer(ce["jparams"], ce["jcfg"], ce["jds"].pair_tokens, micro_batch=16,
                    flash_block=(16, 16), len_buckets=(32, 64))
    q, idx = np.arange(5), (np.arange(20).reshape(5, 4) * 7) % N_ITEMS
    ref = np.asarray(jsc._host(q, idx))
    out = ce["scorer"](torch.from_numpy(q), torch.from_numpy(idx))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ref, ce["m"][q[:, None], idx], atol=1e-5, rtol=1e-5)


def test_scorer_buckets_and_counts(ce):
    tds = ce["tds"]
    sc = CrossEncoderScorer(ce["params"], ce["cfg"], tds.pair_tokens, micro_batch=16,
                            flash_block=(16, 16), len_buckets=(32, 64))
    sc(torch.arange(3), torch.arange(15).reshape(3, 5))        # 15 pairs -> one 16-row chunk
    sc(torch.arange(2), torch.arange(20).reshape(2, 10))       # 20 -> two chunks
    assert (sc.stats.ce_calls, sc.stats.batch_pad, sc.stats.pairs) == (35, 13, 35)
    assert sc.n_traces == 1 and sc.forwards == 3

    def long_pairs(q, i):       # 23 + 17 = 40 tokens -> bucket 64
        t = tds.pair_tokens(q, i)
        return np.concatenate([t, np.full(t.shape[:2] + (17,), 7, np.int32)], -1)

    sc.pair_fn = long_pairs
    sc(torch.arange(2), torch.arange(4).reshape(2, 2))
    assert sc.n_traces == 2
    with pytest.raises(ValueError, match="largest length bucket"):
        CrossEncoderScorer(ce["params"], ce["cfg"], tds.pair_tokens, len_buckets=(16,))
    assert bucket_for(33, (32, 64)) == 64


def test_microbatch_pad_rows_never_leak(ce):
    """B=5 forces micro-batch padding: measured == planned, and through
    the cache every miss keys exactly one real pair."""
    r_anc = torch.from_numpy(ce["m"][:16])
    q = torch.arange(16, 21)
    cfg = AdaCURConfig(**ENGINE_CFG, loop_mode="fori")
    sc = CrossEncoderScorer(ce["params"], ce["cfg"], ce["tds"].pair_tokens, micro_batch=16,
                            flash_block=(16, 16), len_buckets=(32, 64))
    make_engine(sc, cfg)(r_anc, q, torch.tensor([0, 5]))
    assert sc.stats.ce_calls == ce_call_plan(cfg) * 5 and sc.stats.batch_pad > 0
    inner = CrossEncoderScorer(ce["params"], ce["cfg"], ce["tds"].pair_tokens,
                               micro_batch=16, flash_block=(16, 16), len_buckets=(32, 64))
    cache = CachingScorer(inner)
    make_engine(cache, cfg)(r_anc, q, torch.tensor([0, 5]))
    assert cache.stats.cache_size == cache.stats.ce_calls == inner.stats.ce_calls
    assert inner.stats.batch_pad > 0


def test_caching_scorer_hits_dedup_and_lru():
    m = np.arange(40, dtype=np.float32).reshape(4, 10)
    inner = TabulatedScorer(m)
    cache = CachingScorer(inner, capacity=5)
    out = cache(torch.tensor([0, 1]), torch.tensor([[3, 3, 4], [3, 9, 9]]))
    assert out.tolist() == [[3, 3, 4], [13, 19, 19]]
    # duplicates within the call are scored once and count as neither
    assert (cache.stats.ce_calls, cache.stats.cache_hits, cache.stats.pairs) == (4, 0, 6)
    assert inner.stats.ce_calls == 4
    out = cache(torch.tensor([0]), torch.tensor([[4, 5]]))
    assert out.tolist() == [[4, 5]]
    assert (cache.stats.ce_calls, cache.stats.cache_hits, cache.stats.cache_size) == (5, 1, 5)
    cache(torch.tensor([2]), torch.tensor([[0]]))          # evicts the LRU pair (0, 3)
    assert cache.stats.cache_size == 5
    cache(torch.tensor([0]), torch.tensor([[3]]))
    assert cache.stats.ce_calls == 7 and cache.stats.cache_hits == 1
    cache.reset_stats(clear_cache=True)
    assert cache.stats.ce_calls == 0 and inner.stats.ce_calls == 0 and not cache._cache
    with pytest.raises(TypeError):
        CachingScorer(lambda q, i: i)


# ---------------------------------------------------------------- search


@pytest.mark.parametrize("loop_mode", ["unrolled", "fori"])
def test_real_ce_search_matches_tabulated(ce, loop_mode):
    cfg = AdaCURConfig(**ENGINE_CFG, loop_mode=loop_mode)
    r_anc, q, key = torch.from_numpy(ce["m"][:16]), torch.arange(16, 24), torch.tensor([0, 5])
    res_ce = make_engine(ce["scorer"], cfg)(r_anc, q, key)
    res_tab = make_engine(TabulatedScorer(ce["m"]), cfg)(r_anc, q, key)
    assert torch.equal(res_ce.topk_idx, res_tab.topk_idx)
    np.testing.assert_allclose(res_ce.topk_scores.numpy(), res_tab.topk_scores.numpy(),
                               atol=1e-4, rtol=1e-4)


def test_real_ce_search_matches_jax(ce):
    """The JAX real-CE search and the port's, fed the same key and the same
    anchor matrix (the JAX CE's own scores)."""
    jsc = JCEScorer(ce["jparams"], ce["jcfg"], ce["jds"].pair_tokens, micro_batch=16,
                    flash_block=(16, 16), len_buckets=(32, 64))
    jm = np.asarray(jsc._host(np.arange(16), np.tile(np.arange(N_ITEMS), (16, 1))))
    kw = dict(**ENGINE_CFG, loop_mode="fori")
    jres = j_engine.make_engine(jsc, JConfig(**kw))(jnp.asarray(jm), jnp.arange(16, 24),
                                                     jax.random.PRNGKey(5))
    tres = make_engine(ce["scorer"], AdaCURConfig(**kw))(
        torch.from_numpy(jm), torch.arange(16, 24),
        convert.key(np.asarray(jax.random.PRNGKey(5))))
    assert topk_overlap(np.asarray(jres.topk_idx), tres.topk_idx) >= 0.99


def test_serve_cli_real_ce_runs_on_the_cpu(capsys):
    serve.main(["--scorer", "real-ce", "--device", "cpu", "--fused", "--requests", "8",
                "--batch", "4", "--n-items", "100"])
    out = capsys.readouterr().out
    assert "served 8 requests (0 errors)" in out
    with pytest.raises(SystemExit, match="ROADMAP"):
        serve.main(["--scorer", "real-ce", "--device", "cpu", "--retriever", "rerank"])
