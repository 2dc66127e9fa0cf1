"""The port's AnchorIndex lifecycle held against the JAX package run live:
save/load across the two packages in both directions (formats v1-v4), a
build the reference began resumed by the port, stale build manifests,
``add_items`` / ``remove_items`` / ``with_capacity`` on every payload, the
mutation guards and the token table's lockstep, and
``AdaCURService.swap_index``.

Both packages read one numpy score matrix (the JAX package's synthetic
domain, N = 300, k_q = 40), so every comparison here is exact: leaves and
payload bytes bit-equal, the same ids from ``topk``, the same meta.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # one intra-op thread: the suite runs a process a core
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.index import AnchorIndex as JIndex  # noqa: E402
from repro.core.index import build_r_anc as j_build_r_anc  # noqa: E402
from repro.data.synthetic import make_synthetic_ce  # noqa: E402
from repro_torch.configs.base import AdaCURConfig  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.index import AnchorIndex, build_r_anc, clear_build_checkpoints  # noqa: E402
from repro_torch.core.scorer import TabulatedScorer  # noqa: E402
from repro_torch.kernels.approx_topk.quant import QuantizedRanc  # noqa: E402
from repro_torch.launch.serve import AdaCURService, RetrievalRequest  # noqa: E402
from repro_torch.testing import topk_overlap  # noqa: E402

K_Q, N, TILE = 40, 300, 64
PAYLOADS = ["float32", "bfloat16", "int8", "int4", "fp8"]
CFG = dict(k_anchor=20, n_rounds=4, budget_ce=40, k_retrieve=10, loop_mode="fori",
           use_fused_topk=True, fused_tile=128)


@pytest.fixture(scope="module")
def m():
    ce = make_synthetic_ce(jax.random.PRNGKey(0), n_queries=60, n_items=N)
    return np.asarray(ce.full_matrix(jnp.arange(60)))


def _tokens(n, item_len=6):
    return (np.arange(n * item_len, dtype=np.int32).reshape(n, item_len) % 97) + 3


def _pair(m, cols=N, capacity=None, payload="float32"):
    """The same index in both packages."""
    j = JIndex.from_r_anc(jnp.asarray(m[:K_Q, :cols]), capacity=capacity)
    t = AnchorIndex.from_r_anc(torch.from_numpy(m[:K_Q, :cols].copy()), capacity=capacity)
    if payload != "float32":
        j, t = j.quantize(payload, tile=TILE), t.quantize(payload, tile=TILE)
    return j, t


def _bytes(x) -> np.ndarray:
    """A leaf's raw bytes (numpy, JAX or torch; bf16 / fp8 through uint8)."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        if x.dtype in (torch.bfloat16, torch.float8_e4m3fn):
            x = x.view(torch.uint8)
        return x.numpy().view(np.uint8).reshape(-1)
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8).reshape(-1)


def _payload_leaves(idx):
    r = idx.r_anc
    if isinstance(r, QuantizedRanc) or hasattr(r, "codes"):
        return {"codes": r.codes, "scales": r.scales}
    return {"r_anc": r}


def _assert_same_index(j, t):
    """Every payload byte, item id and the valid count equal."""
    jl, tl = _payload_leaves(j), _payload_leaves(t)
    assert set(jl) == set(tl)
    for k in jl:
        assert np.array_equal(_bytes(jl[k]), _bytes(tl[k])), k
    if hasattr(j.r_anc, "codes"):
        assert (j.r_anc.tile, j.r_anc.code_dtype, j.r_anc.n_cols) == (
            t.r_anc.tile, t.r_anc.code_dtype, t.r_anc.n_cols)
    assert np.array_equal(np.asarray(j.item_ids), t.item_ids.numpy())
    assert int(j.n_valid) == int(t.n_valid)


def _variant(idx, kind):
    """``idx`` (either package's) in one on-disk format's features."""
    if kind == "tokens":
        return idx.with_item_tokens(_tokens(250))
    if kind == "latents":
        return idx.with_latents(anchor_pos=np.asarray([3, 40, 200, 249]))
    return idx


FORMATS = [("float32", "plain", 1), ("bfloat16", "plain", 1), ("float32", "latents", 1),
           ("int8", "plain", 2), ("float32", "tokens", 3), ("int4", "plain", 4),
           ("fp8", "plain", 4)]


@pytest.mark.parametrize("payload,kind,version", FORMATS,
                         ids=[f"v{v}-{p}-{k}" for p, k, v in FORMATS])
def test_reference_saved_index_loads_into_the_port(m, tmp_path, payload, kind, version):
    j = _variant(_pair(m, cols=250, capacity=320, payload=payload)[0], kind)
    j.save(str(tmp_path))
    with open(tmp_path / "index_meta.json") as f:
        assert json.load(f)["format_version"] == version
    t = AnchorIndex.load(str(tmp_path), device="cpu")
    _assert_same_index(j, t)
    for name in ("anchor_query_ids", "anchor_item_pos", "u", "item_embeddings", "item_tokens"):
        a, b = getattr(j, name), getattr(t, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert np.array_equal(_bytes(a), _bytes(b)), name
    e = np.random.default_rng(1).standard_normal((8, K_Q)).astype(np.float32)
    _, ji = j.topk(jnp.asarray(e), 20)
    _, ti = t.topk(torch.from_numpy(e), 20)
    assert np.array_equal(np.asarray(ji), ti.numpy()) and int(ti.max()) < 250


@pytest.mark.parametrize("payload,kind,version", FORMATS,
                         ids=[f"v{v}-{p}-{k}" for p, k, v in FORMATS])
def test_port_saved_index_loads_into_the_reference(m, tmp_path, payload, kind, version):
    j, t = (_variant(i, kind) for i in _pair(m, cols=250, capacity=320, payload=payload))
    t.save(str(tmp_path / "port"))
    j.save(str(tmp_path / "ref"))
    loaded = JIndex.load(str(tmp_path / "port"))
    _assert_same_index(loaded, t)
    for name in ("anchor_query_ids", "anchor_item_pos", "item_tokens"):
        a, b = getattr(loaded, name), getattr(t, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert np.array_equal(_bytes(a), _bytes(b)), name
    # latents: the port's own U and E_I round-trip bit for bit
    if t.has_latents:
        assert np.array_equal(_bytes(loaded.u), _bytes(t.u))
        assert np.array_equal(_bytes(loaded.item_embeddings), _bytes(t.item_embeddings))
    metas = [json.load(open(tmp_path / side / "index_meta.json")) for side in ("port", "ref")]
    assert metas[0] == metas[1] and metas[0]["format_version"] == version
    manifests = [json.load(open(tmp_path / side / "step_0" / "manifest.json"))
                 for side in ("port", "ref")]
    if kind != "latents":        # same leaves, shapes, dtypes, specs
        assert manifests[0] == manifests[1]


def test_load_refuses_an_unknown_version_and_a_missing_index(m, tmp_path):
    _, t = _pair(m)
    t.save(str(tmp_path / "i"))
    meta = tmp_path / "i" / "index_meta.json"
    raw = json.load(open(meta))
    raw["format_version"] = 999
    json.dump(raw, open(meta, "w"))
    with pytest.raises(ValueError, match="format version"):
        AnchorIndex.load(str(tmp_path / "i"), device="cpu")
    with pytest.raises(FileNotFoundError):
        AnchorIndex.load(str(tmp_path / "nope"), device="cpu")


def test_save_load_search_round_trip(m, tmp_path):
    """A loaded index searches bit-equal to the one saved (the engine over
    a padded capacity, latents kept)."""
    from repro_torch.core.engine import AdaCURRetriever

    _, t = _pair(m, cols=250, capacity=320)
    t = t.with_latents(k_anchor=10, key=prng.PRNGKey(5))
    t.save(str(tmp_path))
    loaded = AnchorIndex.load(str(tmp_path), device="cpu")
    q = torch.arange(40, 60)
    runs = [AdaCURRetriever.from_index(i, TabulatedScorer(m), AdaCURConfig(**CFG)).search(
        q, prng.PRNGKey(1)) for i in (t, loaded)]
    assert torch.equal(runs[0].topk_idx, runs[1].topk_idx)
    assert torch.equal(runs[0].topk_scores, runs[1].topk_scores)


@pytest.mark.parametrize("payload", ["float32", "int8"])
def test_engine_search_matches_the_reference(m, payload):
    """``AnchorIndex.engine_search`` over a padded index against the
    reference's: the engine-level bar (top-k overlap >= 0.99) and the same
    measured CE calls."""
    from repro.configs.base import AdaCURConfig as JConfig
    from repro.core.scorer import TabulatedScorer as JTab

    j, t = _pair(m, cols=250, capacity=320, payload=payload)
    q = np.arange(40, 60)
    jscorer, tscorer = JTab(m), TabulatedScorer(m)
    jres = j.engine_search(jscorer, jnp.asarray(q), JConfig(**CFG), jax.random.PRNGKey(3))
    tres = t.engine_search(tscorer, torch.from_numpy(q), AdaCURConfig(**CFG), prng.PRNGKey(3))
    assert topk_overlap(np.asarray(jres.topk_idx), tres.topk_idx) >= 0.99
    assert tres.topk_idx.max() < 250
    assert tscorer.stats.ce_calls == int(jscorer.stats.ce_calls) == CFG["budget_ce"] * len(q)


# ---- resumable build --------------------------------------------------------


def _tabulated(m, counter=None, fail_after=None):
    def fn(q, i):
        if counter is not None:
            if fail_after is not None and counter["n"] >= fail_after:
                raise RuntimeError("preempted")
            counter["n"] += 1
        q = np.asarray(q.cpu() if isinstance(q, torch.Tensor) else q)
        i = np.asarray(i.cpu() if isinstance(i, torch.Tensor) else i)
        return m[q][:, i]
    return fn


def test_port_resumes_a_build_the_reference_began(m, tmp_path):
    d = str(tmp_path / "ck")
    seen = {"n": 0}

    def j_fn(q, i):
        return jnp.asarray(_tabulated(m, seen, fail_after=2)(q, i))

    with pytest.raises(RuntimeError, match="preempted"):
        j_build_r_anc(j_fn, jnp.arange(K_Q), jnp.arange(N), block_rows=8, checkpoint_dir=d)
    count = {"n": 0}
    got = build_r_anc(lambda q, i: torch.from_numpy(_tabulated(m, count)(q, i)),
                      torch.arange(K_Q), torch.arange(N), block_rows=8, checkpoint_dir=d)
    assert count["n"] == 3          # 5 blocks, 2 checkpointed by the reference
    want = np.asarray(j_build_r_anc(lambda q, i: jnp.asarray(_tabulated(m)(q, i)),
                                    jnp.arange(K_Q), jnp.arange(N), block_rows=8))
    assert np.array_equal(_bytes(got), _bytes(want))
    with open(os.path.join(d, "manifest.json")) as f:
        assert json.load(f)["done_blocks"] == [0, 1, 2, 3, 4]
    clear_build_checkpoints(d)
    assert os.listdir(d) == []


@pytest.mark.parametrize("change", ["block_rows", "anchor_ids", "item_ids"])
def test_stale_manifest_is_invalidated(m, tmp_path, change):
    """A manifest from another block geometry or other ids is cleared and
    every block rescored, to the bytes of a fresh build."""
    d = str(tmp_path / "ck")
    build_r_anc(lambda q, i: torch.from_numpy(_tabulated(m)(q, i)), torch.arange(K_Q),
                torch.arange(N), block_rows=16, checkpoint_dir=d)
    q_ids, i_ids, rows = torch.arange(K_Q), torch.arange(N), 16
    if change == "block_rows":
        rows = 8
    elif change == "anchor_ids":
        q_ids = torch.arange(10, 10 + K_Q)
    else:
        i_ids = torch.flip(torch.arange(N), [0])
    count = {"n": 0}
    got = build_r_anc(lambda q, i: torch.from_numpy(_tabulated(m, count)(q, i)), q_ids,
                      i_ids, block_rows=rows, checkpoint_dir=d)
    assert count["n"] == -(-K_Q // rows)
    assert np.array_equal(got.numpy(), m[q_ids.numpy()][:, i_ids.numpy()])
    with open(os.path.join(d, "manifest.json")) as f:
        meta = json.load(f)
    assert meta["block_rows"] == rows and len(meta["done_blocks"]) == -(-K_Q // rows)


def test_resume_skips_every_finished_block(m, tmp_path):
    d = str(tmp_path / "ck")
    a = AnchorIndex.build(lambda q, i: torch.from_numpy(_tabulated(m)(q, i)),
                          torch.arange(K_Q), torch.arange(N), block_rows=16, checkpoint_dir=d)

    def exploding(q, i):
        raise AssertionError("resume must not rescore finished blocks")

    b = AnchorIndex.build(exploding, torch.arange(K_Q), torch.arange(N), block_rows=16,
                          checkpoint_dir=d)
    assert torch.equal(a.r_anc, b.r_anc)


# ---- mutation ---------------------------------------------------------------


MUTATIONS = ["add_items", "remove_items", "with_capacity"]


def _mutate(idx, op, m, lib):
    if op == "add_items":
        return idx.add_items(lib.arange(250, 300), cols=lib.asarray(m[:K_Q, 250:300].copy()))
    if op == "remove_items":
        return idx.remove_items(lib.asarray(np.r_[7, 100:150, 299]))
    return idx.with_capacity(384)


@pytest.mark.parametrize("op", MUTATIONS)
@pytest.mark.parametrize("payload", PAYLOADS)
def test_mutated_payload_is_bit_equal_to_the_reference(m, payload, op):
    cols = 250 if op == "add_items" else (N if op == "remove_items" else 250)
    cap = 260 if op == "with_capacity" else 320
    j, t = _pair(m, cols=cols, capacity=cap, payload=payload)
    jm = _mutate(j, op, m, jnp)
    tm = _mutate(t, op, m, torch)
    _assert_same_index(jm, tm)
    if op != "with_capacity":
        # the fp32 payload equals a from-scratch build over the same columns
        if payload == "float32":
            keep = (np.arange(N) if op == "add_items"
                    else np.setdiff1d(np.arange(N), np.r_[7, 100:150, 299]))
            fresh = AnchorIndex.from_r_anc(torch.from_numpy(m[:K_Q, keep].copy()),
                                           item_ids=torch.as_tensor(keep), capacity=cap)
            assert torch.equal(fresh.r_anc, tm.r_anc) and torch.equal(fresh.item_ids,
                                                                      tm.item_ids)


def test_latents_extend_and_anchor_positions_remap(m):
    """add_items extends E_I by U @ cols (within fp32 rounding of the
    reference's); remove_items remaps the anchor positions as the
    reference does."""
    j, t = _pair(m, cols=250, capacity=320)
    pos = np.asarray([200, 230, 249])
    j, t = j.with_latents(anchor_pos=jnp.asarray(pos)), t.with_latents(
        anchor_pos=torch.as_tensor(pos))
    jg, tg = _mutate(j, "add_items", m, jnp), _mutate(t, "add_items", m, torch)
    np.testing.assert_allclose(tg.item_embeddings.numpy(), np.asarray(jg.item_embeddings),
                               atol=1e-4, rtol=0)
    js = jg.remove_items(jnp.arange(0, 50))
    ts = tg.remove_items(torch.arange(0, 50))
    assert ts.anchor_item_pos.tolist() == np.asarray(js.anchor_item_pos).tolist() == [
        150, 180, 199]
    assert ts.gather_item_ids(ts.anchor_item_pos).tolist() == [200, 230, 249]


def _guard(m, case):
    base = AnchorIndex.from_r_anc(torch.from_numpy(m[:K_Q, :250].copy()), capacity=260)
    cols = lambda a, b: torch.from_numpy(m[:K_Q, a:b].copy())  # noqa: E731
    if case == "overflow":
        base.add_items(torch.arange(250, 300), cols=cols(250, 300))
    elif case == "already_present":
        base.add_items(torch.arange(5), cols=cols(0, 5))
    elif case == "duplicate":
        base.add_items(torch.tensor([250, 250]), cols=cols(0, 2))
    elif case == "negative":
        base.add_items(torch.tensor([-1]), cols=cols(0, 1))
    elif case == "anchor_removal":
        lat = base.with_latents(k_anchor=8, key=prng.PRNGKey(0))
        lat.remove_items(lat.gather_item_ids(lat.anchor_item_pos)[:1])
    elif case == "tokens_missing":
        base.with_item_tokens(_tokens(250)).add_items(torch.arange(250, 255),
                                                      cols=cols(250, 255))
    elif case == "no_token_table":
        base.add_items(torch.arange(250, 255), cols=cols(250, 255), new_tokens=_tokens(5))
    elif case == "token_rows":
        base.with_item_tokens(_tokens(123))
    elif case == "shrink_below_valid":
        base.with_capacity(200)


GUARDS = [("overflow", "overflows capacity"), ("already_present", "already in the index"),
          ("duplicate", "duplicate item ids"), ("negative", "padding sentinel"),
          ("anchor_removal", "anchor item"), ("tokens_missing", "new_tokens"),
          ("no_token_table", "no token table"), ("token_rows", "rows"),
          ("shrink_below_valid", "n_valid")]


@pytest.mark.parametrize("case,match", GUARDS, ids=[g[0] for g in GUARDS])
def test_mutation_guards(m, case, match):
    with pytest.raises(ValueError, match=match):
        _guard(m, case)


def test_token_table_moves_in_lockstep(m):
    """The token table pads to capacity, grows with add_items, compacts with
    remove_items by the payload's permutation (position j still tokenizes
    the item at position j), re-pads with with_capacity, as the
    reference's."""
    tok, new_tok = _tokens(250), _tokens(10) + 1
    j, t = _pair(m, cols=250, capacity=300)
    j, t = j.with_item_tokens(tok), t.with_item_tokens(tok)
    assert tuple(t.item_tokens.shape) == (300, 6) and not t.item_tokens[250:].any()
    jg = j.add_items(jnp.arange(250, 260), cols=jnp.asarray(m[:K_Q, 250:260]),
                     new_tokens=new_tok)
    tg = t.add_items(torch.arange(250, 260), cols=torch.from_numpy(m[:K_Q, 250:260].copy()),
                     new_tokens=new_tok)
    js, ts = jg.remove_items(jnp.arange(100, 150)), tg.remove_items(torch.arange(100, 150))
    jw, tw = js.with_capacity(384), ts.with_capacity(384)
    for a, b in ((jg, tg), (js, ts), (jw, tw)):
        assert np.array_equal(np.asarray(a.item_tokens), b.item_tokens.numpy())
    full = np.concatenate([tok, new_tok])
    ids = ts.item_ids.numpy()
    assert all(np.array_equal(ts.item_tokens[p].numpy(), full[ids[p]])
               for p in range(ts.n_items))


# ---- the service ------------------------------------------------------------


def test_swap_index_drains_under_the_old_index(m, tmp_path):
    """Requests queued before a swap are answered under the index that
    admitted them; after it, no removed id is served.  The service also
    loads an index from its directory."""
    _, t = _pair(m, cols=N, capacity=320)
    t.save(str(tmp_path))
    cfg = AdaCURConfig(**CFG)
    qids = [41, 45, 52, 57, 59]

    def service():
        return AdaCURService(score_fn=TabulatedScorer(m), cfg=cfg, index=str(tmp_path),
                             device="cpu", max_batch=8, max_wait_s=1e9)

    probe = service()
    for q in qids:
        assert probe.submit(RetrievalRequest(query_id=q)) is None
    before = probe.flush()
    removed = sorted({int(r.item_ids[0]) for r in before})
    svc = service()
    for q in qids:
        svc.submit(RetrievalRequest(query_id=q))
    drained = svc.swap_index(svc.index.remove_items(torch.as_tensor(removed)))
    assert [r.query_id for r in drained] == qids and not svc._pending
    for a, b in zip(drained, before):
        assert np.array_equal(a.item_ids, b.item_ids)          # the old index's answers
    assert svc.index.n_items == N - len(removed)
    for q in qids:
        svc.submit(RetrievalRequest(query_id=q))
    after = svc.flush()
    assert all(r.status == "ok" for r in after)
    assert not np.isin(np.stack([r.item_ids for r in after]), removed).any()


def test_serve_cli_builds_saves_then_loads_the_index(tmp_path, capsys):
    """``--index-path``: the first run builds the index resumably into the
    directory, saves it and drops the row blocks; the second loads it and
    takes its item count; a run asking for another count is refused."""
    from repro_torch.launch import serve

    path = str(tmp_path / "idx")
    argv = ["--device", "cpu", "--fused", "--requests", "4", "--batch", "4",
            "--index-path", path]
    serve.main(argv + ["--n-items", "600"])
    out = capsys.readouterr().out
    assert "saved AnchorIndex" in out and "served 4 requests (0 errors)" in out
    assert sorted(os.listdir(path)) == ["index_meta.json", "step_0"]
    serve.main(argv)
    out = capsys.readouterr().out
    assert "|I|=600" in out and "loading AnchorIndex" in out
    assert "served 4 requests (0 errors)" in out
    with pytest.raises(ValueError, match="holds 600 items, not 500"):
        serve.main(argv + ["--n-items", "500"])
