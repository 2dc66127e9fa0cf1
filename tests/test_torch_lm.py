"""The port's LM family (plain versions, on the CPU) against the JAX package
run live, for the registry's five model-zoo LMs at ``smoke_config`` (2
layers, d_model 64, 4 heads of 16, fp32; the MoE ones at 4 experts, top 2,
capacity factor 8): the configs, ``convert.lm_params`` (with moonshot's
dense prefix layer), ``encode`` with its per-layer KV, ``init_cache`` and
eight ``decode_step`` calls, and the causal cross-encoder fact of both
packages.

Weights are drawn by the port from a seeded generator and handed to the
JAX package as numpy arrays in its stacked layout (``tests/_torch_lm.py``);
``convert.lm_params`` carries them back.  Tokens are numpy draws.  The
port encodes through ``attn_impl="flash"`` (the flash kernel's plain version here), the
reference through ``ref``: for unpadded tokens the two compute the same
function.  Bars (fp32; the same arithmetic summed in another order, two
layers deep): hidden states, logits, KV caches and decode logits within
``TOL`` = 2e-5 of the largest |value|; the MoE aux loss within 1e-5
relative.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # one intra-op thread: the suite runs a process a core
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as j_registry  # noqa: E402
from repro.configs import shapes as j_shapes  # noqa: E402
from repro.models import cross_encoder as j_ce, layers as j_layers, transformer as j_tf  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry, shapes  # noqa: E402
from repro_torch.configs.base import replace  # noqa: E402
from repro_torch.models import cross_encoder, layers, transformer  # noqa: E402
from _torch_lm import lm_params, ref_tree  # noqa: E402

LM_ARCHS = ["qwen3-8b", "qwen1.5-110b", "starcoder2-3b", "moonshot-v1-16b-a3b",
            "granite-moe-1b-a400m"]
TOL = 2e-5
B, L, DECODE_STEPS = 2, 16, 8


def _close(got, want, rel=TOL, what=""):
    got = np.asarray(got.detach() if hasattr(got, "detach") else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1.0), (what, err)


def _ref_cache(tree):
    """The reference's cache pytree (stacked k/v, prefix list) as numpy."""
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=LM_ARCHS)
def lm(request):
    """One arch's reference trace: encode (ref attention, with its KV) and
    eight jitted decode steps from a zero cache, on seeded numpy tokens."""
    arch = request.param
    jcfg, cfg = j_registry.smoke_config(arch), registry.smoke_config(arch)
    tree = ref_tree(lm_params(cfg))
    jparams = jax.tree.map(jnp.asarray, tree)
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, L)).astype(np.int32)

    @jax.jit
    def enc(p, t):
        h, aux, (prefix_kv, scan_kv) = j_tf.encode(p, t, jcfg, return_kv=True)
        return h, j_tf.lm_logits(p, h, jcfg), aux, prefix_kv, scan_kv

    h, logits, aux, prefix_kv, scan_kv = enc(jparams, jnp.asarray(tokens))
    cache = {"k": scan_kv[0], "v": scan_kv[1]}
    if prefix_kv:
        cache["prefix"] = [{"k": k, "v": v} for k, v in prefix_kv]
    dec = jax.jit(lambda p, c, t, pos: j_tf.decode_step(p, c, t, pos, jcfg))
    jc = j_tf.init_cache(jcfg, B, DECODE_STEPS)
    zero_cache = _ref_cache(jc)
    dec_logits = []
    for t in range(DECODE_STEPS):
        lg, jc = dec(jparams, jc, jnp.asarray(tokens[:, t]), jnp.int32(t))
        dec_logits.append(np.asarray(lg))
    return dict(arch=arch, jcfg=jcfg, cfg=cfg, tree=tree, tokens=tokens,
                params=convert.lm_params(tree, device="cpu"),
                h=np.asarray(h), logits=np.asarray(logits), aux=float(aux),
                cache=_ref_cache(cache), zero_cache=zero_cache,
                dec_logits=dec_logits, dec_cache=_ref_cache(jc))


def test_configs_are_copies():
    assert {k: dataclasses.asdict(v) for k, v in shapes.LM_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in j_shapes.LM_SHAPES.items()}
    assert registry.LM_ARCHS == tuple(LM_ARCHS)
    for arch in LM_ARCHS + ["ce-tiny", "dlrm-mlperf"]:
        entry, j_entry = registry.get(arch), j_registry.get(arch)
        assert (entry.family, entry.adacur_applicable, entry.notes) == (
            j_entry.family, j_entry.adacur_applicable, j_entry.notes)
        assert dataclasses.asdict(entry.config) == dataclasses.asdict(j_entry.config), arch
        assert (dataclasses.asdict(registry.smoke_config(arch))
                == dataclasses.asdict(j_registry.smoke_config(arch))), arch
        assert registry.shapes_for(arch).keys() == j_registry.shapes_for(arch).keys()
        if entry.family == "lm":
            cfg, jcfg = entry.config, j_entry.config
            assert (cfg.n_params(), cfg.n_active_params()) == (
                jcfg.n_params(), jcfg.n_active_params()), arch
    assert registry.QWEN3_8B_ATTENTION == dict(n_heads=32, n_kv_heads=8, head_dim=128)


@pytest.mark.parametrize("arch", ["nequip", "bst", "mind", "bert4rec"])
def test_unported_archs_raise_naming_the_roadmap(arch):
    assert arch in j_registry.REGISTRY and arch not in registry.REGISTRY
    with pytest.raises(NotImplementedError, match="ROADMAP.md, queue 1"):
        registry.get(arch)


def test_lm_params_carry_every_leaf(lm):
    """``convert.lm_params``: the stacked layers become a list, the prefix
    layers (moonshot's first dense block) stay a list, every leaf keeps its
    values and dtype; the port's init has the reference init's structure,
    shapes and dtypes (``jax.eval_shape``: traced, not run)."""
    cfg, tree, params = lm["cfg"], lm["tree"], lm["params"]
    n_prefix = transformer.n_prefix_layers(cfg)
    assert len(params["layers"]) == cfg.n_layers - n_prefix
    assert len(params.get("prefix", [])) == n_prefix == len(tree.get("prefix", []))
    for i, lp in enumerate(params["layers"]):
        flat = jax.tree_util.tree_leaves_with_path(jax.tree.map(lambda x: x[i], tree["layers"]))
        for path, want in flat:
            got = lp
            for key in path:
                got = got[key.key]
            assert np.array_equal(got.numpy(), want), (i, path)
    if n_prefix:
        assert "mlp" in params["prefix"][0] and "moe" in params["layers"][0]
        assert params["prefix"][0]["mlp"]["wg"].shape == (cfg.d_model, cfg.moe.d_ff_dense)
        assert np.array_equal(params["prefix"][0]["mlp"]["wd"].numpy(),
                              tree["prefix"][0]["mlp"]["wd"])
    ref = jax.eval_shape(lambda k: j_tf.init_lm(k, lm["jcfg"])[0], jax.random.PRNGKey(0))
    spec = lambda t: jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), t)  # noqa: E731
    assert spec(ref) == spec(tree)
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(_np_params(convert.lm_params(tree, device="cpu"))),
        jax.tree.leaves(_np_params(lm_params(cfg)))))


def _np_params(params):
    return jax.tree.map(lambda x: x.numpy(), params)


def test_encode_matches(lm):
    """The port's flash-path encode against the reference's ``ref`` encode:
    hidden states, logits (real vocab columns; the padded ones are -1e30 in
    both) and the MoE aux loss."""
    cfg = lm["cfg"]
    h, aux = transformer.encode(lm["params"], torch.from_numpy(lm["tokens"]), cfg,
                                attn_impl="flash")
    _close(h, lm["h"], what="hidden")
    logits = transformer.lm_logits(lm["params"], h, cfg)
    v = cfg.vocab_size
    _close(logits[..., :v], lm["logits"][..., :v], what="logits")
    assert np.array_equal(logits[..., v:].numpy(), lm["logits"][..., v:])
    if cfg.moe is None:
        assert float(aux) == lm["aux"] == 0.0
    else:
        assert lm["aux"] > 0 and abs(float(aux) - lm["aux"]) <= 1e-5 * lm["aux"]


def test_encode_returns_the_kv_cache(lm):
    """``return_kv``: each layer's (k, v) after RoPE, leaf by leaf against
    the reference's (its scanned layers stacked, converted by
    ``convert.lm_cache``)."""
    cfg = lm["cfg"]
    _, _, (prefix_kv, layers_kv) = transformer.encode(
        lm["params"], torch.from_numpy(lm["tokens"]), cfg, return_kv=True, attn_impl="flash")
    want = convert.lm_cache(lm["cache"], device="cpu")
    assert len(prefix_kv) == len(want.get("prefix", []))
    assert len(layers_kv) == len(want["layers"])
    for part, got in (("prefix", prefix_kv), ("layers", layers_kv)):
        for i, (k, v) in enumerate(got):
            assert k.shape == (B, L, cfg.n_kv_heads, cfg.resolved_head_dim)
            _close(k, want[part][i]["k"], what=f"{part} {i} k")
            _close(v, want[part][i]["v"], what=f"{part} {i} v")


def test_init_cache_layout(lm):
    """The port's cache is the reference's, unstacked into per-layer dicts
    (``prefix`` for moonshot's dense layer): same shapes, dtype, zeros."""
    cfg = lm["cfg"]
    got = transformer.init_cache(cfg, B, DECODE_STEPS, device="cpu")
    want = convert.lm_cache(lm["zero_cache"], device="cpu")
    assert got.keys() == want.keys()
    for part in got:
        assert len(got[part]) == len(want[part])
        for a, b in zip(got[part], want[part]):
            for name in ("k", "v"):
                assert a[name].shape == b[name].shape == (
                    B, DECODE_STEPS, cfg.n_kv_heads, cfg.resolved_head_dim)
                assert a[name].dtype == b[name].dtype == torch.float32
                assert not a[name].any() and not b[name].any()


def test_decode_steps_match(lm):
    """Eight ``decode_step`` calls from a zero cache: each step's logits and
    the cache after the eighth, against the reference's jitted steps; the
    cache is written in place and returned."""
    cfg = lm["cfg"]
    cache = transformer.init_cache(cfg, B, DECODE_STEPS, device="cpu")
    k0 = cache["layers"][0]["k"]
    for t in range(DECODE_STEPS):
        logits, out = transformer.decode_step(lm["params"], cache, torch.from_numpy(
            lm["tokens"][:, t]), t if t % 2 else torch.tensor(t, dtype=torch.int32), cfg)
        assert out is cache
        _close(logits[:, :cfg.vocab_size], lm["dec_logits"][t][:, :cfg.vocab_size],
               what=f"step {t}")
    assert cache["layers"][0]["k"] is k0
    want = convert.lm_cache(lm["dec_cache"], device="cpu")
    for part in want:
        for i, (a, b) in enumerate(zip(cache[part], want[part])):
            _close(a["k"], b["k"], what=f"{part} {i} k")
            _close(a["v"], b["v"], what=f"{part} {i} v")
    with pytest.raises(ValueError, match="outside a cache"):
        transformer.decode_step(lm["params"], cache, torch.zeros(B, dtype=torch.int32),
                                DECODE_STEPS, cfg)


def test_decode_matches_encode_in_the_port(lm):
    """The reference's own smoke check (``tests/test_arch_smoke.py``) on the
    port: decoding from scratch gives the encoder's logits at every position
    of a causal model (fp32 here: 1e-4 of the largest |logit|)."""
    cfg = lm["cfg"]
    cache = transformer.init_cache(cfg, B, DECODE_STEPS, device="cpu")
    toks = torch.from_numpy(lm["tokens"][:, :DECODE_STEPS])
    h, _ = transformer.encode(lm["params"], toks, cfg, attn_impl="flash")
    enc = transformer.lm_logits(lm["params"], h, cfg)[..., :cfg.vocab_size]
    dec = torch.stack([transformer.decode_step(lm["params"], cache, toks[:, t], t, cfg)[0]
                       for t in range(DECODE_STEPS)], dim=1)[..., :cfg.vocab_size]
    _close(dec, enc.numpy(), rel=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_local_matches(dtype):
    """``decode_attention_local`` on a cache chunk at an offset, its later
    entries masked, against the reference's: (numerator, denominator, max)
    within ``TOL`` in fp32.  On a bf16 cache both round ``p`` to bf16 for
    the P V product, so the outputs (numerator / denominator) agree within
    that rounding (2^-8 of the largest |output|), and both are that close to
    the float64 result on the same values."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((3, 8, 32)).astype(np.float32)
    k = rng.standard_normal((3, 200, 2, 32)).astype(np.float32)
    v = rng.standard_normal((3, 200, 2, 32)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(x).astype(jdt) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    jn, jd, jm = j_layers.decode_attention_local(jq, jk, jv, jnp.int32(100), jnp.int32(250))
    tn, td, tm = layers.decode_attention_local(tq, tk, tv, 100, torch.tensor(250))
    assert tn.dtype == td.dtype == tm.dtype == torch.float32
    if dtype == "float32":
        for got, want in ((tn, jn), (td, jd), (tm, jm)):
            _close(got, np.asarray(want))
        return
    q64, k64, v64 = (t.double().numpy() for t in (tq, tk, tv))
    k64, v64 = (np.repeat(x[:, :150], 4, axis=2) for x in (k64, v64))   # the valid entries
    s64 = np.einsum("bhd,blhd->bhl", q64, k64) / np.sqrt(32)
    w64 = np.exp(s64 - s64.max(-1, keepdims=True))
    exact = np.einsum("bhl,blhd->bhd", w64 / w64.sum(-1, keepdims=True), v64)
    port, ref = (tn / td[..., None]).numpy(), np.asarray(jn / jd[..., None])
    _close(port, ref, rel=2.0 ** -8)
    _close(port, exact, rel=2.0 ** -8)


def test_causal_cross_encoder_gives_every_pair_one_score():
    """A reference-side fact, held in both packages: with the registry's
    qwen3-8b config as it is (``causal=True``), ``score_tokens`` reads the
    [CLS] position, which sees only itself, so every pair scores the same.
    ``replace(cfg, causal=False)`` (the bidirectional CE the docstring
    describes) tells the pairs apart."""
    jcfg = j_registry.smoke_config("qwen3-8b")
    assert jcfg.causal
    cfg = registry.smoke_config("qwen3-8b")
    params = lm_params(cfg, ce=True)
    jparams = jax.tree.map(jnp.asarray, ref_tree(params))
    rng = np.random.default_rng(3)
    pairs = rng.integers(3, jcfg.vocab_size, (6, 20)).astype(np.int32)
    pairs[:, 0] = 1
    want = np.asarray(j_ce.score_tokens(jparams, jnp.asarray(pairs), jcfg))
    got = cross_encoder.score_tokens(params, torch.from_numpy(pairs), cfg,
                                     attn_impl="flash").numpy()
    # one score for every pair: bitwise in the reference here, within fp32
    # rounding in the port (the CPU GEMM may round equal rows apart)
    assert np.ptp(want) <= TOL * np.abs(want).max() and np.ptp(got) <= TOL * np.abs(got).max()
    _close(got, want)
    bidir = cross_encoder.score_tokens(params, torch.from_numpy(pairs),
                                       replace(cfg, causal=False), attn_impl="flash").numpy()
    assert np.ptp(bidir) > 1e3 * TOL * np.abs(bidir).max()
