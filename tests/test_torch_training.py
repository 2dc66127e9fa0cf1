"""The port's training slice (plain versions, on the CPU) against the JAX
package run live: ``training/optimizer.py``, ``transformer.lm_logits``,
``cross_encoder.ranking_loss`` and ``dlrm.bce_loss`` with their gradients,
and the DLRM and LM train steps (``launch/steps.py``,
``launch/train.py::make_lm_train_step``).

Inputs are drawn with numpy from a seed, weights by the JAX package and
carried across by ``convert``; each reference result is computed once per
module.  Bars (fp32 throughout):

- AdamW: parameters and moments within 1e-6 of each leaf's largest
  |value|, ``grad_norm`` and ``lr`` within 1e-6 relative (the same
  elementwise formula; only the global norm's sum runs in another order);
- losses within 1e-5 relative, gradients within 1e-5 of each leaf's
  largest |value| (matrix products summed in another order);
- three train steps: every step's loss within 1e-5 relative, the
  parameters after them within 1e-5 of the largest |value| of any
  parameter.  (Per leaf, the biases that start at zero miss it: after
  three warm-up steps they hold about 6e-5, and where a bias's gradient is
  near Adam's epsilon the normalized step turns fp32 rounding of that
  gradient into 3e-5 of the bias's own largest |value|.)
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # one intra-op thread: the suite runs a process a core
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import LMConfig as JLMConfig, RecSysConfig as JRecSysConfig  # noqa: E402
from repro.configs.shapes import LMShape as JLMShape, RECSYS_SHAPES as J_SHAPES  # noqa: E402
from repro.launch import steps as j_steps, train as j_train  # noqa: E402
from repro.models import cross_encoder as j_ce, transformer as j_tf  # noqa: E402
from repro.models.recsys import dlrm as j_dlrm  # noqa: E402
from repro.training import optimizer as j_opt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import dlrm_mlperf, registry  # noqa: E402
from repro_torch.configs.base import LMConfig, LMShape, RecSysShape  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import cross_encoder, transformer  # noqa: E402
from repro_torch.models.recsys import dlrm  # noqa: E402
from repro_torch.training import optimizer  # noqa: E402
from repro_torch.tree import leaves, leaves_with_paths, tree_map  # noqa: E402

ARCH = "dlrm-mlperf"
# a 2-layer, d = 64 LM in fp32 (vocab 100 padded to 512: the mask is live)
LM = dict(name="lm-test", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
          vocab_size=100, qk_norm=True, causal=False, dtype="float32")
TRAIN_STEPS = 3


def _auto_mesh():
    """A 1 x 1 (data, model) mesh with Auto axes: the reference's train
    builders constrain shardings by PartitionSpec inside the step."""
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _assert_leaves_close(got, want, rel, what=""):
    """Each torch leaf of ``got`` within ``rel`` of the largest |value| of
    the matching numpy leaf of ``want`` (trees in flattening order)."""
    g, w = leaves_with_paths(got), leaves_with_paths(want)
    assert [k for k, _ in g] == [k for k, _ in w], what
    for (key, a), (_, b) in zip(g, w):
        a, b = a.detach().numpy(), np.asarray(b)
        assert a.shape == b.shape, (what, key)
        tol = rel * max(float(np.abs(b).max()), 1e-30)
        assert np.abs(a - b).max() <= tol, (what, key, float(np.abs(a - b).max()), tol)


def _assert_params_close(got, want, rel, what=""):
    """Every torch leaf of ``got`` within ``rel`` x the largest |value| of
    any leaf of ``want``."""
    top = max(float(np.abs(np.asarray(b)).max()) for b in leaves(want))
    g, w = leaves_with_paths(got), leaves_with_paths(want)
    assert [k for k, _ in g] == [k for k, _ in w], what
    for (key, a), (_, b) in zip(g, w):
        d = float(np.abs(a.detach().numpy() - np.asarray(b)).max())
        assert d <= rel * top, (what, key, d, rel * top)


def _rel(a, b):
    a, b = (float(x.detach()) if hasattr(x, "detach") else float(x) for x in (a, b))
    return abs(a - b) / max(abs(b), 1e-30)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def _opt_tree(rng, scale=1.0):
    return {"w": rng.standard_normal((8, 4)).astype(np.float32) * scale,
            "nested": {"b": rng.standard_normal(5).astype(np.float32) * scale},
            "stack": [rng.standard_normal((2, 2)).astype(np.float32) * scale,
                      rng.standard_normal(3).astype(np.float32) * scale]}


# name -> (AdamWConfig kwargs, gradient scale, steps, grad transform)
OPT_CASES = {
    "one_step": (dict(), 0.01, 1, False),
    "three_clipped_steps": (dict(warmup_steps=2, total_steps=10), 10.0, 3, False),
    "no_clip_no_decay_transform": (dict(clip_norm=0.0, weight_decay=0.0), 1.0, 2, True),
}


@pytest.fixture(scope="module")
def opt_runs():
    out = {}
    for name, (kw, gscale, n, transform) in OPT_CASES.items():
        rng = np.random.default_rng(sorted(OPT_CASES).index(name))
        p0 = _opt_tree(rng)
        grads = [_opt_tree(rng, gscale) for _ in range(n)]
        jcfg, tcfg = j_opt.AdamWConfig(**kw), optimizer.AdamWConfig(**kw)
        jhook = (lambda g: jax.tree.map(lambda x: 0.5 * x, g)) if transform else None
        thook = (lambda g: tree_map(lambda x: 0.5 * x, g)) if transform else None
        jp, js = jax.tree.map(jnp.asarray, p0), j_opt.init_adamw(jax.tree.map(jnp.asarray, p0))
        tp = _t(p0)
        ts = optimizer.init_adamw(tp)
        mu_obj, jm, tm = ts.mu, [], []
        for g in grads:
            jp, js, jmet = j_opt.adamw_update(jcfg, jp, jax.tree.map(jnp.asarray, g), js, jhook)
            tp, ts, tmet = optimizer.adamw_update(tcfg, tp, _t(g), ts, thook)
            jm.append(jmet)
            tm.append(tmet)
        out[name] = dict(jp=_np_tree(jp), js=js, tp=tp, ts=ts, jm=jm, tm=tm, p0=p0,
                         mu_obj=mu_obj)
    return out


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_adamw_update_matches_jax(opt_runs, case):
    r = opt_runs[case]
    _assert_leaves_close(r["tp"], r["jp"], 1e-6, "params")
    _assert_leaves_close(r["ts"].mu, _np_tree(r["js"].mu), 1e-6, "mu")
    _assert_leaves_close(r["ts"].nu, _np_tree(r["js"].nu), 1e-6, "nu")
    assert int(r["ts"].step) == int(r["js"].step) == len(r["jm"])
    assert r["ts"].step.dtype == torch.int32 and r["ts"].step.dim() == 0
    for jmet, tmet in zip(r["jm"], r["tm"]):
        assert _rel(tmet["grad_norm"], jmet["grad_norm"]) <= 1e-6
        assert _rel(tmet["lr"], jmet["lr"]) <= 1e-6


def test_adamw_clips_in_the_clipped_case(opt_runs):
    """The clipped case's gradients are far above the clip norm, so the
    clip is live in every step (the norm reported is the pre-clip one)."""
    r = opt_runs["three_clipped_steps"]
    assert all(float(m["grad_norm"]) > 10 * 1.0 for m in r["jm"])


def test_adamw_updates_in_place(opt_runs):
    """The port overwrites the parameters and moments it is given (the
    reference returns new arrays): the trees it returns are the same
    tensors."""
    r = opt_runs["one_step"]
    assert r["ts"].mu is r["mu_obj"]
    assert not np.array_equal(r["tp"]["w"].numpy(), r["p0"]["w"])


@pytest.mark.parametrize("step", [0, 1, 9, 10, 11, 29, 49, 50, 51, 80])
def test_cosine_schedule_matches_jax_at_the_warmup_edges(step):
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=50, min_lr_frac=0.1)
    want = j_opt.cosine_schedule(j_opt.AdamWConfig(**kw), jnp.asarray(step, jnp.int32))
    got = optimizer.cosine_schedule(optimizer.AdamWConfig(**kw),
                                    torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    assert _rel(got, want) <= 1e-6 or float(want) == float(got) == 0.0


def test_accumulate_grads_matches_jax_over_four_microbatches():
    rng = np.random.default_rng(3)
    p = {"w": rng.standard_normal((6, 3)).astype(np.float32),
         "b": rng.standard_normal(3).astype(np.float32)}
    mb = {"x": rng.standard_normal((4, 8, 6)).astype(np.float32),
          "y": rng.standard_normal((4, 8, 3)).astype(np.float32)}

    def j_loss(q, m):
        return jnp.mean((jnp.tanh(m["x"] @ q["w"]) + q["b"] - m["y"]) ** 2)

    def t_loss(q, m):
        return torch.mean((torch.tanh(m["x"] @ q["w"]) + q["b"] - m["y"]) ** 2)

    jg, jl = j_opt.accumulate_grads(j_loss, jax.tree.map(jnp.asarray, p),
                                    jax.tree.map(jnp.asarray, mb), 4)
    tp = tree_map(lambda x: x.requires_grad_(), _t(p))
    tg, tl = optimizer.accumulate_grads(t_loss, tp, _t(mb), 4)
    _assert_leaves_close(tg, _np_tree(jg), 1e-6, "grads")
    assert _rel(tl, jl) <= 1e-6


def test_global_norm_and_clip_match_jax():
    rng = np.random.default_rng(4)
    g = _opt_tree(rng, 3.0)
    jc, jn = j_opt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    tc, tn = optimizer.clip_by_global_norm(_t(g), 1.0)
    assert _rel(tn, jn) <= 1e-6
    assert _rel(optimizer.global_norm(_t(g)), j_opt.global_norm(g)) <= 1e-6
    _assert_leaves_close(tc, _np_tree(jc), 1e-6, "clipped")


# ---------------------------------------------------------------------------
# losses and their gradients
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lm():
    jcfg, tcfg = JLMConfig(**LM), LMConfig(**LM)
    jparams = jax.jit(lambda k: j_tf.init_lm(k, jcfg)[0])(jax.random.PRNGKey(0))
    tree = _np_tree(jparams)
    return dict(jcfg=jcfg, cfg=tcfg, jparams=jparams, tree=tree)


def _lm_params(lm):
    return steps.require_grad(convert.cross_encoder_params(lm["tree"], device="cpu"))


def test_lm_logits_and_gradient_match_jax(lm):
    rng = np.random.default_rng(5)
    hidden = rng.standard_normal((2, 7, LM["d_model"])).astype(np.float32)
    w = rng.standard_normal((2, 7, LM["vocab_size"])).astype(np.float32)

    def j_obj(params, h):
        return jnp.sum(j_tf.lm_logits(params, h, lm["jcfg"])[..., :LM["vocab_size"]] * w)

    jl = np.asarray(j_tf.lm_logits(lm["jparams"], jnp.asarray(hidden), lm["jcfg"]))
    jgp, jgh = jax.grad(j_obj, argnums=(0, 1))(lm["jparams"], jnp.asarray(hidden))
    params = _lm_params(lm)
    h = torch.from_numpy(hidden).requires_grad_()
    tl = transformer.lm_logits(params, h, lm["cfg"])
    assert tl.shape == jl.shape == (2, 7, transformer.padded_vocab(lm["cfg"]))
    assert (tl[..., LM["vocab_size"]:] == -1e30).all()
    assert np.array_equal(jl[..., LM["vocab_size"]:], tl[..., LM["vocab_size"]:].detach().numpy())
    _assert_leaves_close(tl[..., :LM["vocab_size"]], jl[..., :LM["vocab_size"]], 1e-5)
    (tl[..., :LM["vocab_size"]] * torch.from_numpy(w)).sum().backward()
    _assert_leaves_close(h.grad, np.asarray(jgh), 1e-5, "d hidden")
    _assert_leaves_close(params["lm_head"].grad, np.asarray(jgp["lm_head"]), 1e-5, "d lm_head")


def test_ranking_loss_and_gradient_match_jax(lm):
    """The CE ranking loss through the ``ref`` attention path, with every
    parameter's gradient (the reference's stacked layers unstacked by
    ``convert``)."""
    jparams = jax.jit(lambda k: j_ce.init_cross_encoder(k, lm["jcfg"])[0])(
        jax.random.PRNGKey(1))
    rng = np.random.default_rng(6)
    toks = rng.integers(4, LM["vocab_size"], (3, 4, 12)).astype(np.int32)
    toks[:, :, 9:] = 0                       # trailing padding
    toks[1, 2, 6:] = 0
    jl, jg = jax.jit(jax.value_and_grad(lambda p, t: j_ce.ranking_loss(p, t, lm["jcfg"])))(
        jparams, jnp.asarray(toks))
    params = steps.require_grad(convert.cross_encoder_params(_np_tree(jparams), device="cpu"))
    tl = cross_encoder.ranking_loss(params, torch.from_numpy(toks), lm["cfg"])
    tl.backward()
    assert _rel(tl, jl) <= 1e-5
    # lm_head takes no part in a CE score: no gradient in the port, zeros in JAX
    _assert_leaves_close(tree_map(lambda p: torch.zeros_like(p) if p.grad is None else p.grad,
                                  params),
                         _np_tree(convert.cross_encoder_params(_np_tree(jg), device="cpu")),
                         1e-5, "d params")


def _jrcfg(cfg):
    return JRecSysConfig(**dataclasses.asdict(cfg))


def _dlrm_batch(cfg, b, seed):
    rng = np.random.default_rng(seed)
    return {"dense": rng.standard_normal((b, cfg.n_dense)).astype(np.float32),
            "sparse": rng.integers(0, 2 ** 31, (b, cfg.n_sparse)).astype(np.int32),
            "labels": rng.integers(0, 2, b).astype(np.float32)}


def test_bce_loss_and_gradient_match_jax():
    """The smoke DLRM's BCE and the gradient of every leaf, the tables'
    through the bag op's autograd function (its plain backward here)."""
    cfg = registry.smoke_config(ARCH)
    jcfg = _jrcfg(cfg)
    jparams = jax.jit(lambda k: j_dlrm.init_dlrm(k, jcfg)[0])(jax.random.PRNGKey(2))
    b = _dlrm_batch(cfg, 48, 7)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, d, s, y: j_dlrm.bce_loss(p, d, s, y, jcfg)))(jparams, b["dense"], b["sparse"],
                                                                b["labels"])
    params = steps.require_grad(convert.dlrm_params(_np_tree(jparams), device="cpu"))
    tb = _t(b)
    tl = dlrm.bce_loss(params, tb["dense"], tb["sparse"], tb["labels"], cfg)
    tl.backward()
    assert _rel(tl, jl) <= 1e-5
    grads = tree_map(lambda p: p.grad, params)
    _assert_leaves_close(grads, _np_tree(jg), 1e-5, "d params")
    assert all(float(g.abs().sum()) > 0 for g in grads["tables"])


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------


def _run_reference(step, params, state, batch, mesh):
    losses = []
    with jax.set_mesh(mesh):
        fn = jax.jit(step)
        for _ in range(TRAIN_STEPS):
            params, state, met = fn(params, state, batch)
            losses.append(float(met["loss"]))
    return _np_tree(params), losses


def _run_port(step, params, state, batch):
    losses = []
    for _ in range(TRAIN_STEPS):
        params, state, met = step(params, state, batch)
        losses.append(float(met["loss"]))
    return params, state, losses


@pytest.fixture(scope="module")
def recsys_train():
    """Full-width ``dlrm-mlperf`` with tables capped at 2^10 rows, B = 64:
    the reference's ``build_recsys_train`` step (jitted on a 1 x 1 mesh) and
    the port's, three steps each from the same weights and batch."""
    cfg = dlrm_mlperf.capped(max_rows=1 << 10)
    jcfg = _jrcfg(cfg)
    mesh = _auto_mesh()
    jshape = dataclasses.replace(J_SHAPES["train_batch"], batch=64)
    bundle = j_steps.build_recsys_train(ARCH, jcfg, jshape, mesh)
    jparams, _ = j_dlrm.init_dlrm(jax.random.PRNGKey(0), jcfg)
    batch = _dlrm_batch(cfg, 64, 8)
    tree = _np_tree(jparams)
    jp, jl = _run_reference(bundle.step, jparams, j_opt.init_adamw(jparams),
                            jax.tree.map(jnp.asarray, batch), mesh)
    tb = steps.build_recsys_train(ARCH, cfg, RecSysShape("train_batch", "train", 64),
                                  params=convert.dlrm_params(tree, device="cpu"))
    params, state, _ = tb.args
    tp, ts, tl = _run_port(tb.step, params, state, _t(batch))
    return dict(jp=jp, jl=jl, tp=tp, ts=ts, tl=tl, bundle=tb, jbundle=bundle, cfg=cfg)


def test_recsys_train_steps_match_jax(recsys_train):
    r = recsys_train
    for tl, jl in zip(r["tl"], r["jl"]):
        assert _rel(tl, jl) <= 1e-5, (r["tl"], r["jl"])
    _assert_params_close(r["tp"], r["jp"], 1e-5, "params")
    assert int(r["ts"].step) == TRAIN_STEPS
    assert r["tl"][-1] < r["tl"][0]


def test_recsys_train_bundle_counts_three_forwards(recsys_train):
    """``model_flops`` is the reference's: 3 x the forward's at the batch."""
    r = recsys_train
    assert r["bundle"].model_flops == r["jbundle"].model_flops
    assert r["bundle"].model_flops == 3.0 * steps.recsys_flops(r["cfg"], 64)
    assert all(p.requires_grad and p.grad is None for p in leaves(r["tp"]))


@pytest.fixture(scope="module")
def lm_train(lm):
    """The reference's ``build_lm_train`` (jitted on a 1 x 1 mesh) and
    ``launch/train.py::make_lm_train_step`` against the port's, three steps
    each on one batch of 4 sequences of 32 tokens."""
    rng = np.random.default_rng(9)
    tokens = rng.integers(4, LM["vocab_size"], (4, 32)).astype(np.int32)
    batch = {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1)}
    jbatch = jax.tree.map(jnp.asarray, batch)
    mesh = _auto_mesh()
    shape = dict(name="train_small", kind="train", seq_len=32, global_batch=4)
    jb = j_steps.build_lm_train("lm-test", lm["jcfg"], JLMShape(**shape), mesh)
    jparams, jstate = lm["jparams"], j_opt.init_adamw(lm["jparams"])
    out = {"builder": _run_reference(jb.step, jparams, jstate, jbatch, mesh),
           "cli": _run_reference(j_train.make_lm_train_step(lm["jcfg"], j_opt.AdamWConfig()),
                                 jparams, jstate, jbatch, mesh)}
    port = {}
    for name, n_micro in (("builder", 1), ("builder_micro2", 2)):
        b = steps.build_lm_train("lm-test", lm["cfg"], LMShape(**shape),
                                 params=_lm_params(lm), n_micro=n_micro, device="cpu")
        port[name] = (b, _run_port(b.step, b.args[0], b.args[1], _t(batch)))
    params = _lm_params(lm)
    port["cli"] = (None, _run_port(train.make_lm_train_step(lm["cfg"], optimizer.AdamWConfig()),
                                   params, optimizer.init_adamw(params), _t(batch)))
    return dict(ref=out, port=port, jbundle=jb)


@pytest.mark.parametrize("run", ["builder", "builder_micro2", "cli"])
def test_lm_train_steps_match_jax(lm_train, run):
    """``builder_micro2`` runs the port's builder with two microbatches
    (``accumulate_grads``) against the reference's one: the mean of the two
    halves' mean losses is the whole batch's mean."""
    jp, jl = lm_train["ref"]["cli" if run == "cli" else "builder"]
    _, (tp, ts, tl) = lm_train["port"][run]
    for a, b in zip(tl, jl):
        assert _rel(a, b) <= 1e-5, (tl, jl)
    want = tree_map(lambda t: t.numpy(), convert.cross_encoder_params(jp, device="cpu"))
    _assert_params_close(tp, want, 1e-5, run)
    assert int(ts.step) == TRAIN_STEPS


def test_lm_train_bundle_counts_six_n_d(lm_train):
    b, _ = lm_train["port"]["builder"]
    assert b.model_flops == lm_train["jbundle"].model_flops == 6.0 * LMConfig(**LM).n_params() * 4 * 32
