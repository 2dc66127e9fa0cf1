"""The port's training substrate (on the CPU) against the JAX package run
live: ``data/loader.py`` (``ShardedBatcher``, ``Prefetcher``),
``checkpoint/checkpointer.py``'s training trees (async save, ``wait``,
``available_steps``, nested dicts, lists and ``AdamWState``),
``checkpoint/manager.py`` (keep policy, cold and warm resume,
``run_with_recovery``, mirroring ``tests/test_substrate.py``), a training
checkpoint written by either package and resumed by the other, and the
ce-tiny trainer CLI (``launch/train.py``) resumed bit for bit.

Checkpoint leaves and batch ids are held bitwise: both packages write and
read the same bytes, and the loader is numpy on both sides.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # one intra-op thread: the suite runs a process a core
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs.base import RecSysConfig as JRecSysConfig  # noqa: E402
from repro.data.loader import ShardedBatcher as JBatcher  # noqa: E402
from repro.models.recsys import dlrm as j_dlrm  # noqa: E402
from repro.training import optimizer as j_opt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, Checkpointer  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data.loader import Prefetcher, ShardedBatcher  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.training import optimizer  # noqa: E402
from repro_torch.tree import leaves, leaves_with_paths, tree_map  # noqa: E402

ARCH = "dlrm-mlperf"


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((8, 4), generator=g),
            "nested": {"b": torch.arange(5, dtype=torch.float32)},
            "stack": [torch.ones((2, 2)), torch.zeros((3,)),
                      torch.randn((3, 2), generator=g).to(torch.bfloat16)]}


def _assert_same(a, b):
    la, lb = leaves_with_paths(a), leaves_with_paths(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (key, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), key


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,gb,seed,n_hosts", [(4096, 8, 0, 1), (1000, 64, 3, 4),
                                               (257, 16, 7, 2), (64, 64, 1, 8)])
def test_batch_indices_equal_the_reference_across_hosts_and_epochs(n, gb, seed, n_hosts):
    """Every host's ids at every step of three epochs (and the step after
    them) equal the reference's element for element."""
    per_epoch = max(n // gb, 1)
    for host in range(n_hosts):
        mine = ShardedBatcher(n, gb, seed=seed, host_id=host, n_hosts=n_hosts)
        ref = JBatcher(n, gb, seed=seed, host_id=host, n_hosts=n_hosts)
        for step in range(3 * per_epoch + 1):
            a, b = mine.batch_indices(step), ref.batch_indices(step)
            assert a.dtype == b.dtype and np.array_equal(a, b), (host, step)
    with pytest.raises(ValueError, match="divide"):
        ShardedBatcher(n, 3, n_hosts=2)


def test_prefetcher_yields_steps_in_order_from_its_start():
    seen = []
    pf = Prefetcher(lambda s: {"step": s, "x": np.full(3, s)}, depth=2, start_step=5)
    try:
        for step, batch in pf:
            seen.append(step)
            assert batch["step"] == step and (batch["x"] == step).all()
            if len(seen) == 6:
                break
    finally:
        pf.close()
    assert seen == list(range(5, 11))


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------


def test_training_tree_roundtrips_bitwise(tmp_path):
    state = {"params": _state(), "opt": optimizer.init_adamw(_state(1))}
    ck = Checkpointer(str(tmp_path))
    ck.save(7, state)
    out = ck.restore(7, device="cpu", like=state)
    _assert_same(out, state)
    assert isinstance(out["opt"], optimizer.AdamWState)
    manifest = json.load(open(tmp_path / "step_7" / "manifest.json"))["leaves"]
    assert "opt/.mu/stack/2" in manifest and "params/nested/b" in manifest
    assert manifest["opt/.step"]["file"] == "opt__.step.npy"
    assert manifest["params/stack/2"]["dtype"] == "bfloat16"


def test_async_save_then_wait(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=True)
    ck.save(1, _state())
    ck.wait()
    assert ck.available_steps() == [1]
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_async_save_copies_every_leaf_before_it_returns(tmp_path):
    """The optimizer overwrites the parameters in place: what an async save
    writes is the state at ``save``, not what a step made of it while the
    writer ran."""
    state = _state()
    want = tree_map(lambda t: t.clone(), state)
    ck = Checkpointer(str(tmp_path), async_save=True)
    ck.save(3, state)
    for t in leaves(state):
        t.add_(1)
    ck.wait()
    _assert_same(ck.restore(3, device="cpu", like=want), want)


def test_restore_keeps_requires_grad_and_checks_shapes(tmp_path):
    params = steps.require_grad(_state())
    ck = Checkpointer(str(tmp_path))
    ck.save(2, params)
    out = ck.restore(2, device="cpu", like=params)
    assert all(t.requires_grad and t.is_leaf for t in leaves(out))
    with pytest.raises(ValueError, match="shape"):
        ck.restore(2, device="cpu", like={**params, "w": torch.zeros(3)})


def test_manager_keep_policy(tmp_path):
    mgr = CheckpointManager(str(tmp_path), save_every=1, keep=2, async_save=False)
    state = _state()
    for s in range(1, 6):
        mgr.maybe_save(s, state)
    assert mgr.ckpt.available_steps() == [4, 5]
    assert mgr.latest() == 5


def test_resume_cold_and_warm(tmp_path):
    mgr = CheckpointManager(str(tmp_path), save_every=1, keep=3, async_save=False)
    state = _state()
    step, out = mgr.resume(state, "cpu")
    assert step == 0 and out is state
    mgr.maybe_save(2, tree_map(lambda x: x + 1, state))
    step, out = mgr.resume(state, "cpu")
    assert step == 2
    torch.testing.assert_close(out["w"], state["w"] + 1, rtol=0, atol=0)


def test_run_with_recovery_simulated_node_failure(tmp_path):
    """A step that dies mid-run resumes from the last checkpoint and the
    final state matches an uninterrupted run exactly."""
    mgr = CheckpointManager(str(tmp_path), save_every=1, keep=5, async_save=True)
    crashed = {"done": False}

    def step_fn(step, state):
        if step == 3 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("host 17 vanished")
        state["x"].add_(1.0)              # in place, as the train steps update
        return state

    out = mgr.run_with_recovery(step_fn, {"x": torch.zeros(3)}, n_steps=5, device="cpu")
    assert crashed["done"]
    torch.testing.assert_close(out["x"], torch.full((3,), 5.0), rtol=0, atol=0)


def test_run_with_recovery_refuses_a_torn_state(tmp_path):
    """A failure before the first checkpoint leaves nothing to restore (the
    state was updated in place): it re-raises instead of going on."""
    mgr = CheckpointManager(str(tmp_path), save_every=10, keep=5, async_save=False)

    def step_fn(step, state):
        raise RuntimeError("lost at step 0")

    with pytest.raises(RuntimeError, match="lost at step 0"):
        mgr.run_with_recovery(step_fn, {"x": torch.zeros(3)}, n_steps=5, device="cpu")


@pytest.fixture(scope="module")
def dlrm_train_state():
    """A smoke DLRM training state, the reference's and the port's (from
    ``convert``): seeded weights, step 1 and moments made from them."""
    cfg = registry.smoke_config(ARCH)
    jcfg = JRecSysConfig(**dataclasses.asdict(cfg))
    params, _ = j_dlrm.init_dlrm(jax.random.PRNGKey(0), jcfg)
    state = j_opt.AdamWState(jnp.asarray(1, jnp.int32), jax.tree.map(lambda p: 0.1 * p, params),
                             jax.tree.map(lambda p: p * p, params))
    tree = jax.tree.map(np.asarray, {"params": params, "opt": state})
    port = {"params": convert.dlrm_params(tree["params"], device="cpu"),
            "opt": convert.adamw_state(tree["opt"].step, tree["opt"].mu, tree["opt"].nu,
                                       device="cpu")}
    return {"params": params, "opt": state}, port


def test_reference_checkpoint_resumes_in_the_port(tmp_path, dlrm_train_state):
    jstate, port = dlrm_train_state
    JCheckpointer(str(tmp_path), async_save=False).save(1, jstate)
    like = tree_map(torch.zeros_like, port)
    step, out = CheckpointManager(str(tmp_path), save_every=1).resume(like, "cpu")
    assert step == 1
    _assert_same(out, port)
    assert int(out["opt"].step) == 1 and out["opt"].step.dtype == torch.int32


def test_port_checkpoint_resumes_in_the_reference(tmp_path, dlrm_train_state):
    jstate, port = dlrm_train_state
    Checkpointer(str(tmp_path)).save(1, port)
    out = JCheckpointer(str(tmp_path), async_save=False).restore(1, jstate)
    la, lb = jax.tree_util.tree_leaves_with_path(out), jax.tree_util.tree_leaves_with_path(jstate)
    assert len(la) == len(lb) == len(leaves(port))
    for (path, a), (_, b) in zip(la, lb):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), np.asarray(b)), path


# ---------------------------------------------------------------------------
# the ce-tiny trainer
# ---------------------------------------------------------------------------


def _ckpt_leaves(path):
    manifest = json.load(open(os.path.join(path, "manifest.json")))["leaves"]
    return {k: np.load(os.path.join(path, v["file"])) for k, v in manifest.items()}


def test_train_cli_resumes_bit_for_bit_on_the_cpu(tmp_path):
    """``--steps 6`` then ``--steps 10`` from the same directory (resuming
    at 6) ends with the leaves of one 10-step run, bit for bit."""
    common = ["--device", "cpu", "--save-every", "2", "--batch", "4", "--seq", "32"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    train.main([*common, "--steps", "6", "--ckpt-dir", a])
    assert CheckpointManager(a).latest() == 6
    train.main([*common, "--steps", "10", "--ckpt-dir", a])
    train.main([*common, "--steps", "10", "--ckpt-dir", b])
    la, lb = _ckpt_leaves(os.path.join(a, "step_10")), _ckpt_leaves(os.path.join(b, "step_10"))
    assert la.keys() == lb.keys() and "opt/.step" in la
    assert all(np.array_equal(la[k], lb[k]) for k in la)
    assert int(la["opt/.step"]) == 10
    assert {"step_8", "step_10"} <= set(os.listdir(a))


# ---------------------------------------------------------------------------
# LM training checkpoints across the packages
# ---------------------------------------------------------------------------

# ce-tiny in fp32 (the CLI's model holds bf16 weights; fp32 lets the next
# step be held to test_torch_training.py's LM train-step bars: the loss
# within 1e-5 relative, every parameter within 1e-5 of the largest)
CE_FP32 = dataclasses.replace(registry.CE_TINY, dtype="float32")
LM_CKPT_STEPS = 2


@pytest.fixture(scope="module")
def lm_ckpt():
    """ce-tiny (fp32) weights drawn by the port and handed to the reference
    stacked; one batch of 4 x 32 tokens; both packages' jitted / eager
    train steps of the CLI."""
    from repro.configs.base import LMConfig as JLMConfig
    from repro.launch import train as j_train
    from _torch_lm import lm_params, ref_tree

    params = lm_params(CE_FP32, seed=4)
    tokens = np.random.default_rng(5).integers(4, CE_FP32.vocab_size, (4, 32)).astype(np.int32)
    jcfg = JLMConfig(**dataclasses.asdict(CE_FP32))
    opt = dict(lr=3e-4, total_steps=50)
    jstep = j_train.make_lm_train_step(jcfg, j_opt.AdamWConfig(**opt))
    tstep = train.make_lm_train_step(CE_FP32, optimizer.AdamWConfig(**opt))
    jparams = jax.tree.map(jnp.asarray, ref_tree(params))
    return dict(params=params, jparams=jparams, tokens=tokens, jstep=jstep, tstep=tstep)


def _port_state(params):
    p = steps.require_grad(tree_map(lambda t: t.detach().clone(), params))
    return {"params": p, "opt": optimizer.init_adamw(p)}


def _port_steps(state, tokens, n):
    params, opt, losses = state["params"], state["opt"], []
    for _ in range(n):
        params, opt, met = train.make_lm_train_step(CE_FP32, optimizer.AdamWConfig(
            lr=3e-4, total_steps=50))(params, opt, {"tokens": torch.from_numpy(tokens)})
        losses.append(float(met["loss"]))
    return {"params": params, "opt": opt}, losses


def _ref_steps(d, state, n):
    params, opt, losses = state["params"], state["opt"], []
    for _ in range(n):
        params, opt, met = d["jstep"](params, opt, {"tokens": jnp.asarray(d["tokens"])})
        losses.append(float(met["loss"]))
    return {"params": params, "opt": opt}, losses


def _assert_next_step_equal(port_state, ref_state, d):
    """One more step in each package from the restored states: the loss
    within 1e-5 relative, the parameters within 1e-5 of the largest."""
    tstate, tl = _port_steps(port_state, d["tokens"], 1)
    jstate, jl = _ref_steps(d, ref_state, 1)
    assert abs(tl[0] - jl[0]) <= 1e-5 * abs(jl[0]), (tl, jl)
    want = jax.tree.map(np.asarray, jstate["params"])
    got = train.checkpoint_tree(tstate)["params"]
    top = max(float(np.abs(x).max()) for x in leaves(want))
    for (key, a), (_, b) in zip(leaves_with_paths(got), leaves_with_paths(want)):
        assert a.shape == b.shape, key
        assert float(np.abs(a.detach().numpy() - b).max()) <= 1e-5 * top, key
    assert int(tstate["opt"].step) == int(jstate["opt"].step) == LM_CKPT_STEPS + 1


def test_lm_checkpoints_have_the_references_leaves_and_bytes(tmp_path, lm_ckpt):
    """The same ce-tiny state saved by each package: one set of leaf paths
    (the layers stacked: ``params/layers/attn/wq``, ``opt/.mu/layers/...``)
    and every file's bytes equal."""
    d = lm_ckpt
    a, b = str(tmp_path / "port"), str(tmp_path / "ref")
    Checkpointer(a).save(0, train.checkpoint_tree(_port_state(d["params"])))
    JCheckpointer(b, async_save=False).save(
        0, {"params": d["jparams"], "opt": j_opt.init_adamw(d["jparams"])})
    la, lb = _ckpt_leaves(os.path.join(a, "step_0")), _ckpt_leaves(os.path.join(b, "step_0"))
    assert la.keys() == lb.keys() and "params/layers/attn/wq" in la
    for k in la:
        assert la[k].dtype == lb[k].dtype and np.array_equal(la[k], lb[k]), k


def test_lm_checkpoint_of_the_port_resumes_in_the_reference(tmp_path, lm_ckpt):
    """The port trains two steps and saves (``checkpoint_tree``); the
    reference restores that step into its own structure, and both take the
    next step."""
    d = lm_ckpt
    tstate, _ = _port_steps(_port_state(d["params"]), d["tokens"], LM_CKPT_STEPS)
    Checkpointer(str(tmp_path)).save(LM_CKPT_STEPS, train.checkpoint_tree(tstate))
    like = {"params": d["jparams"], "opt": j_opt.init_adamw(d["jparams"])}
    jstate = JCheckpointer(str(tmp_path), async_save=False).restore(LM_CKPT_STEPS, like)
    assert int(jstate["opt"].step) == LM_CKPT_STEPS
    _assert_next_step_equal(tstate, jstate, d)


def test_lm_checkpoint_of_the_reference_resumes_in_the_port(tmp_path, lm_ckpt):
    """The reference trains two steps and saves; the port's CLI resume path
    (``CheckpointManager.resume`` of ``checkpoint_tree``, then
    ``state_from_checkpoint``) restores it, and both take the next step."""
    d = lm_ckpt
    jstate, _ = _ref_steps(d, {"params": d["jparams"], "opt": j_opt.init_adamw(d["jparams"])},
                           LM_CKPT_STEPS)
    JCheckpointer(str(tmp_path), async_save=False).save(LM_CKPT_STEPS, jstate)
    like = train.checkpoint_tree(_port_state(d["params"]))
    step, tree = CheckpointManager(str(tmp_path)).resume(like, "cpu")
    assert step == LM_CKPT_STEPS
    tstate = train.state_from_checkpoint(tree)
    p = tstate["params"]
    assert isinstance(p["layers"], list) and len(p["layers"]) == CE_FP32.n_layers
    assert all(t.requires_grad and t.is_leaf for t in leaves(p))
    _assert_next_step_equal(tstate, jstate, d)
