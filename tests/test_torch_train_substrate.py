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
