"""The port's MoE FFN (``models/moe.py``, plain PyTorch, on the CPU) against
the JAX package's ``_route`` and ``moe_apply_local`` run live (the LM
loss's MoE aux term is in ``tests/test_torch_lm_steps.py``).

Parameters and tokens are numpy draws handed to both.  The router is
built so that (a) expert 0 draws most tokens, which overflows its capacity
at the default ``capacity_factor`` 1.25 (the test checks that assignments
do drop), and (b) experts 2 and 3 have identical router columns, so every
token's probabilities for them tie exactly and the lower id must win, as
``lax.top_k`` decides.  Bars (fp32): routing ids and the aux loss exact
(the same fp32 softmax and counts), outputs within 1e-5 of the largest
|value| (the same products, the combine summed in slot order in both).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # one intra-op thread: the suite runs a process a core
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.models import moe  # noqa: E402

# the reference's MoE jitted once per (config, capacity): op-by-op it
# compiles every small XLA op of the dispatch
J_MOE = jax.jit(j_moe.moe_apply_local, static_argnums=(2, 3))
J_ROUTE = jax.jit(j_moe._route, static_argnums=2)
T, D = 96, 32
CFG = dict(n_experts=4, top_k=2, d_expert=48, n_shared_experts=1)
TOL = 1e-5


def _params(seed=0):
    rng = np.random.default_rng(seed)
    e, f = CFG["n_experts"], CFG["d_expert"]
    router = rng.standard_normal((D, e)).astype(np.float32) / np.sqrt(D)
    router[:, 3] = router[:, 2]                     # experts 2 and 3 always tie
    w = lambda *s: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32)  # noqa: E731
    return {"router": router, "wg": w(e, D, f), "wu": w(e, D, f), "wd": w(e, f, D),
            "shared": {"wg": w(D, f), "wu": w(D, f), "wd": w(f, D)}}


def _tokens(seed=1):
    x = np.random.default_rng(seed).standard_normal((T, D)).astype(np.float32)
    return x


@pytest.fixture(scope="module")
def case():
    params = _params()
    x = _tokens()
    # a shared direction that the router maps onto expert 0: most tokens pick it
    params["router"][:, 0] += 3.0 * x.mean(0) / np.linalg.norm(x.mean(0)) ** 2
    return params, x


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    assert np.abs(got - want).max() <= TOL * np.abs(want).max(), (what, np.abs(got - want).max())


def test_routing_matches_with_ties_to_the_lower_expert(case):
    params, x = case
    cfg, jcfg = MoEConfig(**CFG), JMoEConfig(**CFG)
    je, jp, jaux = J_ROUTE({k: jnp.asarray(v) for k, v in params.items() if k != "shared"},
                           jnp.asarray(x), jcfg)
    te, tp, taux = moe._route(_torch(params), torch.from_numpy(x), cfg)
    assert np.array_equal(te.numpy(), np.asarray(je))
    _close(tp.numpy(), np.asarray(jp), "weights")
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)
    # the tie is live: where only one of experts 2 and 3 fits in the top 2,
    # it is 2; where both fit, 2 comes first
    rows = te.numpy().tolist()
    assert any(2 in r and 3 not in r for r in rows)
    assert not any(3 in r and 2 not in r for r in rows)
    assert all(r.index(2) < r.index(3) for r in rows if 3 in r)


@pytest.mark.parametrize("capacity_factor", [None, 8.0], ids=["default", "generous"])
def test_moe_apply_local_matches(case, capacity_factor):
    """Default capacity drops assignments (checked: expert 0 is over its
    capacity); a generous one drops none.  Either way the port keeps and
    drops exactly the reference's assignments: the outputs agree."""
    params, x = case
    cfg, jcfg = MoEConfig(**CFG), JMoEConfig(**CFG)
    top_e, _, _ = moe._route(_torch(params), torch.from_numpy(x), cfg)
    load = torch.bincount(top_e.reshape(-1), minlength=CFG["n_experts"])
    cap = moe._capacity(T, cfg, capacity_factor or cfg.capacity_factor)
    assert cap == j_moe._capacity(T, jcfg, capacity_factor or jcfg.capacity_factor)
    drops = int((load - cap).clamp_min(0).sum())
    assert (drops > 0) == (capacity_factor is None), (load.tolist(), cap)
    jy, jaux = J_MOE(jax.tree.map(jnp.asarray, params), jnp.asarray(x), jcfg, capacity_factor)
    ty, taux = moe.moe_apply_local(_torch(params), torch.from_numpy(x), cfg, capacity_factor)
    _close(ty.numpy(), np.asarray(jy), "y")
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)


def test_dropped_assignments_contribute_nothing(case):
    """Without shared experts, a token whose every assignment dropped comes
    out as zeros in both packages, and the rest match."""
    params, x = case
    params = {k: v for k, v in params.items() if k != "shared"}
    cfg = dict(CFG, n_shared_experts=0)
    jy, _ = J_MOE(jax.tree.map(jnp.asarray, params), jnp.asarray(x), JMoEConfig(**cfg), 0.3)
    ty, _ = moe.moe_apply_local(_torch(params), torch.from_numpy(x), MoEConfig(**cfg), 0.3)
    zero_rows = ~np.asarray(jy).any(axis=1)
    assert zero_rows.any()
    assert np.array_equal(~ty.numpy().any(axis=1), zero_rows)
    _close(ty.numpy(), np.asarray(jy))


def test_bf16_moe_is_close_and_deterministic(case):
    """bf16 weights and tokens (the full-width serving dtype): two calls
    give the same bits, and the result is within bf16 rounding of the fp32
    computation on the same (rounded) inputs."""
    params, x = case
    cfg = MoEConfig(**CFG)
    p16 = {k: (v if k == "router" else
               {n: torch.from_numpy(w).bfloat16() for n, w in v.items()} if isinstance(v, dict)
               else torch.from_numpy(v).bfloat16()) for k, v in params.items()}
    p16["router"] = torch.from_numpy(params["router"])
    x16 = torch.from_numpy(x).bfloat16()
    a, _ = moe.moe_apply_local(p16, x16, cfg, 8.0)
    b, _ = moe.moe_apply_local(p16, x16, cfg, 8.0)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    p32 = {k: ({n: w.float() for n, w in v.items()} if isinstance(v, dict) else v.float())
           for k, v in p16.items()}
    ref, _ = moe.moe_apply_local(p32, x16.float(), cfg, 8.0)
    err = (a.float() - ref).abs().max().item()
    assert err <= 3 * 2 ** -8 * ref.abs().max().item()
