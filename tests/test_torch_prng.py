"""The port's threefry against ``jax.random`` and the blocked Gumbel field
against ``repro.core.sampling.blocked_gumbel``.

Integer bits, ``uniform`` and ``randint`` must be bit-equal; ``normal``
within ``NORMAL_MAX_ULP`` of JAX's draw, and bit-equal in all but
``NORMAL_MAX_DIFFERING`` of them (XLA's CPU sqrt in the erf_inv tail);
Gumbel values agree within atol 1e-6 (bits are equal up to the final two
``log`` calls, which torch and XLA round differently).  The port's
``make_synthetic_ce`` then builds the reference's domain from the same
key."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # one intra-op thread: the suite runs a process a core
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import sampling as jsampling  # noqa: E402
from repro_torch.core import prng, sampling  # noqa: E402

GUMBEL_ATOL = 1e-6
SEEDS = [0, 42, 2**31 - 1]


def _jraw(key):
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_bits_exact(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert np.array_equal(_jraw(jk), tk.numpy())
    assert np.array_equal(_jraw(jax.random.split(jk, 7)), prng.split(tk, 7).numpy())
    for d in (0, 1, 12345, 2**32 - 1):
        assert np.array_equal(_jraw(jax.random.fold_in(jk, d)), prng.fold_in(tk, d).numpy())
    bits = np.asarray(jax.random.bits(jk, (3, 333))).astype(np.int64)
    assert np.array_equal(bits, prng.random_bits(tk, (3, 333)).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_exact_gumbel_close(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert np.array_equal(np.asarray(jax.random.uniform(jk, (5, 401))),
                          prng.uniform(tk, (5, 401)).numpy())
    g = np.asarray(jax.random.gumbel(jk, (4000,)))
    np.testing.assert_allclose(prng.gumbel(tk, (4000,)).numpy(), g, rtol=0, atol=GUMBEL_ATOL)


@pytest.mark.parametrize("rows,n,row_off,col_off", [
    (3, 300, 0, 0), (5, 129, 7, 256), (2, 1000, 100, 128 * 9),
])
def test_blocked_gumbel_matches_reference(rows, n, row_off, col_off):
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jsampling.blocked_gumbel(key, rows, n, row_off, col_off))
    got = sampling.blocked_gumbel(prng.key_data(np.asarray(key)), rows, n, row_off, col_off)
    assert got.shape == (rows, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=GUMBEL_ATOL)


def test_blocked_gumbel_chunking_is_invisible(monkeypatch):
    key = prng.PRNGKey(5)
    full = sampling.blocked_gumbel(key, 6, 700)
    monkeypatch.setattr(prng, "_CHUNK", 1000)       # one row per chunk
    assert torch.equal(sampling.blocked_gumbel(key, 6, 700), full)


def test_stable_topk_is_index_stable():
    from repro_torch.kernels.approx_topk.select import stable_topk

    v, i = stable_topk(torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, 1.0]]), 6)
    assert i.tolist() == [[1, 2, 4, 3, 0, 5]]
    _, i = stable_topk(torch.zeros(2, 5000), 5)
    assert i.tolist() == [[0, 1, 2, 3, 4]] * 2
    x = jnp.asarray(np.random.default_rng(0).integers(0, 4, (4, 300)).astype(np.float32))
    jv, ji = jax.lax.top_k(x, 40)
    tv, ti = stable_topk(torch.from_numpy(np.array(x)), 40)
    assert np.array_equal(np.asarray(ji), ti.numpy())
    assert np.array_equal(np.asarray(jv), tv.numpy())


@pytest.mark.parametrize("low, high", [(0, 25), (0, 10**6), (-3, 100_000), (5, 7), (4, 4)])
def test_randint_bit_equal(low, high):
    for seed in (0, 3):
        want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (100_000,), low, high))
        got = prng.randint(prng.PRNGKey(seed), (100_000,), low, high)
        assert got.dtype == torch.int32
        assert np.array_equal(want, got.numpy())


# XLA's CPU sqrt (the erf_inv tail, |u| > 0.9966) is not correctly rounded:
# 20 of 10^6 draws under key 3 differed, by at most 2 ulp, on an x86 CPU
NORMAL_MAX_ULP = 4
NORMAL_MAX_DIFFERING = 1e-4


def _ulp_distance(a, b):
    ia, ib = (np.asarray(x, np.float32).view(np.int32).astype(np.int64) for x in (a, b))
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


@pytest.mark.parametrize("seed", [3, 0])
def test_normal_follows_jax_within_the_stated_ulp(seed):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (200_000,)))
    got = prng.normal(prng.PRNGKey(seed), (200_000,)).numpy()
    d = _ulp_distance(want, got)
    assert d.max() <= NORMAL_MAX_ULP, d.max()
    assert (d > 0).mean() <= NORMAL_MAX_DIFFERING, (d > 0).sum()
    # every draw that differs lies in the tail where XLA's sqrt is used
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    u = prng.uniform(prng.PRNGKey(seed), (200_000,), lo, 1.0).numpy()
    assert (np.abs(u[d > 0]) > 0.9966).all()
    # the log1p and log XLA emits, on their own, are reproduced bit for bit
    x = -(u * u)
    assert np.array_equal(np.asarray(jnp.log1p(jnp.asarray(x))),
                          prng.xla_log1p(torch.from_numpy(x)).numpy())


def test_synthetic_domain_is_the_reference_domain():
    from repro.data.synthetic import make_synthetic_ce as j_make
    from repro_torch.data.synthetic import make_synthetic_ce as t_make

    jce = j_make(jax.random.PRNGKey(0), n_queries=60, n_items=1500)
    tce = t_make(prng.PRNGKey(0), n_queries=60, n_items=1500, device="cpu")
    for name in ("q_emb", "mix_a", "mix_b", "mix_w"):
        assert np.array_equal(np.asarray(getattr(jce, name)), getattr(tce, name).numpy()), name
    np.testing.assert_allclose(tce.i_emb.numpy(), np.asarray(jce.i_emb), rtol=0, atol=1e-6)
    want = np.asarray(jce.full_matrix(jnp.arange(60)))
    got = tce.full_matrix(torch.arange(60)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    top = lambda m: np.argsort(-m, axis=1, kind="stable")[:, :10]
    assert np.array_equal(top(want), top(got))


@pytest.mark.parametrize("n", [10, 2000, 100003])
def test_permutation_and_choice_bit_equal(n):
    """``permutation`` (JAX's ``_shuffle``: rounds of stable sorts by fresh
    32-bit keys; two rounds at n = 100,003) and ``choice(replace=False)``,
    its prefix, equal ``jax.random``'s ids exactly."""
    for seed in (0, 7):
        jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
        ref = np.asarray(jax.random.permutation(jk, n))
        assert np.array_equal(prng.permutation(tk, n).numpy(), ref)
        k = min(n, 100)
        ref = np.asarray(jax.random.choice(jk, n, shape=(k,), replace=False))
        assert np.array_equal(prng.choice(tk, n, (k,), replace=False).numpy(), ref)
