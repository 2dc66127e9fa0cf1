"""The port's threefry against ``jax.random`` and the blocked Gumbel field
against ``repro.core.sampling.blocked_gumbel``.

Integer bits and ``uniform`` must be bit-equal; Gumbel values agree within
atol 1e-6 (bits are equal up to the final two ``log`` calls, which torch and
XLA round differently)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
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
