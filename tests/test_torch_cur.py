"""The port's CUR primitives against ``repro.core.cur``.

Tolerance: atol 1e-4 on pinv entries of O(0.1) magnitude (LAPACK SVD/LU in
torch and XLA round differently; the bordering update compounds it).  The
duplicate-column case is the one the finite guard exists for: the ridge
solve goes singular, and both packages must stay finite."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # one intra-op thread: the suite runs a process a core
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import cur as jcur  # noqa: E402
from repro_torch.core import cur as tcur  # noqa: E402

ATOL = 1e-4


def _pinv_state(a_full, start, rcond=1e-4):
    p = np.zeros((a_full.shape[0], a_full.shape[2], a_full.shape[1]), np.float32)
    p[:, :start] = np.asarray(jax.vmap(lambda x: jcur.pinv(x, rcond))(
        jnp.asarray(a_full[:, :, :start])))
    return p


@pytest.mark.parametrize("rcond", [1e-6, 1e-4, 1e-2])
def test_pinv_matches(rcond):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 60, 12)).astype(np.float32)
    a[:, :, 5] = a[:, :, 4]                       # rank-deficient
    ref = np.asarray(jcur.pinv(jnp.asarray(a), rcond))
    got = tcur.pinv(torch.from_numpy(a), rcond).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("duplicate", [False, True])
@pytest.mark.parametrize("start", [8, 16])
def test_block_pinv_extend_static_matches(start, duplicate):
    rng = np.random.default_rng(start)
    b_, m, kk, s = 4, 80, 32, 8
    a = rng.standard_normal((b_, m, kk)).astype(np.float32)
    a[:, :, start:] = 0.0
    new = rng.standard_normal((b_, m, s)).astype(np.float32)
    if duplicate:
        new[:, :, 1] = new[:, :, 0]               # two identical new columns
        new[:, :, 2] = a[:, :, 0]                 # and one already present
    p = _pinv_state(a, start)
    ref = np.asarray(jax.vmap(jcur.block_pinv_extend_static, in_axes=(0, 0, 0, None))(
        jnp.asarray(a), jnp.asarray(p), jnp.asarray(new), start))
    got = tcur.block_pinv_extend_static(torch.from_numpy(a), torch.from_numpy(p),
                                        torch.from_numpy(new), start).numpy()
    assert np.isfinite(got).all()
    assert np.isfinite(ref).all()
    assert np.abs(got[:, start + s:]).max() == 0.0       # unfilled rows stay zero
    if duplicate:
        # the guard's contract is finiteness: the singular ridge solve rounds
        # differently in XLA's LU and LAPACK's (which entries go non-finite,
        # which stay finite but huge), and the element-wise fallback then
        # mixes different entries, so values are compared only off that case
        return
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_extend_equals_full_pinv_when_well_conditioned():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((2, 100, 10)).astype(np.float32)
    b = rng.standard_normal((2, 100, 6)).astype(np.float32)
    p = tcur.pinv(torch.from_numpy(a))
    ext = tcur.block_pinv_extend(torch.from_numpy(a), p, torch.from_numpy(b))
    full = tcur.pinv(torch.from_numpy(np.concatenate([a, b], 2)))
    np.testing.assert_allclose(ext.numpy(), full.numpy(), atol=ATOL, rtol=0)


def test_cur_reconstruction_matches():
    """Algorithm 2's ``query_embedding``, ``approx_scores`` and
    ``cur_reconstruction`` against the reference (atol 1e-4 on outputs of
    O(1) magnitude: the pinv's SVD rounds differently in the two
    packages)."""
    rng = np.random.default_rng(3)
    r_anc = rng.standard_normal((40, 300)).astype(np.float32)
    idx = np.stack([rng.choice(300, 12, replace=False) for _ in range(5)]).astype(np.int32)
    c = rng.standard_normal((5, 12)).astype(np.float32)
    cols = np.asarray(jcur.gather_anchor_columns(jnp.asarray(r_anc), jnp.asarray(idx)))
    r_t, idx_t, c_t = torch.from_numpy(r_anc), torch.from_numpy(idx), torch.from_numpy(c)
    np.testing.assert_allclose(
        tcur.query_embedding(torch.from_numpy(cols), c_t).numpy(),
        np.asarray(jcur.query_embedding(jnp.asarray(cols), jnp.asarray(c))), atol=ATOL, rtol=0)
    ref = np.asarray(jcur.approx_scores(jnp.asarray(r_anc), jnp.asarray(c), jnp.asarray(idx)))
    np.testing.assert_allclose(tcur.approx_scores(r_t, c_t, idx_t).numpy(), ref,
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(tcur.cur_reconstruction(r_t, idx_t, c_t).numpy(), ref,
                               atol=ATOL, rtol=0)
