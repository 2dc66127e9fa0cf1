"""The port's embedding bag (its plain PyTorch version, on the CPU) against
the JAX package: the Pallas kernel ``_bag_kernel`` in interpret mode, as
``tests/test_kernels.py`` runs it, and the jnp oracle
``embedding_bag_reference``.

Inputs are drawn with numpy and handed to both packages.  The interpret-mode
kernel steps once per (bag, id), so it runs only at B·H <= 64 (the shapes of
``tests/test_kernels.py::TestEmbeddingBag``); larger shapes go against the
oracle.  Tolerances: fp32 ``atol = rtol = 1e-5``, the reference tests' own;
bf16 ``rtol = 2^-7, atol = 1e-6``, one bf16 ulp (both sides accumulate in
fp32 and round once); a bag of one id is a copy of its row and must be
bitwise equal.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # one intra-op thread: the suite runs a process a core
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.embedding_bag.ops import embedding_bag_op as j_bag  # noqa: E402
from repro.kernels.embedding_bag.ref import embedding_bag_reference as j_ref  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.embedding_bag import ref  # noqa: E402
from repro_torch.kernels.embedding_bag.kernel import (  # noqa: E402
    embedding_bag_backward_cuda, embedding_bag_cuda)
from repro_torch.kernels.embedding_bag.ops import embedding_bag_op  # noqa: E402
from repro_torch.kernels.embedding_bag.ref import embedding_bag_plain  # noqa: E402

TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=1e-6, rtol=2.0 ** -7)}


def _inputs(rows, dim, b, h, dtype, seed=0, low=0):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((rows, dim)).astype(np.float32)
    ids = rng.integers(low, rows, (b, h)).astype(np.int32)
    jt = jnp.asarray(table).astype(getattr(jnp, dtype))
    tt = torch.from_numpy(table).to(getattr(torch, dtype))
    return jt, tt, ids


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if isinstance(x, jax.Array) \
        else x.float().numpy()


@pytest.mark.parametrize("rows,dim,b,h,mode,dtype", [
    (1000, 128, 8, 4, "sum", "float32"),
    (500, 64, 16, 3, "mean", "float32"),
    (100, 256, 3, 1, "sum", "float32"),
    (200, 64, 4, 5, "sum", "bfloat16"),
    (200, 64, 4, 5, "mean", "bfloat16"),
    (300, 40, 6, 7, "mean", "float32"),
])
def test_plain_matches_the_pallas_kernel(rows, dim, b, h, mode, dtype):
    jt, tt, ids = _inputs(rows, dim, b, h, dtype, seed=rows)
    want = j_bag(jt, jnp.asarray(ids), mode=mode, interpret=True)
    got = embedding_bag_plain(tt, torch.from_numpy(ids), mode)
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, dim)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_the_oracle_on_wide_bags(mode, dtype):
    jt, tt, ids = _inputs(5000, 128, 256, 32, dtype, seed=1)
    got = embedding_bag_plain(tt, torch.from_numpy(ids), mode)
    # the oracle over the fp32 table, rounded once: fp32 accumulation
    want = j_ref(jt.astype(jnp.float32), jnp.asarray(ids), mode).astype(jt.dtype)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_id_bags_are_bitwise_copies(dtype):
    jt, tt, ids = _inputs(4096, 128, 64, 1, dtype, seed=2)
    got = embedding_bag_plain(tt, torch.from_numpy(ids), "sum")
    want_k = j_bag(jt, jnp.asarray(ids), mode="sum", interpret=True)
    want_r = j_ref(jt, jnp.asarray(ids), "sum")
    assert np.array_equal(_np(got), _np(want_k))
    assert np.array_equal(_np(got), _np(want_r))
    assert torch.equal(embedding_bag_plain(tt, torch.from_numpy(ids), "mean"), got)


def test_duplicate_ids_add_up():
    jt, tt, ids = _inputs(50, 32, 4, 6, "float32", seed=3)
    ids[0] = 7                       # one row six times
    ids[1, :3] = ids[1, 3:]          # each id twice
    want = j_bag(jt, jnp.asarray(ids), mode="sum", interpret=True)
    got = embedding_bag_plain(tt, torch.from_numpy(ids), "sum")
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])
    np.testing.assert_allclose(got[0].numpy(), 6 * tt[7].numpy(), rtol=1e-6)


def test_ids_follow_jnp_take():
    """An id in [-rows, 0) wraps once; one outside [-rows, rows) reads as a
    row of NaN, as ``jnp.take`` (the oracle's gather) fills it."""
    jt, tt, _ = _inputs(20, 16, 1, 1, "float32", seed=4)
    ids = np.array([[3, -1], [-20, 5], [20, 1], [-21, 0]], dtype=np.int32)
    got = embedding_bag_plain(tt, torch.from_numpy(ids), "sum").numpy()
    want = np.asarray(j_ref(jt, jnp.asarray(ids), "sum"))
    np.testing.assert_allclose(got[:2], want[:2], **TOL["float32"])
    assert np.isnan(got[2:]).all() and np.isnan(want[2:]).all()


@pytest.mark.parametrize("np_dtype", [np.int64, np.int16, np.uint8])
def test_id_dtypes_agree(np_dtype):
    """The plain version and the kernel's wrapper take the same ids: int32,
    the reference kernel's id type; both refuse any other integer type."""
    _, tt, ids = _inputs(200, 24, 10, 5, "float32", seed=5)
    other = torch.from_numpy(ids.astype(np_dtype))
    for fn in (embedding_bag_plain, embedding_bag_cuda):
        with pytest.raises(ValueError, match="int32"):
            fn(tt, other, "mean")


def test_op_runs_the_plain_version_on_cpu_tensors():
    _, tt, ids = _inputs(64, 8, 5, 3, "float32", seed=6)
    kernels.reset_launches()
    out = embedding_bag_op(tt, torch.from_numpy(ids), "mean")
    assert torch.equal(out, embedding_bag_plain(tt, torch.from_numpy(ids), "mean"))
    assert kernels.launch_counts()["embedding_bag"] == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        embedding_bag_cuda(tt, torch.from_numpy(ids))


@pytest.mark.parametrize("case,match", [
    ("h0", "H >= 1"), ("max", "mode"), ("float_ids", "integers"),
    ("bool_ids", "integers"), ("int64_ids", "int32"), ("table_3d", "rows, dim"),
    ("ids_1d", r"\(B, H\)"),
])
def test_op_raises_on_what_it_does_not_take(case, match):
    table = torch.zeros((10, 4))
    ids = torch.zeros((3, 2), dtype=torch.int32)
    kw = dict(mode="sum")
    if case == "h0":
        ids = torch.zeros((3, 0), dtype=torch.int32)
    elif case == "max":
        kw["mode"] = "max"
    elif case == "float_ids":
        ids = ids.float()
    elif case == "bool_ids":
        ids = ids.bool()
    elif case == "int64_ids":
        ids = ids.long()
    elif case == "table_3d":
        table = torch.zeros((10, 4, 1))
    else:
        ids = ids[0]
    with pytest.raises(ValueError, match=match):
        embedding_bag_op(table, ids, **kw)


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("rows,dim,b,h", [(50, 16, 40, 1), (7, 32, 300, 3), (200, 24, 64, 6)])
def test_bag_gradient_matches_jax_grad_of_the_oracle(rows, dim, b, h, mode):
    """The bag op's table gradient on the CPU (its autograd function over
    ``ref.embedding_bag_backward_plain``: ``index_add_`` in lookup order)
    against ``jax.grad`` of the reference's oracle (``jnp.take``'s
    scatter-add), with repeated and wrapped negative ids; fp32 within 1e-5
    of the largest |grad|.  An id outside [-rows, rows) reads a row of NaN
    in the forward and takes no part in the gradient."""
    rng = np.random.default_rng(rows + h)
    table = rng.standard_normal((rows, dim)).astype(np.float32)
    ids = rng.integers(-rows, rows, (b, h)).astype(np.int32)
    w = rng.standard_normal((b, dim)).astype(np.float32)
    jg = jax.grad(lambda t: jnp.sum(j_ref(t, jnp.asarray(ids), mode=mode) * w))(jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_()
    (embedding_bag_op(t, torch.from_numpy(ids), mode) * torch.from_numpy(w)).sum().backward()
    assert t.grad.dtype == torch.float32 and t.grad.shape == (rows, dim)
    want = np.asarray(jg)
    assert np.abs(t.grad.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    dropped = ids.copy()
    dropped[0, 0] = rows + 5
    t2 = torch.from_numpy(table).requires_grad_()
    out = embedding_bag_op(t2, torch.from_numpy(dropped), mode)
    assert torch.isnan(out[0]).all()
    out[1:].sum().backward()
    keep = np.ones(b, bool)
    keep[0] = False
    want2 = np.zeros((rows, dim), np.float32)
    scale = 1.0 / h if mode == "mean" else 1.0
    for bag in np.nonzero(keep)[0]:
        for i in ids[bag]:
            want2[i % rows] += scale
    np.testing.assert_allclose(t2.grad.numpy(), want2, rtol=1e-6, atol=1e-6)


def test_bag_op_outside_grad_mode_is_the_forward_alone():
    """Without grad mode, or for a table that does not require grad, the op
    is the forward kernel's call alone (no autograd node)."""
    table = torch.randn(10, 4, requires_grad=True)
    ids = torch.tensor([[1, 2]], dtype=torch.int32)
    with torch.no_grad():
        assert embedding_bag_op(table, ids).grad_fn is None
    assert embedding_bag_op(table.detach(), ids).grad_fn is None
    assert embedding_bag_op(table, ids).grad_fn is not None


# The backward kernel's order of additions (``ref.embedding_bag_backward_emulated``,
# which the card tests hold the kernel to bit for bit) against jax.grad of the
# reference's oracle.  (rows, dim, B, H, case): "repeats" has many lookups a row,
# "wrapped" negative ids, "dropped" ids outside [-rows, rows), "multihot" H > 1,
# "dim21" the scalar path's width, "long-row" one row with more than 2 * CHUNK
# lookups (its pieces combined in groups).
EMU_CASES = {
    "repeats": (7, 16, 300, 1),
    "wrapped": (50, 32, 200, 2),
    "dropped": (40, 8, 120, 3),
    "multihot": (300, 24, 64, 9),
    "dim21": (64, 21, 150, 2),
    "long-row": (5, 12, 600, 2),
}


def _emu_inputs(case):
    rows, dim, b, h = EMU_CASES[case]
    rng = np.random.default_rng(sorted(EMU_CASES).index(case) + 40)
    table = rng.standard_normal((rows, dim)).astype(np.float32)
    ids = rng.integers(-rows if case == "wrapped" else 0, rows, (b, h)).astype(np.int32)
    if case == "dropped":
        ids[::7, 0] = rows + 4                     # jnp.take's scatter drops them
        ids[3, -1] = -rows - 1
    if case == "long-row":
        ids[: 2 * ref.BACKWARD_CHUNK + 9] = 2      # more than 2 * CHUNK lookups of row 2
    w = rng.standard_normal((b, dim)).astype(np.float32)
    return table, ids, w


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("case", sorted(EMU_CASES))
def test_backward_emulation_matches_jax_grad_of_the_oracle(case, mode):
    """The emulated backward kernel against ``jax.grad`` of the oracle (its
    scatter-add through ``jnp.take``): fp32 within 1e-5 of the largest
    |grad|; untouched rows are +0.0 (bit pattern 0)."""
    table, ids, w = _emu_inputs(case)
    rows = table.shape[0]
    jg = np.asarray(jax.grad(
        lambda t: jnp.sum(j_ref(t, jnp.asarray(ids), mode=mode) * w))(jnp.asarray(table)))
    assert np.isfinite(jg).all()
    got = ref.embedding_bag_backward_emulated(torch.from_numpy(w), torch.from_numpy(ids),
                                              rows, mode)
    assert got.dtype == torch.float32 and got.shape == table.shape
    assert np.abs(got.numpy() - jg).max() <= 1e-5 * np.abs(jg).max()
    keys = ref.row_keys(torch.from_numpy(ids), rows)
    untouched = torch.ones(rows, dtype=torch.bool)
    untouched[keys[keys < rows]] = False
    assert not got.view(torch.int32)[untouched].any()


def test_backward_emulation_is_no_less_accurate_on_a_heavy_row():
    """Criteo field 5's three rows at train_batch (~21,845 lookups a row): the
    emulated kernel's sums (32-lookup pieces, then groups, then the groups'
    sums) are no further from a float64 sum than the plain version's single
    running sum in lookup order (``index_add_``)."""
    rng = np.random.default_rng(5)
    b, dim, rows = 65536, 16, 3
    g = rng.standard_normal((b, dim)).astype(np.float32)
    ids = rng.integers(0, rows, (b, 1)).astype(np.int32)
    assert np.bincount(ids[:, 0]).min() >= 20000
    exact = np.zeros((rows, dim))
    np.add.at(exact, ids[:, 0], g.astype(np.float64))
    tg, ti = torch.from_numpy(g), torch.from_numpy(ids)
    emu_err = np.abs(ref.embedding_bag_backward_emulated(tg, ti, rows).double().numpy() - exact)
    plain_err = np.abs(ref.embedding_bag_backward_plain(tg, ti, rows).double().numpy() - exact)
    assert emu_err.max() <= plain_err.max()


def test_backward_emulation_constants_are_the_kernels():
    """The emulation's CHUNK and GROUPS are the backward kernel's own
    (``csrc/embedding_bag.cu``, namespace ``bag_bwd``)."""
    src = (Path(ref.__file__).parents[2] / "csrc" / "embedding_bag.cu").read_text()
    body = src[src.index("namespace bag_bwd {"):]
    const = dict(re.findall(r"constexpr int (\w+) = (\w+);", body))
    assert int(const["CHUNK"]) == ref.BACKWARD_CHUNK
    groups = const["GROUPS"]
    assert int(const.get(groups, groups)) == ref.BACKWARD_GROUPS


def test_backward_kernel_wrapper_refuses_cpu_tensors():
    """The backward kernel's wrapper serves CUDA tensors only (``ops`` sends
    CPU tensors to the plain version), and takes fp32 or bf16 grad_out."""
    g, ids = torch.zeros((4, 8)), torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        embedding_bag_backward_cuda(g, ids, 10)
