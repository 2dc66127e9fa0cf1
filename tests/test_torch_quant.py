"""The port's quantized payloads (``kernels/approx_topk/quant.py``) against
the JAX package's, on numpy inputs made from a seed.

Codes (compared as bytes) and scales are bit-equal for int8, packed int4
and fp8 e4m3, at odd widths, with an all-zero tile and with fp8 values past
±448 (the clip before the cast); the bf16 cast is bit-equal.  The dense
product, ``take_columns`` and ``gather_columns`` agree to fp32 rounding
(rtol 1e-6, atol 1e-5: the same codes and scales, products summed in
another order), and ``payload_nbytes`` matches each operand's ``.nbytes``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # one intra-op thread: the suite runs a process a core
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.approx_topk import quant as jq  # noqa: E402
from repro_torch.kernels.approx_topk import quant as tq  # noqa: E402

K_Q = 24


def _bytes(x):
    """Raw bytes of a JAX or torch array as a uint8 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    a = np.asarray(x)
    return a.view(np.uint8)


def _matrix(n, seed, zero_tile=None, spikes=False):
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((K_Q, n)).astype(np.float32)
    r[:, ::7] *= 40.0                      # a wide range inside each tile
    if zero_tile is not None:
        r[:, :zero_tile] = 0.0
    if spikes:
        r[3, n - 1] = 1e6
        r[7, n - 2] = -3e7
    return r


def _both(r, tile, code):
    j = jq.quantize_ranc(jnp.asarray(r), tile, code_dtype=code)
    t = tq.quantize_ranc(torch.from_numpy(r), tile, code_dtype=code)
    return j, t


@pytest.mark.parametrize("n", [1, 7, 301])
def test_int4_pack_unpack_take_bit_equal(n):
    rng = np.random.default_rng(n)
    codes = rng.integers(-8, 8, (K_Q, n)).astype(np.int32)
    jp = jq.pack_int4(jnp.asarray(codes))
    tp = tq.pack_int4(torch.from_numpy(codes))
    assert tp.dtype == torch.uint8 and tp.shape == (K_Q, -(-n // 2))
    assert np.array_equal(np.asarray(jp), tp.numpy())
    assert np.array_equal(np.asarray(jq.unpack_int4(jp)), tq.unpack_int4(tp).numpy())
    assert np.array_equal(tq.unpack_int4(tp).numpy()[:, :n], codes)
    pos = rng.integers(0, n, (5, 9))
    assert np.array_equal(np.asarray(jq._take_nibbles(jp, jnp.asarray(pos))),
                          tq._take_nibbles(tp, torch.from_numpy(pos)).numpy())


# (N, tile): odd N over several tiles with a ragged tail, an odd N below
# one tile, a tile of 64
SHAPES = [(1037, 128), (301, 512), (999, 64)]


@pytest.mark.parametrize("code", ["int8", "int4", "fp8"])
@pytest.mark.parametrize("n, tile", SHAPES)
def test_quantize_ranc_codes_and_scales_bit_equal(code, n, tile):
    zero = tile if n > tile + 2 else None      # an all-zero first tile
    r = _matrix(n, seed=n + tile, zero_tile=zero, spikes=True)
    j, t = _both(r, tile, code)
    assert t.code_dtype == code and t.tile == tile and t.n_cols == j.n_cols
    assert t.shape == tuple(j.shape) == (K_Q, n) and t.packing == j.packing
    assert np.array_equal(_bytes(j.codes), _bytes(t.codes))
    assert np.array_equal(np.asarray(j.scales), t.scales.numpy())
    if zero:
        assert t.scales[0].item() == 1.0
    assert np.array_equal(np.asarray(jq.unpacked_codes(j)).astype(np.float32),
                          tq.unpacked_codes(t).to(torch.float32).numpy())
    assert np.array_equal(np.asarray(jq.dequantize(j)), tq.dequantize(t).numpy())
    assert t.nbytes == j.nbytes
    want = tq.payload_nbytes(code, K_Q, n, tile)
    assert want == jq.payload_nbytes(code, K_Q, n, tile)
    # an odd-width int4 row stores one padding nibble, half a byte a row
    assert t.nbytes - want == (K_Q // 2 if code == "int4" and n % 2 else 0)


def test_fp8_clips_past_448_as_the_reference():
    """Values an ulp past qmax after the scale divide would cast to NaN in
    JAX and saturate in torch: both clip first, so the codes agree and
    hold no NaN."""
    r = _matrix(512, seed=3)
    r[0, 0] = 448.0 * 3.0000002
    r[1, 1] = -448.0 * 3.0
    j, t = _both(r, 512, "fp8")
    assert np.array_equal(_bytes(j.codes), _bytes(t.codes))
    codes = t.codes.to(torch.float32)
    assert torch.isfinite(codes).all() and codes.abs().max().item() == 448.0


def test_bf16_cast_bit_equal():
    r = _matrix(777, seed=5, spikes=True)
    j = jq.as_payload(jnp.asarray(r), "bfloat16")
    t = tq.as_payload(torch.from_numpy(r), "bfloat16")
    assert t.dtype == torch.bfloat16 and tq.payload_dtype_of(t) == "bfloat16"
    assert np.array_equal(_bytes(j), _bytes(t))
    assert tq.payload_nbytes("bfloat16", K_Q, 777) == t.numel() * 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4", "fp8"])
def test_matmul_take_gather_agree(dtype):
    n, tile = 1201, 128
    r = _matrix(n, seed=9)
    rng = np.random.default_rng(10)
    e = rng.standard_normal((6, K_Q)).astype(np.float32)
    jp = jq.as_payload(jnp.asarray(r), dtype, tile)
    tp = tq.as_payload(torch.from_numpy(r), dtype, tile)
    assert tq.payload_dtype_of(tp) == jq.payload_dtype_of(jp) == dtype
    tol = dict(rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(tq.matmul(torch.from_numpy(e), tp).numpy(),
                               np.asarray(jq.matmul(jnp.asarray(e), jp)), **tol)
    pos = rng.integers(0, n, 17)
    np.testing.assert_allclose(tq.take_columns(tp, torch.from_numpy(pos)).numpy(),
                               np.asarray(jq.take_columns(jp, jnp.asarray(pos))), **tol)
    idx = rng.integers(0, n, (6, 11)).astype(np.int32)
    got = tq.gather_columns(tp, torch.from_numpy(idx))
    assert got.shape == (6, K_Q, 11) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jq.gather_columns(jp, jnp.asarray(idx))), **tol)


def test_policies_are_checked():
    with pytest.raises(ValueError, match="even tile"):
        tq.quantize_ranc(torch.zeros((2, 10)), 5, code_dtype="int4")
    with pytest.raises(ValueError, match="unknown code_dtype"):
        tq.quantize_ranc(torch.zeros((2, 10)), 4, code_dtype="int2")
    with pytest.raises(ValueError, match="unknown payload_dtype"):
        tq.payload_nbytes("float16", 2, 10)
    assert tq.fp8_supported()
