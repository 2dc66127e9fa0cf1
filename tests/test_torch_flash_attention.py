"""The port's flash attention (its plain PyTorch version, on the CPU)
against the JAX package: the dense oracle ``attention_reference`` and the
Pallas kernel ``_flash_kernel`` run in interpret mode, as
``tests/test_kernels.py`` runs it.

Inputs are drawn with numpy and handed to both packages.  Tolerances are
the reference tests' own: 2e-5 against the dense oracle and 3e-5 against
the Pallas kernel in fp32 (the same online-softmax arithmetic, summed in
another order), 2e-2 in bf16 (each side rounds its fp32 result to bf16
once, so they may differ by one bf16 ulp, 2^-8 relative).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # one intra-op thread: the suite runs a process a core
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import flash_attention as j_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_reference as j_ref  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash_kernel  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention, flash_attention_plain,
)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_reference, flash_split_p_emulated,
)
from repro_torch.testing import FLASH_TOL  # noqa: E402


# the five shape cases of tests/test_kernels.py (the MHA case shrunk from
# L = 256 to 128 to keep interpret mode cheap)
CASES = [
    (2, 128, 128, 4, 2, 32, True),     # GQA 2:1
    (1, 128, 128, 4, 4, 64, True),     # MHA
    (2, 100, 100, 2, 1, 16, False),    # MQA, bidirectional, ragged tail
    (1, 64, 192, 2, 2, 32, True),      # decode chunk (Lk > Lq): q_offset = 128
    (1, 128, 128, 8, 2, 128, True),    # GQA 4:1, head_dim 128
]


def _qkv(b, lq, lk, h, kv, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, lq, h, hd), dtype=np.float32),
            rng.standard_normal((b, lk, kv, hd), dtype=np.float32),
            rng.standard_normal((b, lk, kv, hd), dtype=np.float32))


def _t(*xs, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in xs]


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("b,lq,lk,h,kv,hd,causal", CASES)
def test_plain_matches_reference_and_pallas(b, lq, lk, h, kv, hd, causal):
    q, k, v = _qkv(b, lq, lk, h, kv, hd, seed=b * lq + lk)
    out = flash_attention_plain(*_t(q, k, v), causal=causal, block_q=64, block_k=64)
    ref = j_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(_np(out), _np(ref), atol=2e-5, rtol=2e-5)
    pallas = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                     block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(_np(out), _np(pallas), atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("b,lq,lk,h,kv,hd,causal", CASES[:2] + CASES[3:4])
def test_port_oracle_matches_reference(b, lq, lk, h, kv, hd, causal):
    q, k, v = _qkv(b, lq, lk, h, kv, hd, seed=7)
    out = attention_reference(*_t(q, k, v), causal=causal)
    ref = j_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(_np(out), _np(ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_matches_pallas(causal):
    q, k, v = _qkv(1, 128, 128, 2, 2, 32, seed=0)
    out = flash_attention_plain(*_t(q, k, v, dtype=torch.bfloat16), causal=causal,
                                block_q=64, block_k=64)
    assert out.dtype == torch.bfloat16
    jb = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)]
    pallas = j_flash(*jb, causal=causal, block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(_np(out), _np(pallas), atol=2e-2, rtol=2e-2)
    ref = j_ref(*jb, causal=causal)
    np.testing.assert_allclose(_np(out), _np(ref), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lens", [[0, 17, 40], [40, 1, 33]])
def test_varlen_kv_lens_match_pallas(causal, lens):
    """Per-example valid lengths, every query position (those past the
    length too, which attend to the example's valid keys), against the
    Pallas kernel; a length-0 example gives exact zeros in both."""
    q, k, v = _qkv(3, 40, 40, 4, 2, 16, seed=sum(lens))
    kv_lens = np.asarray(lens, np.int32)
    out = flash_attention_plain(*_t(q, k, v), causal=causal, block_q=16, block_k=16,
                                kv_lens=torch.from_numpy(kv_lens))
    pallas = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                     block_q=16, block_k=16, interpret=True, kv_lens=jnp.asarray(kv_lens))
    np.testing.assert_allclose(_np(out), _np(pallas), atol=3e-5, rtol=3e-5)
    for i, n in enumerate(lens):
        if n == 0:
            assert torch.count_nonzero(out[i]) == 0
            assert not np.asarray(pallas[i]).any()
        elif not causal:
            ref = j_ref(jnp.asarray(q[i:i + 1, :n]), jnp.asarray(k[i:i + 1, :n]),
                        jnp.asarray(v[i:i + 1, :n]), causal=False)
            np.testing.assert_allclose(_np(out[i, :n]), _np(ref[0]), atol=3e-5, rtol=3e-5)


def _bf16(*xs):
    """numpy fp32 arrays as bf16: torch tensors and jax arrays of the same
    values (both round to nearest even)."""
    return _t(*xs, dtype=torch.bfloat16), [jnp.asarray(x).astype(jnp.bfloat16) for x in xs]


def _fail_share(out, ref, dtype="bfloat16") -> float:
    """Share of outputs outside ``FLASH_TOL[dtype]`` of ``ref``."""
    atol, rtol = FLASH_TOL[dtype]
    a, r = _np(out), _np(ref)
    return float((np.abs(a - r) > atol + rtol * np.abs(r)).mean())


@pytest.mark.parametrize("b,lq,lk,h,kv,hd,causal", CASES)
def test_split_p_emulation_matches_pallas_bf16(b, lq, lk, h, kv, hd, causal):
    """The bf16 kernel's arithmetic (P split into three bf16 terms, 64-key
    tiles, exp2) against the Pallas kernel on the same bf16 inputs, at the
    tolerance the card holds the kernel to."""
    (tq, tk, tv), jb = _bf16(*_qkv(b, lq, lk, h, kv, hd, seed=b * lq + lk))
    out = flash_split_p_emulated(tq, tk, tv, causal=causal)
    assert out.dtype == torch.bfloat16 and out.shape == tq.shape
    pallas = j_flash(*jb, causal=causal, block_q=64, block_k=64, interpret=True)
    atol, rtol = FLASH_TOL["bfloat16"]
    np.testing.assert_allclose(_np(out), _np(pallas), atol=atol, rtol=rtol)


@pytest.mark.parametrize("causal", [False, True])
def test_split_p_emulation_varlen_matches_pallas_bf16(causal):
    """Per-example lengths with a length-0 example: exact zeros in both."""
    lens = np.asarray([0, 17, 40], np.int32)
    (tq, tk, tv), jb = _bf16(*_qkv(3, 40, 40, 4, 2, 16, seed=11))
    out = flash_split_p_emulated(tq, tk, tv, causal=causal, kv_lens=torch.from_numpy(lens))
    pallas = j_flash(*jb, causal=causal, block_q=16, block_k=16, interpret=True,
                     kv_lens=jnp.asarray(lens))
    atol, rtol = FLASH_TOL["bfloat16"]
    np.testing.assert_allclose(_np(out), _np(pallas), atol=atol, rtol=rtol)
    assert torch.count_nonzero(out[0]) == 0 and not np.asarray(pallas[0]).any()


def test_one_bf16_p_misses_the_tolerance_and_three_terms_do_not():
    """Why the kernel splits P: on the same bf16 inputs at hd 128, P rounded
    to one bf16 (FlashAttention's habit) puts outputs outside
    FLASH_TOL["bfloat16"] of the plain version (the Pallas arithmetic);
    the kernel's three bf16 terms put none there."""
    b, lq, lk, h, kv, hd, causal = CASES[4]
    (tq, tk, tv), _ = _bf16(*_qkv(b, lq, lk, h, kv, hd, seed=5))
    plain = flash_attention_plain(tq, tk, tv, causal=causal)
    single = _fail_share(flash_split_p_emulated(tq, tk, tv, causal=causal, terms=1), plain)
    three = _fail_share(flash_split_p_emulated(tq, tk, tv, causal=causal), plain)
    assert single > 0.01, single
    assert three == 0.0, three


def test_two_bf16_terms_miss_the_tolerance_at_the_ce_shape():
    """Why three terms and not two: at the cross-encoder serving shape (64
    pairs of L 64, 8/4 heads, hd 32, 43 valid keys, 1/8 pad rows) P in two
    bf16 terms (16 bits) puts a few outputs in a million outside
    FLASH_TOL["bfloat16"] of the plain version: outputs are large there,
    so the 2^-17 error of p passes the tolerance's 1e-6 floor where an
    output cancels to near zero.  Three terms put none there."""
    (tq, tk, tv), _ = _bf16(*_qkv(64, 64, 64, 8, 4, 32, seed=2))
    lens = torch.tensor([43] * 56 + [0] * 8, dtype=torch.int32)
    plain = flash_attention_plain(tq, tk, tv, causal=False, kv_lens=lens)
    two = _fail_share(flash_split_p_emulated(tq, tk, tv, causal=False, kv_lens=lens,
                                             terms=2), plain)
    three = _fail_share(flash_split_p_emulated(tq, tk, tv, causal=False, kv_lens=lens), plain)
    assert two > 0.0, two
    assert three == 0.0, three


def test_block_sizes_do_not_change_the_result():
    q, k, v = _qkv(2, 70, 70, 4, 2, 32, seed=3)
    lens = torch.tensor([70, 29], dtype=torch.int32)
    a = flash_attention_plain(*_t(q, k, v), causal=True, block_q=16, block_k=32, kv_lens=lens)
    b = flash_attention_plain(*_t(q, k, v), causal=True, block_q=128, block_k=128,
                              kv_lens=lens)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-6, rtol=2e-6)


def test_cpu_tensors_run_the_plain_version_and_launch_nothing():
    q, k, v = _t(*_qkv(1, 32, 32, 2, 1, 16, seed=1))
    kernels.reset_launches()
    out = flash_attention(q, k, v, causal=False, block_q=16, block_k=16)
    assert kernels.launch_counts()["flash_attention"] == 0
    assert torch.equal(out, flash_attention_plain(q, k, v, causal=False, block_q=16,
                                                  block_k=16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_kernel.flash_attention_cuda(q, k, v, causal=False)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_version_is_differentiable_like_the_jax_oracle(causal):
    """The plain version stays differentiable on the CPU (the CUDA kernel,
    which has no backward, refuses autograd on the card): its gradients in
    q, k and v over several key tiles match ``jax.grad`` of the reference's
    dense oracle within the fp32 tolerance."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 40, 4, 16), (2, 40, 2, 16), (2, 40, 2, 16)))
    w = rng.standard_normal((2, 40, 4, 16)).astype(np.float32)
    jg = jax.grad(lambda a, b, c: jnp.sum(j_ref(a, b, c, causal=causal) * w),
                  argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash_attention(*ts, causal=causal, block_q=16, block_k=16)
    (out * torch.from_numpy(w)).sum().backward()
    atol, rtol = FLASH_TOL["float32"]
    for t, g in zip(ts, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=atol, rtol=rtol)
