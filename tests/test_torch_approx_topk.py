"""The port's fused score->top-k ops (plain versions, on the CPU) against
the JAX package's ``approx_topk_op`` (Pallas kernel in interpret mode and
the scan backend) and ``persistent_round_op``, for every payload policy:
fp32, bf16, and int8 / fp8 e4m3 / packed int4 codes (carried across as
bytes).

Comparator (``repro_torch.testing``, rtol 1e-5): values equal position by
position, ids distinct in each row, and every id carries its reported value
in the dense oracle's (B, N) field — so a differing id passes only as a
near-tie two fp32 summation orders may swap.  Exact
ties are constructed and must resolve to ascending ids in both packages.
Rows with fewer than k unmasked items are held against ``scan`` only: the
Pallas kernel repeats an id there, the scan backend and the port return
distinct ascending ids."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # one intra-op thread: the suite runs a process a core
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.approx_topk.ops import approx_topk_op as j_topk  # noqa: E402
from repro.kernels.approx_topk.persistent import persistent_round_op as j_pers  # noqa: E402
from repro.kernels.approx_topk.quant import quantize_ranc as j_quant  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels.approx_topk import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.approx_topk.ops import approx_topk_op as t_topk  # noqa: E402
from repro_torch.kernels.approx_topk.persistent import persistent_round_op as t_pers  # noqa: E402
from repro_torch.kernels.approx_topk.quant import (  # noqa: E402
    QuantizedRanc, as_payload, quantize_ranc as t_quant, unpacked_codes,
)
from repro_torch.core.sampling import blocked_gumbel  # noqa: E402
from repro_torch.kernels.approx_topk.ref import (  # noqa: E402
    approx_topk_reference, dense_scores, tf32_round, tf32x3_scores,
)
from repro_torch.kernels.approx_topk.select import stable_topk  # noqa: E402
from repro_torch.testing import assert_topk_agree, topk_report  # noqa: E402

B, KQ, N, TILE = 8, 48, 1500, 512


def _inputs(seed=0, ties=False):
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((B, KQ)).astype(np.float32)
    r = rng.standard_normal((KQ, N)).astype(np.float32)
    if ties:
        # duplicated columns score exactly equal in any summation order;
        # their ascending ids must win in both packages
        e[:, :] = np.abs(e)
        r[:, 10] = np.abs(r[:, 10]) + 3.0
        r[:, 700:760] = r[:, 10:11]
        r[:, 1200:1203] = r[:, 10:11]
    extras = dict(
        noise=rng.gumbel(size=(B, N)).astype(np.float32),
        mask=rng.random((B, N)) < 0.3,
        anchors=rng.integers(0, N, (B, 25)).astype(np.int32),
    )
    return e, r, extras


DTYPES = ["float32", "int8", "bfloat16", "fp8", "int4"]


def _payloads(r, dtype):
    """The reference's payload of policy ``dtype`` and the port's copy of
    it, carried across as bytes."""
    if dtype in ("float32", "bfloat16"):
        jp = jnp.asarray(r).astype(dtype)
        return jp, convert.r_anc(np.asarray(jp), device="cpu")
    jq = j_quant(jnp.asarray(r), 256, code_dtype=dtype)
    return jq, convert.quantized_ranc(np.asarray(jq.codes), np.asarray(jq.scales), jq.tile,
                                      device="cpu", code_dtype=dtype, n_cols=jq.n_cols)


def _impls(dtype, case):
    """JAX backends to hold a case against: the scan backend always, the
    Pallas kernel (interpret mode) for every fp32 / int8 case and for the
    full case of each other payload."""
    return ("pallas", "scan") if dtype in ("float32", "int8") or case == "all" else ("scan",)


@pytest.mark.parametrize("tile", [128, 256, 512])
def test_int8_codes_scales_exact(tile):
    _, r, _ = _inputs(1)
    r = r.copy()
    r[:, :tile] = 0.0                       # an all-zero tile stores scale 1.0
    jq, tq = j_quant(jnp.asarray(r), tile), t_quant(torch.from_numpy(r), tile)
    assert tq.codes.dtype == torch.int8
    assert np.array_equal(np.asarray(jq.codes), tq.codes.numpy())
    assert np.array_equal(np.asarray(jq.scales), tq.scales.numpy())


CASES = [
    ("plain", dict()),
    ("anchors", dict(anchors=True)),
    ("noise+mask", dict(noise=True, mask=True)),
    ("anchors+n_valid", dict(anchors=True, n_valid=1300)),
    ("all", dict(noise=True, mask=True, anchors=True, n_valid=1450)),
]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("case", [c[0] for c in CASES])
@pytest.mark.parametrize("dtype", DTYPES)
def test_approx_topk_matches_both_jax_backends(dtype, case, ties):
    opts = dict(CASES)[case]
    e, r, ex = _inputs(2, ties=ties)
    jpay, tpay = _payloads(r, dtype)
    k = 12
    jkw, tkw = {}, {}
    for name in ("noise", "mask"):
        if opts.get(name):
            jkw[name], tkw[name] = jnp.asarray(ex[name]), torch.from_numpy(ex[name])
    if "n_valid" in opts:
        jkw["n_valid"] = tkw["n_valid"] = opts["n_valid"]
    janc = jnp.asarray(ex["anchors"]) if opts.get("anchors") else None
    tanc = torch.from_numpy(ex["anchors"]) if opts.get("anchors") else None
    tv, ti = t_topk(torch.from_numpy(e), tpay, tanc, k, tile=TILE, **tkw)
    assert ti.dtype == torch.int32 and tv.shape == (B, k)
    dense = dense_scores(torch.from_numpy(e), tpay, tanc, **tkw)
    for impl in _impls(dtype, case):
        jv, ji = j_topk(jnp.asarray(e), jpay, janc, k, tile=TILE, interpret=True,
                        impl=impl, **jkw)
        assert_topk_agree(ji, jv, ti, tv, dense)
    if ties and case == "plain":
        assert ti[:, 0].tolist() == [10] * B        # the tie's lowest id
        assert ti[:, 1].tolist() == [700] * B
    # the dense oracle agrees too
    rv, ri = approx_topk_reference(torch.from_numpy(e), tpay, tanc, k, **tkw)
    assert_topk_agree(ri, rv, ti, tv, dense)


@pytest.mark.parametrize("dtype", DTYPES)
def test_underfilled_rows_follow_scan(dtype):
    e, r, _ = _inputs(3)
    jpay, tpay = _payloads(r, dtype)
    mask = np.zeros((B, N), bool)
    mask[0] = True                           # nothing valid
    mask[1] = True
    mask[1, [2, 1, 900]] = False             # three valid items
    k = 6
    jv, ji = j_topk(jnp.asarray(e), jpay, None, k, tile=TILE, interpret=True,
                    impl="scan", mask=jnp.asarray(mask))
    tv, ti = t_topk(torch.from_numpy(e), tpay, None, k, tile=TILE,
                    mask=torch.from_numpy(mask))
    assert_topk_agree(ji, jv, ti, tv, dense_scores(torch.from_numpy(e), tpay,
                                                   mask=torch.from_numpy(mask)))
    assert ti[0].tolist() == [0, 1, 2, 3, 4, 5]
    assert sorted(ti[1, :3].tolist()) == [1, 2, 900] and ti[1, 3:].tolist() == [0, 3, 4]


@pytest.mark.parametrize("strategy_noise", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_persistent_round_matches_jax_and_staged(dtype, strategy_noise):
    e, r, ex = _inputs(4)
    jpay, tpay = _payloads(r, dtype)
    prov_mask = ex["mask"][:, ::-1].copy()
    kw_j = dict(k_sample=10, k_prov=15, anchors=jnp.asarray(ex["anchors"]),
                prov_mask=jnp.asarray(prov_mask), n_valid=1400, tile=TILE)
    kw_t = dict(k_sample=10, k_prov=15, anchors=torch.from_numpy(ex["anchors"]),
                prov_mask=torch.from_numpy(prov_mask), n_valid=1400, tile=TILE)
    if strategy_noise:
        kw_j["noise"], kw_t["noise"] = jnp.asarray(ex["noise"]), torch.from_numpy(ex["noise"])
    # the Pallas kernel in interpret mode for fp32 / int8 and for each other
    # payload with noise, the scan backend otherwise
    impl = "pallas" if dtype in ("float32", "int8") or strategy_noise else "scan"
    (jsv, jsi), (jpv, jpi) = j_pers(jnp.asarray(e), jpay, interpret=True, impl=impl, **kw_j)
    (tsv, tsi), (tpv, tpi) = t_pers(torch.from_numpy(e), tpay, **kw_t)
    assert_topk_agree(jsi, jsv, tsi, tsv, dense_scores(
        torch.from_numpy(e), tpay, kw_t["anchors"], kw_t.get("noise"), n_valid=1400))
    assert_topk_agree(jpi, jpv, tpi, tpv, dense_scores(
        torch.from_numpy(e), tpay, mask=kw_t["prov_mask"], n_valid=1400))
    # bitwise equal to the two staged calls of the same backend
    sv, si = t_topk(torch.from_numpy(e), tpay, kw_t["anchors"], 10, tile=TILE,
                    noise=kw_t.get("noise"), n_valid=1400)
    pv, pi = t_topk(torch.from_numpy(e), tpay, None, 15, tile=TILE,
                    mask=kw_t["prov_mask"], n_valid=1400)
    for a, b in ((tsv, sv), (tsi, si), (tpv, pv), (tpi, pi)):
        assert torch.equal(a, b)


def test_persistent_noise_key_materializes_the_field():
    e, r, ex = _inputs(5)
    key = jax.random.PRNGKey(9)
    (jv, ji), _ = j_pers(jnp.asarray(e), jnp.asarray(r), k_sample=8,
                         noise_key=key, interpret=True, impl="scan", tile=256)
    tkey = convert.key(np.asarray(key))
    (tv, ti), prov = t_pers(torch.from_numpy(e), convert.r_anc(r, device="cpu"), k_sample=8,
                            noise_key=tkey, tile=256)
    assert prov is None
    noise = blocked_gumbel(tkey, B, N, 0, 0, device="cpu")
    assert_topk_agree(ji, jv, ti, tv, dense_scores(torch.from_numpy(e),
                                                   convert.r_anc(r, device="cpu"), noise=noise))


@pytest.mark.parametrize("fault", ["tile_local_ids", "repeated_id", "swapped_non_tie"])
def test_comparator_rejects_wrong_ids_with_right_values(fault):
    e, r, _ = _inputs(7)
    e_t, pay = torch.from_numpy(e), convert.r_anc(r, device="cpu")
    dense = dense_scores(e_t, pay)
    v, i = t_topk(e_t, pay, None, 10, tile=TILE)
    assert topk_report(i, v, i, v, dense)["ok"]
    bad = i.clone()
    if fault == "tile_local_ids":
        bad = bad % TILE
        assert (bad != i).any()
    elif fault == "repeated_id":
        bad[:, 1] = bad[:, 0]
    else:
        bad[:, [0, 9]] = bad[:, [9, 0]]
    rep = topk_report(i, v, bad, v, dense)
    assert not rep["ok"] and rep["id_mismatches"] > 0


def test_comparator_accepts_a_swapped_exact_tie():
    e, r, _ = _inputs(8, ties=True)
    e_t, pay = torch.from_numpy(e), convert.r_anc(r, device="cpu")
    dense = dense_scores(e_t, pay)
    v, i = t_topk(e_t, pay, None, 4, tile=TILE)
    assert i[:, :2].tolist() == [[10, 700]] * B and torch.equal(v[:, 0], v[:, 1])
    swapped = i.clone()
    swapped[:, [0, 1]] = swapped[:, [1, 0]]
    rep = topk_report(i, v, swapped, v, dense)
    assert rep["ok"] and rep["id_mismatches"] == 2 * B


def test_cuda_wrapper_refuses_cpu_tensors():
    e, r, _ = _inputs(6)
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_kernel.approx_topk_cuda(torch.from_numpy(e), convert.r_anc(r, device="cpu"), None, 5)
    with pytest.raises(ValueError, match="unknown impl"):
        t_topk(torch.from_numpy(e), convert.r_anc(r, device="cpu"), None, 5, impl="pallas")


def test_super_cols_fill_the_card():
    """The sweep's grid planner: one wave of (32-row group, column range)
    blocks on the card's SMs, ranges of whole TCOLS-wide (512-column) tiles covering N."""
    plan, tcols = t_kernel.plan_grid, t_kernel.TCOLS
    tiles = -(-1_000_000 // tcols)
    assert plan(256, 1_000_000) == (16, -(-tiles // 16) * tcols)   # 8 groups x 16 ranges
    for b, n, sms in ((256, 1_000_000, 132), (16, 1_000_000, 132), (16, 100, 132),
                      (200, 9001, 132), (5000, 70_000, 132), (64, 1 << 20, 114)):
        ranges, cols = plan(b, n, sms)
        groups = -(-b // t_kernel.ROWS)
        assert cols % t_kernel.TCOLS == 0 and ranges == -(-n // cols)
        assert (ranges - 1) * cols < n <= ranges * cols
        assert groups * ranges <= max(sms, groups)
    assert plan(16, 100) == (1, tcols)


@pytest.mark.parametrize("b, k_q", [(40, 70), (32, 32), (1, 500)])
def test_fragment_split_layout(b, k_q):
    """The wrapper's host-side e_q split, as the CUDA kernels read it: TF32
    hi/lo of each entry (``ref.tf32_round``) at its mma A-fragment slot,
    zeros in the padding."""
    e = torch.from_numpy(np.random.default_rng(b + k_q).standard_normal((b, k_q)).astype(np.float32))
    hi, lo = t_kernel.fragment_split(e)
    groups, chunks = -(-b // 32), -(-k_q // 32)
    assert hi.shape == lo.shape == (groups, chunks, 4, 2, 32, 4)
    want_hi = torch.zeros((groups * 32, chunks * 32))
    want_hi[:b, :k_q] = tf32_round(e)
    want_lo = torch.zeros_like(want_hi)
    want_lo[:b, :k_q] = tf32_round(e - tf32_round(e))
    grp, ch, ks, mi, lane, j = np.meshgrid(*[np.arange(d) for d in hi.shape], indexing="ij")
    rows = grp * 32 + mi * 16 + lane // 4 + 8 * (j & 1)
    cols = ch * 32 + ks * 8 + lane % 4 + 4 * (j >> 1)
    assert torch.equal(hi, want_hi[rows, cols])
    assert torch.equal(lo, want_lo[rows, cols])


@pytest.mark.parametrize("dtype", DTYPES)
def test_tf32x3_split_meets_the_comparator_at_k_q_500(dtype):
    """The CUDA kernels' 3xTF32 arithmetic (``ref.tf32x3_scores``: hi/lo
    split, 32-deep chunks, fp32 chunk sums) on the CPU: its top-k passes
    ``topk_report`` at TOPK_RTOL against the JAX package's scan backend with
    the port's fp32 dense field, and its error against float64 stays within
    4x plain fp32's (torch's fp32 product)."""
    rng = np.random.default_rng(11)
    b, k_q, n = 8, 500, 4096
    e = rng.standard_normal((b, k_q)).astype(np.float32)
    r = rng.standard_normal((k_q, n)).astype(np.float32)
    jpay, tpay = _payloads(r, dtype)
    e_t = torch.from_numpy(e)
    emul = tf32x3_scores(e_t, tpay)
    dense = dense_scores(e_t, tpay)
    for k in (20, 100):
        ev, ei = stable_topk(emul, k)
        jv, ji = j_topk(jnp.asarray(e), jpay, None, k, tile=TILE, impl="scan")
        assert_topk_agree(ji, jv, ei, ev, dense)
    coded = isinstance(tpay, QuantizedRanc)
    codes = unpacked_codes(tpay).double() if coded else tpay.double()
    exact = e_t.double() @ codes
    if coded:
        exact = exact * tpay.col_scales().double()[None, :]
    err_emul = (emul.double() - exact).abs().max().item()
    err_fp32 = (dense.double() - exact).abs().max().item()
    assert err_emul <= 4.0 * err_fp32, (err_emul, err_fp32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "fp8"])
def test_chunk_carry_cuts_the_truncating_replays_error(dtype):
    """In the replay of the tensor core (``tf32x3_scores(truncate=True)``:
    each k-step's sum truncated toward zero to fp32), carrying each chunk
    add's rounding error into the next chunk (the kernels' accumulation for
    the payloads exact in TF32; fp32 was measured too) lowers the worst and
    the RMS error against float64 at the near-full card test's shape
    (33 x 500 x 257) below 0.95x the plain chunk adds', for every seed."""
    for seed in range(3):
        rng = np.random.default_rng(seed)
        e = torch.from_numpy(rng.standard_normal((33, 500)).astype(np.float32))
        pay = as_payload(torch.from_numpy(rng.standard_normal((500, 257)).astype(np.float32)),
                         dtype)
        coded = isinstance(pay, QuantizedRanc)
        exact = e.double() @ (unpacked_codes(pay) if coded else pay).double()
        if coded:
            exact = exact * pay.col_scales().double()[None, :]
        err = {carry: (tf32x3_scores(e, pay, truncate=True, carry=carry).double() - exact).abs()
               for carry in (True, False)}
        assert err[True].max() < 0.95 * err[False].max(), seed
        assert err[True].pow(2).mean().sqrt() < 0.95 * err[False].pow(2).mean().sqrt(), seed


def test_tf32_round_is_round_to_nearest_ties_away():
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 2**-10 + 2**-11, -(1 + 2**-11), 1 + 2**-12,
                      1 + 2**-11 - 2**-23, float("inf"), float("-inf")], dtype=torch.float32)
    want = [1.0, 1 + 2**-10, 1 + 2**-9, -(1 + 2**-10), 1.0, 1.0, float("inf"), float("-inf")]
    assert tf32_round(x).tolist() == want
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(1000).astype(np.float32))
    hi = tf32_round(y)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((y - hi).abs() <= y.abs() * 2.0**-11).all()
