"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they need an NVIDIA GPU and ``nvcc`` and skip elsewhere
(the decision is made inside the fixture, never at import).  On the card
(``--noconftest``: the suite's conftest imports jax, which the port's
machine need not have):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import re
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.approx_topk.ops import approx_topk_op  # noqa: E402
from repro_torch.kernels.approx_topk.persistent import persistent_round_op  # noqa: E402
from repro_torch.kernels.approx_topk.quant import (  # noqa: E402
    QuantizedRanc, as_payload, dequantize, subset_columns, unpacked_codes,
)
from repro_torch.kernels.approx_topk.ref import dense_scores  # noqa: E402
from repro_torch.kernels.approx_topk.select import NEG_INF  # noqa: E402
from repro_torch.kernels.embedding_bag.ops import embedding_bag_op  # noqa: E402
from repro_torch.kernels.embedding_bag.ref import embedding_bag_plain  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash_kernel  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention, flash_attention_plain,
)
from repro_torch.testing import (  # noqa: E402
    BATCH_BITS_ROWS, FLASH_TOL, assert_topk_agree, estimate_state_calls, ragged_topk_inputs,
    rows_differing, synthetic_pair_call, topk_inputs, topk_report)

pytestmark = pytest.mark.cuda

# every payload policy of the two top-k kernels
DTYPES = ["float32", "int8", "bfloat16", "fp8", "int4"]
# the near-full accuracy case's seeds: its original one and 0-7
NEAR_FULL_SEEDS = [33 + 500 + 256, *range(8)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [1, 20, 100])
def test_approx_topk_kernel_matches_plain(dev, dtype, k):
    e, r, noise, mask, anchors = topk_inputs(dev)
    pay = as_payload(r, dtype)
    before = kernels.launch_counts()["approx_topk"]
    kv, ki = approx_topk_op(e, pay, anchors, k, noise=noise, mask=mask, n_valid=8500)
    assert kernels.launch_counts()["approx_topk"] == before + 1
    pv, pi = approx_topk_op(e, pay, anchors, k, noise=noise, mask=mask, n_valid=8500,
                            impl="torch")
    assert_topk_agree(ki, kv, pi, pv,
                      dense_scores(e, pay, anchors, noise=noise, mask=mask, n_valid=8500))


def test_underfilled_rows_are_distinct_and_ascending(dev):
    e, r, _, _, _ = topk_inputs(dev)
    mask = torch.ones((e.shape[0], r.shape[1]), dtype=torch.bool, device=dev)
    mask[1, [5, 700, 8000]] = False
    _, ki = approx_topk_op(e, r, None, 8, mask=mask)
    assert ki[0].tolist() == list(range(8))
    assert sorted(ki[1, :3].tolist()) == [5, 700, 8000]
    assert ki[1, 3:].tolist() == [0, 1, 2, 3, 4]


@pytest.mark.parametrize("dtype", DTYPES)
def test_persistent_kernel_is_two_staged_calls(dev, dtype):
    e, r, noise, mask, anchors = topk_inputs(dev, seed=1)
    pay = as_payload(r, dtype)
    (sv, si), (pv, pi) = persistent_round_op(e, pay, k_sample=20, k_prov=50,
                                             anchors=anchors, noise=noise, prov_mask=mask)
    av, ai = approx_topk_op(e, pay, anchors, 20, noise=noise)
    bv, bi = approx_topk_op(e, pay, None, 50, mask=mask)
    for x, y in ((sv, av), (si, ai), (pv, bv), (pi, bi)):
        assert torch.equal(x, y)
    (qv, qi), (rv, ri) = persistent_round_op(e, pay, k_sample=20, k_prov=50, anchors=anchors,
                                             noise=noise, prov_mask=mask, impl="torch")
    assert_topk_agree(si, sv, qi, qv, dense_scores(e, pay, anchors, noise=noise))
    assert_topk_agree(pi, pv, ri, rv, dense_scores(e, pay, mask=mask))


@pytest.mark.parametrize("dtype", DTYPES)
def test_kernels_take_a_per_column_scale_sub_payload(dev, dtype):
    """A candidate subset's payload (``subset_columns``: per-column scales,
    ``tile=1``; int4 widened to int8 codes) through both kernels: against
    the plain versions, persistent bitwise equal to two approx_topk calls,
    and approx_topk bitwise equal to the full payload's kernel masked to the
    subset (the subset search's contract), ids mapped through ``pos``."""
    e, r, noise, mask, anchors = topk_inputs(dev, seed=3)
    n = r.shape[1]
    pay = as_payload(r, dtype)
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    c = 3001
    pos = torch.sort(torch.randperm(n, generator=g, device=dev)[:c]).values.to(torch.int32)
    valid = torch.arange(c, device=dev) < c - 11
    pos = torch.where(valid, pos, 0)
    sub = subset_columns(pay, pos, valid)
    if isinstance(sub, QuantizedRanc):
        assert sub.tile == 1 and sub.code_dtype == ("int8" if dtype == "int4" else dtype)
    kw = dict(noise=noise[:, pos.long()], mask=mask[:, pos.long()], n_valid=c - 11)
    kv, ki = approx_topk_op(e, sub, None, 20, **kw)
    pv, pi = approx_topk_op(e, sub, None, 20, impl="torch", **kw)
    assert_topk_agree(ki, kv, pi, pv, dense_scores(e, sub, **kw))
    (sv, si), (qv, qi) = persistent_round_op(e, sub, k_sample=20, k_prov=50, noise=kw["noise"],
                                             prov_mask=kw["mask"], n_valid=c - 11)
    av, ai = approx_topk_op(e, sub, None, 20, noise=kw["noise"], n_valid=c - 11)
    bv, bi = approx_topk_op(e, sub, None, 50, mask=kw["mask"], n_valid=c - 11)
    assert torch.equal(sv, av) and torch.equal(si, ai)
    assert torch.equal(qv, bv) and torch.equal(qi, bi)
    outside = torch.ones(n, dtype=torch.bool, device=dev)
    outside[pos[valid].long()] = False
    fv, fi = approx_topk_op(e, pay, None, 20, noise=noise, mask=mask | outside[None, :])
    assert torch.equal(fv, kv) and torch.equal(fi, pos[ki.long()])


# (B, k_q, N): ragged rows, a k_q tail that is not a multiple of the
# kernels' 32-deep chunks, N that is not a multiple of any tile (and, at
# N = 9001 or 2049, leaves payload rows unaligned for 16-byte copies)
RAGGED = [(200, 500, 9001), (1, 7, 1000), (33, 500, 2049), (200, 7, 9001), (64, 96, 8192)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k, n_anc", [(1, 0), (256, 100), (20, 100), (256, 0)])
@pytest.mark.parametrize("shape", RAGGED, ids=lambda s: "x".join(map(str, s)))
def test_sweep_ragged_shapes_match_plain(dev, shape, k, n_anc, dtype):
    """Both kernels against the plain versions on shapes that stress the
    tiling; persistent bitwise equal to two approx_topk calls."""
    b, k_q, n = shape
    e, r, noise, mask, anchors = ragged_topk_inputs(dev, b, k_q, n, seed=b + k_q + k)
    pay = as_payload(r, dtype)
    anc = anchors[:, :n_anc] if n_anc else None
    kw = dict(noise=noise, mask=mask, n_valid=n - 5)
    kv, ki = approx_topk_op(e, pay, anc, k, **kw)
    pv, pi = approx_topk_op(e, pay, anc, k, impl="torch", **kw)
    assert_topk_agree(ki, kv, pi, pv, dense_scores(e, pay, anc, **kw))
    assert ki[0].tolist() == list(range(k))
    if b > 1 and k >= 3:
        valid = [3, n // 2, n - 6]
        assert sorted(ki[1, :3].tolist()) == valid
        assert ki[1, 3:].tolist() == [j for j in range(k + 3) if j not in valid][:k - 3]
    prov_mask = torch.flip(mask, dims=[1]).contiguous()
    (sv, si), (qv, qi) = persistent_round_op(e, pay, k_sample=k, k_prov=k, anchors=anc,
                                             noise=noise, mask=mask, prov_mask=prov_mask,
                                             n_valid=n - 5)
    bv, bi = approx_topk_op(e, pay, None, k, mask=prov_mask, n_valid=n - 5)
    for x, y in ((sv, kv), (si, ki), (qv, bv), (qi, bi)):
        assert torch.equal(x, y)
    (rv, ri), _ = persistent_round_op(e, pay, k_sample=k, anchors=anc, n_valid=n - 5,
                                      noise=noise, mask=mask)
    assert torch.equal(rv, kv) and torch.equal(ri, ki)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [257, 800, 1024])
@pytest.mark.parametrize("shape", [(40, 96, 9001), (33, 500, 20000), (200, 7, 12289)],
                         ids=lambda s: "x".join(map(str, s)))
def test_large_k_kernel_matches_plain(dev, shape, k, dtype):
    """approx_topk's large-k instantiation (k in (256, 1024]) against the
    plain version on ragged shapes, with noise, a mask, anchors and
    ``n_valid``: row 0 fully masked returns ids 0..k-1, row 1 (three valid
    items) returns them first and then the lowest suppressed ids."""
    b, k_q, n = shape
    e, r, noise, mask, anchors = ragged_topk_inputs(dev, b, k_q, n, seed=b + k_q + k)
    pay = as_payload(r, dtype)
    kw = dict(noise=noise, mask=mask, n_valid=n - 5)
    before = kernels.launch_counts()["approx_topk"]
    kv, ki = approx_topk_op(e, pay, anchors, k, **kw)
    assert kernels.launch_counts()["approx_topk"] == before + 1
    pv, pi = approx_topk_op(e, pay, anchors, k, impl="torch", **kw)
    assert_topk_agree(ki, kv, pi, pv, dense_scores(e, pay, anchors, **kw))
    assert ki[0].tolist() == list(range(k))
    valid = [3, n // 2, n - 6]
    assert sorted(ki[1, :3].tolist()) == valid
    assert ki[1, 3:].tolist() == [j for j in range(k + 3) if j not in valid][:k - 3]


@pytest.mark.parametrize("k", [200, 800])
def test_de_shape_kernel_matches_plain(dev, k):
    """The dual-encoder first stage's shape: k_q = d = 16 (half of one
    32-deep chunk, zero-padded) over the (d, N) transposed item
    embeddings, k = 200 (rerank) and 800 (the hybrid's shortlist)."""
    g = torch.Generator(device=dev)
    g.manual_seed(k)
    q = torch.randn((100, 16), generator=g, device=dev)
    items_t = torch.randn((16, 200_003), generator=g, device=dev)
    kv, ki = approx_topk_op(q, items_t, None, k, n_valid=200_000)
    pv, pi = approx_topk_op(q, items_t, None, k, n_valid=200_000, impl="torch")
    assert_topk_agree(ki, kv, pi, pv, dense_scores(q, items_t, n_valid=200_000))
    assert (ki < 200_000).all()


def test_large_k_is_refused_above_1024(dev):
    e, r, _, _, _ = topk_inputs(dev, b=4, k_q=32, n=3000)
    with pytest.raises(ValueError, match="1024"):
        approx_topk_op(e, r, None, 1025)
    with pytest.raises(ValueError, match="256"):
        persistent_round_op(e, r, k_sample=257)


def _max_err(vals, ids, exact, live=None):
    """Worst |reported value - float64 value of its id| over live entries
    (those ``vals`` reports above NEG_INF, unless ``live`` is given)."""
    v = vals.double().cpu()
    live = v > NEG_INF / 2 if live is None else live.cpu()
    return (v - exact.gather(1, ids.long().cpu())).abs()[live].max().item()


@pytest.mark.parametrize("seed", NEAR_FULL_SEEDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_sweep_near_full_selection_is_as_accurate_as_fp32(dev, dtype, seed):
    """(B, k_q, N) = (33, 500, 257) with k = 256 selects nearly every valid
    item, values near 0 among them.  There the comparator's bar,
    TOPK_RTOL x max(|v|, 1), is 1e-5 absolute against partial sums of size
    ~20, finer than fp32 summation itself: the plain version on the card
    (cuBLAS) and on the CPU already fail topk_report against each other.
    So the kernel is held to float64 instead: its worst error is no larger
    than that of cuBLAS fp32 on the dequantized payload (what a caller
    without the kernel would run: ``e_q @ dequantize(payload)``, the payload
    itself for fp32); every row has fewer than k valid items, and its list
    holds all of them, values non-increasing, then the lowest suppressed
    ids, ascending.  Seeds: the test's original one (b + k_q + k = 789) and
    0-7, so an unlucky draw cannot hide a payload's error."""
    b, k_q, n, k = 33, 500, 257, 256
    e, r, noise, mask, anchors = ragged_topk_inputs(dev, b, k_q, n, seed=seed)
    pay = as_payload(r, dtype)
    kw = dict(noise=noise, mask=mask, n_valid=n - 5)
    kv, ki = approx_topk_op(e, pay, anchors, k, **kw)
    pv, pi = approx_topk_op(e, pay, anchors, k, impl="torch", **kw)
    cpu = {key: t.cpu() for key, t in kw.items() if key != "n_valid"}
    cv, ci = approx_topk_op(e.cpu(), pay.to("cpu"), anchors.cpu(), k, impl="torch",
                            n_valid=n - 5, **cpu)
    witness = topk_report(pi, pv, ci, cv, dense_scores(e, pay, anchors, **kw))
    assert not witness["ok"], f"two fp32 orders agree to the bar here: {witness}"

    coded = isinstance(pay, QuantizedRanc)
    codes = unpacked_codes(pay) if coded else pay
    exact = (e.double() @ codes.double()).cpu()
    if coded:
        exact = exact * pay.col_scales().double().cpu()[None, :]
    exact += noise.double().cpu()
    exact[(dense_scores(e, pay, anchors, **kw) <= NEG_INF / 2).cpu()] = NEG_INF
    dense = dequantize(pay) if coded else pay.float()
    cublas = torch.matmul(e, dense) + noise
    err_kernel, err_plain = _max_err(kv, ki, exact), _max_err(pv, pi, exact)
    err_cublas = _max_err(cublas.gather(1, ki.long()), ki, exact, live=kv > NEG_INF / 2)
    print(f"{dtype}: worst error against float64: kernel {err_kernel:.4g}, cuBLAS fp32 "
          f"on the dequantized payload {err_cublas:.4g}, plain version {err_plain:.4g}")
    assert err_kernel <= err_cublas, (err_kernel, err_cublas)
    for row in range(b):
        live = torch.nonzero(exact[row] > NEG_INF / 2).flatten().tolist()
        dead = [j for j in range(n) if j not in set(live)]
        ids, head = ki[row].tolist(), kv[row, :len(live)].cpu()
        assert len(live) < k
        assert sorted(ids[:len(live)]) == live
        assert ids[len(live):] == dead[:k - len(live)]
        assert bool((head[1:] <= head[:-1]).all())
    (sv, si), _ = persistent_round_op(e, pay, k_sample=k, k_prov=k, anchors=anchors,
                                      prov_mask=mask, **kw)
    assert torch.equal(sv, kv) and torch.equal(si, ki)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sweep_error_is_below_cublas_at_k_q_500(dev, dtype):
    """At k_q = 500 over 4,096 items the kernel's top-256 values are closer
    to float64 than cuBLAS fp32's on the dequantized payload, in the worst
    entry, for every payload (0.16-0.33x over 8 seeds on an H100; at the
    near-full shape above the two are level and the worst entry falls
    either way, 0.5-1.3x for every payload including fp32)."""
    for seed in range(3):
        e, r, _, _, _ = topk_inputs(dev, b=256, k_q=500, n=4096, seed=seed)
        pay = as_payload(r, dtype)
        coded = isinstance(pay, QuantizedRanc)
        exact = (e.double() @ (unpacked_codes(pay) if coded else pay).double()).cpu()
        if coded:
            exact *= pay.col_scales().double().cpu()[None, :]
        kv, ki = approx_topk_op(e, pay, None, 256)
        cublas = torch.matmul(e, dequantize(pay) if coded else pay.float())
        err_kernel = _max_err(kv, ki, exact)
        err_cublas = _max_err(cublas.gather(1, ki.long()), ki, exact)
        assert err_kernel <= err_cublas, (seed, err_kernel, err_cublas)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sweep_exact_ties_go_to_the_lower_id(dev, dtype):
    """Duplicated payload columns score exactly equal in every tile, warp
    and block; the lower id must win, as in the plain version."""
    e, r, _, _, _ = topk_inputs(dev, b=70, k_q=500, n=20000, seed=5)
    e = e.abs()
    r[:, 10] = r[:, 10].abs() + 3.0
    for lo, hi in ((700, 760), (9000, 9003), (19990, 20000)):
        r[:, lo:hi] = r[:, 10:11]
    pay = as_payload(r, dtype, 256)
    kv, ki = approx_topk_op(e, pay, None, 80)
    pv, pi = approx_topk_op(e, pay, None, 80, impl="torch")
    assert_topk_agree(ki, kv, pi, pv, dense_scores(e, pay))
    assert torch.equal(ki, pi)
    if dtype in ("float32", "bfloat16"):
        assert ki[:, 0].tolist() == [10] * 70 and ki[:, 1].tolist() == [700] * 70
    (sv, si), (qv, qi) = persistent_round_op(e, pay, k_sample=80, k_prov=3)
    qv2, qi2 = approx_topk_op(e, pay, None, 3)
    assert torch.equal(si, ki) and torch.equal(sv, kv)
    assert torch.equal(qi, qi2) and torch.equal(qv, qv2)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sweep_takes_a_long_k_q(dev, dtype):
    """e_q streams through the ring chunk by chunk, so k_q has no limit."""
    e, r, noise, mask, anchors = topk_inputs(dev, b=70, k_q=2000, n=3000, seed=9)
    pay = as_payload(r, dtype)
    kv, ki = approx_topk_op(e, pay, anchors, 50, noise=noise, mask=mask)
    pv, pi = approx_topk_op(e, pay, anchors, 50, noise=noise, mask=mask, impl="torch")
    assert_topk_agree(ki, kv, pi, pv, dense_scores(e, pay, anchors, noise=noise, mask=mask))


def _offset_copy(t, offset_bytes):
    """``t``'s values in a contiguous tensor whose storage starts
    ``offset_bytes`` past a 16-byte boundary (a byte-offset view)."""
    unit = t.element_size()
    flat = torch.zeros(t.numel() + 32 // unit, dtype=t.dtype, device=t.device)
    view = flat[offset_bytes // unit: offset_bytes // unit + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == offset_bytes
    return view


@pytest.mark.parametrize("dtype", DTYPES)
def test_sweep_reads_a_byte_offset_payload(dev, dtype):
    """A payload whose rows do not start 16-byte aligned (its storage a
    view at an offset of one element, one byte for the codes) takes the
    unit-wise loader and gives the aligned payload's lists bit for bit."""
    e, r, noise, mask, anchors = topk_inputs(dev, b=40, k_q=70, n=4096, seed=13)
    pay = as_payload(r, dtype)
    if isinstance(pay, QuantizedRanc):
        moved = QuantizedRanc(_offset_copy(pay.codes, 1), pay.scales, pay.tile,
                              pay.code_dtype, pay.n_cols)
    else:
        moved = _offset_copy(pay, pay.element_size())
    kw = dict(noise=noise, mask=mask, n_valid=4000)
    kv, ki = approx_topk_op(e, pay, anchors, 30, **kw)
    mv, mi = approx_topk_op(e, moved, anchors, 30, **kw)
    assert torch.equal(kv, mv) and torch.equal(ki, mi)
    (sv, si), (pv, pi) = persistent_round_op(e, moved, k_sample=30, k_prov=10, anchors=anchors,
                                             prov_mask=mask, **kw)
    assert torch.equal(sv, kv) and torch.equal(si, ki)
    bv, bi = approx_topk_op(e, pay, None, 10, mask=mask, n_valid=4000)
    assert torch.equal(pv, bv) and torch.equal(pi, bi)


def test_sweep_decodes_fp8_and_int4_exactly(dev):
    """Every fp8 e4m3 code (subnormals, +-0, +-448; no NaN) and every int4
    nibble decodes to its exact value: with e_q one-hot on payload row 0
    and a scale of 1, a column scores its code, and k = N returns them all."""
    k_q = 8
    grid = torch.arange(256, dtype=torch.int32)
    row = grid[(grid & 0x7F) != 0x7F].to(torch.uint8)                   # 254 codes
    row = torch.cat([row, torch.tensor([0x38, 0xB8], dtype=torch.uint8)])   # +-1 to fill 256
    fp8 = torch.zeros((k_q, 256), dtype=torch.uint8)
    fp8[0] = row
    nib = torch.arange(64) % 16 - 8
    packed = torch.zeros((k_q, 32), dtype=torch.uint8)
    packed[0] = ((nib[0::2] & 0xF) | ((nib[1::2] & 0xF) << 4)).to(torch.uint8)
    one = torch.ones(1)
    cases = ((QuantizedRanc(fp8.view(torch.float8_e4m3fn), one, 512, "fp8"),
              row.view(torch.float8_e4m3fn).float()),
             (QuantizedRanc(packed, one, 512, "int4"), nib.float()))
    e = torch.zeros((1, k_q), device=dev)
    e[0, 0] = 1.0
    for pay, want in cases:
        n = want.numel()
        kv, ki = approx_topk_op(e, pay.to(dev), None, n)
        assert sorted(ki[0].tolist()) == list(range(n))
        got = torch.empty(n)
        got[ki[0].long().cpu()] = kv[0].cpu()
        assert torch.equal(got, want), (got - want).abs().max()
    assert want.abs().max() == 8 and cases[0][1].abs().max() == 448


def test_topk_kernels_do_not_spill(dev):
    """ptxas reports no spill for any instantiation of the sweep (5 payload
    kinds x {k <= 256, large k} in approx_topk, 5 x {1, 2} lists in
    persistent_round)."""
    build.build_all()
    for name, n_sweeps in (("approx_topk", 10), ("persistent_round", 10)):
        log = build.build_info[name]["ptxas"]
        entries = re.findall(r"Compiling entry function '(_ZN6adacur12sweep_kernel[^']*)'", log)
        assert len(set(entries)) == n_sweeps, sorted(set(entries))
        spills = re.findall(r"([1-9][0-9]*) bytes spill", log)
        assert not spills, f"{name}: {spills}"


def test_engine_on_the_card_matches_the_cpu(dev):
    """The early-exit persistent loop (software-pipelined, both lists per
    sweep) on the card and on the CPU.  It uses the full regularized pinv,
    which is stable under rounding (``test_torch_engine.py::
    test_full_pinv_search_is_stable_under_rounding``): the incremental
    bordered update amplifies fp32 rounding, and with it the card's and the
    CPU's top-k overlap came out at 0.9885 on a domain of 100 anchor
    queries."""
    from repro_torch.configs.base import AdaCURConfig
    from repro_torch.core import prng
    from repro_torch.core.engine import engine_search
    from repro_torch.core.index import AnchorIndex
    from repro_torch.core.scorer import SyntheticScorer
    from repro_torch.data.synthetic import make_synthetic_ce
    from repro_torch.testing import topk_overlap

    ce = make_synthetic_ce(prng.PRNGKey(4), n_queries=232, n_items=3000, device="cpu")
    idx = AnchorIndex.build(ce.score_block, torch.arange(200), torch.arange(3000))
    cfg = AdaCURConfig(k_anchor=40, n_rounds=8, budget_ce=80, k_retrieve=30,
                       loop_mode="fori", use_fused_topk=True, round_kernel="persistent",
                       early_exit_tol=0.5, incremental_pinv=False)
    q = torch.arange(200, 232)
    cpu = engine_search(SyntheticScorer(ce), idx.r_anc, q, cfg, prng.PRNGKey(3))
    kernels.reset_launches()
    card = engine_search(SyntheticScorer(ce.to(dev)), idx.r_anc.to(dev), q.to(dev), cfg,
                         prng.PRNGKey(3))
    assert card.rounds_done == cpu.rounds_done < cfg.n_rounds
    assert kernels.launch_counts() == {"approx_topk": 1, "persistent_round": card.rounds_done,
                                       "flash_attention": 0, "embedding_bag": 0,
                                       "embedding_bag_backward": 0}
    assert topk_overlap(cpu.topk_idx, card.topk_idx) >= 0.99
    assert np.isfinite(card.topk_scores.cpu().numpy()).all()


@pytest.mark.parametrize("rows", BATCH_BITS_ROWS)
def test_estimate_state_rows_do_not_depend_on_their_batch(dev, rows):
    """The engine's per-row estimate math (the first block's pinv, the
    bordered update, e_q) at the serving shapes (k_q 500, 100 anchors in
    rounds of 20): each row of a 256-row batch, computed in calls of
    ``rows`` rows (the last call holds the rest), has the bits it has in
    the whole batch.  The sharded
    engine's bitwise contract rests on it: a data shard computes its rows
    alone."""
    differ = {name: rows_differing(fn, xs, rows)
              for name, (fn, xs) in estimate_state_calls(dev).items()}
    assert differ == dict.fromkeys(differ, 0), f"entries differing in calls of {rows} rows"


@pytest.mark.parametrize("rows", [1, 2, 3, 16, 17, 37, 64, 100, 128, 200])
def test_synthetic_scores_do_not_depend_on_their_batch(dev, rows):
    """``SyntheticCE.score_pairs`` (256 rows of 100 items): each row scored
    in calls of ``rows`` rows has the bits it has in one 256-row call, so a
    data shard's scores are the single-device engine's."""
    fn, xs = synthetic_pair_call(dev)
    assert rows_differing(fn, xs, rows) == 0


# flash attention: (B, Lq, Lk, H, KV, hd, causal, kv_lens) at small sizes;
# tolerances: repro_torch.testing.FLASH_TOL, as in chip_smoke.py
FLASH_CASES = {
    "ce": (16, 64, 64, 8, 4, 32, False, [43] * 13 + [0] * 3),
    "gqa4-hd128": (2, 256, 256, 8, 2, 128, True, [256, 131]),
    "gqa4-hd128-bidir": (2, 256, 256, 8, 2, 128, False, [256, 131]),
    "decode-chunk": (2, 64, 192, 4, 2, 64, True, None),
    "mqa-hd16-ragged": (3, 100, 100, 4, 1, 16, False, [100, 1, 57]),
    # Qwen3-8B's attention widths (32/8 heads, hd 128) at L 1024
    "qwen3-8b-width": (2, 1024, 1024, 32, 8, 128, True, [1024, 683]),
    "qwen3-8b-width-bidir": (2, 1024, 1024, 32, 8, 128, False, [1024, 683]),
    # L not a multiple of any tile, one example of length 1 and one of 0
    "ragged-l100": (4, 100, 100, 8, 2, 64, True, [100, 1, 57, 0]),
    # a decode chunk of 37 rows against 300 keys, ragged lengths
    "decode-chunk-ragged": (3, 37, 300, 8, 2, 64, True, [300, 200, 37]),
    "all-zero-lens": (2, 64, 64, 8, 4, 32, False, [0, 0]),
    # H / KV odd: one head and two 64-row slices a CTA in the bf16 kernel
    "mha-hd32-two-slices": (2, 200, 200, 4, 4, 32, True, [200, 150]),
    "gqa3-hd32": (2, 80, 80, 6, 2, 32, False, None),
    # 128 key tiles: the bf16 kernel adds each tile's P V to O with a rounded
    # fma; accumulating it in the tensor core's truncated sums instead
    # misses the tolerance at this length
    "long-l8192": (1, 8192, 8192, 8, 2, 128, False, None),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_kernel_matches_plain(dev, case, dtype):
    b, lq, lk, h, kv, hd, causal, lens = FLASH_CASES[case]
    g = torch.Generator(device=dev)
    g.manual_seed(sorted(FLASH_CASES).index(case))
    dt = getattr(torch, dtype)
    q = torch.randn((b, lq, h, hd), generator=g, device=dev).to(dt)
    k = torch.randn((b, lk, kv, hd), generator=g, device=dev).to(dt)
    v = torch.randn((b, lk, kv, hd), generator=g, device=dev).to(dt)
    kv_lens = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=dev)
    before = kernels.launch_counts()["flash_attention"]
    out = flash_attention(q, k, v, causal=causal, kv_lens=kv_lens)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == before + 1
    ref = flash_attention_plain(q, k, v, causal=causal, kv_lens=kv_lens)
    assert out.dtype == dt and out.shape == q.shape
    atol, rtol = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    for i, n in enumerate(lens or []):
        if n == 0:
            assert torch.count_nonzero(out[i]) == 0


def test_flash_kernel_reads_strided_operands(dev):
    """q, k and v as head slices of one packed (B, L, H + 2 KV, hd) tensor:
    the kernel reads them through their strides."""
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    qkv = torch.randn((4, 64, 16, 32), generator=g, device=dev)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:12], qkv[:, :, 12:]
    assert not q.is_contiguous()
    lens = torch.tensor([64, 43, 0, 9], dtype=torch.int32, device=dev)
    out = flash_attention(q, k, v, causal=False, kv_lens=lens)
    ref = flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(), causal=False,
                                kv_lens=lens)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


def test_bf16_flash_kernel_reads_strided_operands(dev):
    """The same packed QKV in bf16: 16-byte aligned head slices, which the
    tensor-core kernel's cp.async reads in place."""
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    qkv = torch.randn((4, 64, 16, 32), generator=g, device=dev).to(torch.bfloat16)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:12], qkv[:, :, 12:]
    assert not q.is_contiguous() and all(flash_kernel._readable(t) for t in (q, k, v))
    lens = torch.tensor([64, 43, 0, 9], dtype=torch.int32, device=dev)
    out = flash_attention(q, k, v, causal=False, kv_lens=lens)
    ref = flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(), causal=False,
                                kv_lens=lens)
    atol, rtol = FLASH_TOL["bfloat16"]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    assert torch.count_nonzero(out[2]) == 0


def test_bf16_flash_kernel_reads_head_major_operands(dev):
    """q, k and v as (B, L, heads, hd) views of head-major (B, heads, L, hd)
    tensors: the head stride exceeds the sequence stride, and the kernel
    still reads them in place."""
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    q, k, v = (torch.randn((2, n, 150, 64), generator=g, device=dev).to(torch.bfloat16)
               .transpose(1, 2) for n in (8, 2, 2))
    assert q.stride(2) > q.stride(1) and all(flash_kernel._readable(t) for t in (q, k, v))
    lens = torch.tensor([150, 77], dtype=torch.int32, device=dev)
    out = flash_attention(q, k, v, causal=True, kv_lens=lens)
    ref = flash_attention_plain(q, k, v, causal=True, kv_lens=lens)
    atol, rtol = FLASH_TOL["bfloat16"]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


def test_bf16_flash_kernel_copies_an_unaligned_operand(dev):
    """A bf16 operand whose base is not 16-byte aligned is copied first
    (cp.async reads 16-byte chunks); the result is the same."""
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    flat = torch.randn(2 * 64 * 4 * 32 + 1, generator=g, device=dev).to(torch.bfloat16)
    q = flat[1:].view(2, 64, 4, 32)
    k, v = (torch.randn((2, 64, 2, 32), generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    assert not flash_kernel._readable(q) and flash_kernel._readable(k)
    out = flash_attention(q, k, v, causal=True)
    ref = flash_attention_plain(q, k, v, causal=True)
    atol, rtol = FLASH_TOL["bfloat16"]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


def test_bf16_flash_kernel_addresses_past_2_gib(dev):
    """Qwen3-8B's prefill_32k attention at B = 9 (causal, 32/8 heads, hd
    128, bf16): q and the output are 2.4 GB each, past 2^31 bytes.  The
    last example's last 128 query rows (the highest addresses, the widest
    causal windows) against the plain version on that example alone."""
    g = torch.Generator(device=dev).manual_seed(3)
    b, n = 9, 32768
    q = torch.randn((b, n, 32, 128), generator=g, device=dev, dtype=torch.bfloat16)
    k, v = (torch.randn((b, n, 8, 128), generator=g, device=dev, dtype=torch.bfloat16)
            for _ in range(2))
    assert q.numel() * q.element_size() > 2 ** 31
    out = flash_attention(q, k, v, causal=True)
    ref = flash_attention_plain(q[-1:, -128:], k[-1:], v[-1:], causal=True, block_k=1024)
    atol, rtol = FLASH_TOL["bfloat16"]
    torch.testing.assert_close(out[-1:, -128:].float(), ref.float(), atol=atol, rtol=rtol)


def test_bf16_flash_kernel_runs_on_wgmma(dev):
    """Every head-dim instantiation of the bf16 kernel holds HGMMA (the
    wgmma tensor-core instruction) in the built library's SASS."""
    lib = build.build_all()["flash_attention"]
    tool = Path(build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    funcs = {}
    for part in sass.split("Function : ")[1:]:
        name, body = part.split("\n", 1)
        funcs[name.strip()] = body
    tc = {n: b for n, b in funcs.items() if "flash_tc_kernel" in n}
    assert len(tc) == len(flash_kernel.HEAD_DIMS), sorted(funcs)
    assert all(re.search(r"\bHGMMA\b", b) for b in tc.values())


def test_flash_kernel_rejects_what_it_does_not_take(dev):
    q = torch.zeros((1, 8, 2, 24), device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q, causal=False)
    q = torch.zeros((1, 8, 2, 32), device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention(q, q, q, causal=False)


def test_real_ce_search_on_the_card_matches_the_cpu(dev):
    """A real-CE search (the reduced CE of the serve CLI, fp32) on the card
    and on the CPU with the same weights and index: the card's forwards go
    through the flash kernel, n_layers launches each."""
    from repro_torch.configs.base import AdaCURConfig
    from repro_torch.core import prng
    from repro_torch.core.engine import engine_search
    from repro_torch.core.scorer import CrossEncoderScorer
    from repro_torch.device import to_device
    from repro_torch.launch.serve import build_real_ce_domain
    from repro_torch.testing import topk_overlap

    ds, params, scorer, index = build_real_ce_domain(300, 40, 16, device=dev)
    cfg = AdaCURConfig(k_anchor=20, n_rounds=4, budget_ce=60, k_retrieve=20,
                       loop_mode="fori", use_fused_topk=True)
    q = torch.arange(40, 56)
    kernels.reset_launches()
    card = engine_search(scorer, index.r_anc, q.to(dev), cfg, prng.PRNGKey(2))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["flash_attention"] == scorer.cfg.n_layers * scorer.forwards > 0
    assert counts["approx_topk"] == cfg.n_rounds
    cpu_scorer = CrossEncoderScorer(to_device(params, "cpu"), scorer.cfg, ds.pair_tokens,
                                    flash_block=(64, 64))
    cpu = engine_search(cpu_scorer, index.r_anc.cpu(), q, cfg, prng.PRNGKey(2))
    assert topk_overlap(cpu.topk_idx, card.topk_idx) >= 0.99
    assert np.isfinite(card.topk_scores.cpu().numpy()).all()


# embedding bag: (rows, dim, B, H); dim 21, and dim 36 in bf16, take the
# scalar path (a row is not a whole number of 16-byte chunks), dim 200 has a
# ragged last chunk, H = 45 two id batches of 32
BAG_CASES = {
    "dlrm-field": (4096, 128, 1000, 1),
    "multihot": (5000, 128, 700, 32),
    "wide-h": (300, 64, 50, 45),
    "dim36": (500, 36, 123, 7),
    "dim21": (500, 21, 64, 3),
    "dim200": (400, 200, 33, 5),
}
BAG_TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
           "bfloat16": dict(atol=1e-6, rtol=2.0 ** -7)}


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(BAG_CASES))
def test_bag_kernel_matches_plain(dev, case, dtype, mode):
    rows, dim, b, h = BAG_CASES[case]
    g = torch.Generator(device=dev)
    g.manual_seed(sorted(BAG_CASES).index(case))
    table = torch.randn((rows, dim), generator=g, device=dev).to(getattr(torch, dtype))
    ids = torch.randint(0, rows, (b, h), generator=g, device=dev, dtype=torch.int32)
    before = kernels.launch_counts()["embedding_bag"]
    out = embedding_bag_op(table, ids, mode)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["embedding_bag"] == before + 1
    ref = embedding_bag_plain(table, ids, mode)
    assert out.dtype == table.dtype and out.shape == (b, dim)
    torch.testing.assert_close(out.float(), ref.float(), **BAG_TOL[dtype])
    if h == 1:
        assert torch.equal(out, ref)
    with pytest.raises(ValueError, match="int32"):
        embedding_bag_op(table, ids.long(), mode)


def test_bag_kernel_takes_ids_as_jnp_take_does(dev):
    table = torch.randn((20, 128), device=dev)
    ids = torch.tensor([[3, -1], [-20, 5], [20, 1], [-21, 0]], device=dev,
                       dtype=torch.int32)
    out = embedding_bag_op(table, ids)
    ref = embedding_bag_plain(table, ids)
    torch.testing.assert_close(out[:2], ref[:2], atol=1e-5, rtol=1e-5)
    assert torch.isnan(out[2:]).all() and torch.isnan(ref[2:]).all()


def test_bag_kernel_rejects_what_it_does_not_take(dev):
    ids = torch.zeros((4, 2), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        embedding_bag_op(torch.zeros((10, 8), device=dev, dtype=torch.float16), ids)
    with pytest.raises(ValueError, match="contiguous"):
        embedding_bag_op(torch.zeros((8, 10), device=dev).t(), ids)
    with pytest.raises(ValueError, match="but the table on"):
        embedding_bag_op(torch.zeros((10, 8), device=dev), ids.cpu())


def test_dlrm_on_the_card_matches_the_cpu(dev):
    """Full-width DLRM with small tables: the lookups are bitwise equal on
    the card (26 kernel launches a forward) and on the CPU (plain)."""
    from repro_torch.configs import dlrm_mlperf
    from repro_torch.device import to_device
    from repro_torch.launch import steps
    from repro_torch.models.recsys import dlrm, embedding

    cfg = dlrm_mlperf.capped(max_rows=4096)
    params = dlrm.init_dlrm(cfg, torch.Generator().manual_seed(0), "cpu")
    ctx = steps.recsys_inputs(cfg, 64, device="cpu")
    card_params = to_device(params, dev)
    kernels.reset_launches()
    card = dlrm.forward(card_params, ctx["dense"].to(dev), ctx["sparse"].to(dev), cfg)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["embedding_bag"] == cfg.n_sparse
    cpu = dlrm.forward(params, ctx["dense"], ctx["sparse"], cfg)
    assert (card.cpu() - cpu).abs().max() <= 1e-4 * cpu.abs().max()
    assert torch.equal(embedding.lookup_all_tables(card_params["tables"],
                                                   ctx["sparse"].to(dev)).cpu(),
                       embedding.lookup_all_tables(params["tables"], ctx["sparse"]))


def _router_domain():
    """A synthetic domain (232 queries, 6,000 items), its index over anchor
    queries 0..199 on the CPU and the fused config the router tests serve."""
    from repro_torch.configs.base import AdaCURConfig
    from repro_torch.core import prng
    from repro_torch.core.index import AnchorIndex
    from repro_torch.data.synthetic import make_synthetic_ce

    ce = make_synthetic_ce(prng.PRNGKey(6), n_queries=232, n_items=6000, device="cpu")
    m = ce.full_matrix(torch.arange(232))
    idx = AnchorIndex.from_r_anc(m[:200])
    cfg = AdaCURConfig(k_anchor=40, n_rounds=4, budget_ce=80, k_retrieve=20, loop_mode="fori",
                       use_fused_topk=True, incremental_pinv=False)
    return m, idx, cfg


def _router_services(idx, scorer_matrix, cfg, n, buckets):
    from repro_torch.core.engine import AdaCURRetriever
    from repro_torch.core.scorer import TabulatedScorer
    from repro_torch.launch.serve import AdaCURService

    return [AdaCURService(retriever=AdaCURRetriever.from_index(
                idx, TabulatedScorer(scorer_matrix), cfg, anytime=True),
            max_batch=buckets[-1], max_wait_s=60.0, batch_buckets=buckets, deterministic=True)
            for _ in range(n)]


def test_router_replicas_on_their_streams_match_the_cpu_router(dev):
    """Two replicas sharing one card index, each on its own stream, answer
    as the same router over CPU services: deterministic services with
    bucket [1] make each answer a function of its query alone, so the
    tickets compare one to one (top-k overlap >= 0.99, the card-vs-CPU
    bar), and approx_topk ran from the replica threads."""
    from repro_torch.launch.router import Router
    from repro_torch.testing import topk_overlap

    m, idx, cfg = _router_domain()
    qids = [int(q) for q in np.random.default_rng(0).integers(200, 232, 48)]
    outs = {}
    for name, index, matrix in (("cpu", idx, m), ("card", idx.to(dev), m.to(dev))):
        router = Router(_router_services(index, matrix, cfg, 2, [1]), queue_limit=128)
        try:
            if name == "card":
                assert all(rep.stream is not None for rep in router.replicas)
                assert len({rep.stream.cuda_stream for rep in router.replicas}) == 2
                kernels.reset_launches()
            tickets = [router.submit(q) for q in qids]
            outs[name] = [router.result(t, timeout=300) for t in tickets]
            if name == "card":
                launched = kernels.launch_counts()["approx_topk"]
        finally:
            router.close()
        assert all(o is not None and o.status == "ok" for o in outs[name])
        assert router.stats["ok"] == len(qids)
    assert launched >= len(qids) * (cfg.n_rounds - 1)
    assert {o.replica for o in outs["card"]} == {0, 1}
    card = np.stack([o.response.item_ids for o in outs["card"]])
    cpu = np.stack([o.response.item_ids for o in outs["cpu"]])
    assert topk_overlap(card, cpu) >= 0.99


def test_router_swap_midflight_on_the_card_keeps_namespaces(dev):
    """swap_index from the main thread while two threads submit to a
    two-replica card router: no response mixes the old (0..N-1) and new
    (N..2N-1) namespaces, every request submitted after the swap returned
    is answered in the new one, and no new-namespace answer holds an id
    the new index removed."""
    from repro_torch.launch.router import Router

    m, idx, cfg = _router_domain()
    n = idx.n_items
    wide = torch.cat([m, m], dim=1).to(dev)
    card_idx = idx.to(dev)
    removed = torch.arange(n, 2 * n, 100, dtype=torch.int32)
    new_idx = dataclasses.replace(card_idx, item_ids=card_idx.item_ids + n).remove_items(
        removed.to(dev))
    router = Router(_router_services(card_idx, wide, cfg, 2, [4, 8]), queue_limit=512)
    swapped = threading.Event()
    seen, lock, stop = [], threading.Lock(), threading.Event()

    def submitter(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            after = swapped.is_set()
            tk = router.submit(int(rng.integers(200, 232)))
            with lock:
                seen.append((tk, after))
            time.sleep(0.005)

    threads = [threading.Thread(target=submitter, args=(s,)) for s in range(2)]
    try:
        for t in threads:
            t.start()
        time.sleep(1.0)
        router.swap_index(new_idx)
        swapped.set()
        time.sleep(1.0)
        stop.set()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        outs = [(router.result(tk, timeout=300), after) for tk, after in seen]
    finally:
        router.close()
    removed_set = set(removed.tolist())
    assert all(out is not None and out.status in ("ok", "rejected") for out, _ in outs)
    outs = [(out, after) for out, after in outs if out.status == "ok"]
    assert sum(after for _, after in outs) > 0 and sum(not after for _, after in outs) > 0
    for out, after in outs:
        ids = out.response.item_ids
        old, new = (ids < n).all(), (ids >= n).all()
        assert old or new, "mixed-namespace response"
        assert new or not after, "a request submitted after the swap saw the old index"
        if new:
            assert not set(ids.tolist()) & removed_set


# the bag's backward: (rows, dim, B, H); "few-rows" puts hundreds of lookups
# on each row (runs cut across many windows), dim 36 and 21 take the scalar
# path, dim 200 a ragged last chunk; "criteo-3rows" is Criteo field 5's
# table at train_batch (~21,845 lookups a row), "heavy-h8" a multi-hot bag
# (H = 8) whose rows span hundreds of windows
BAG_BWD_CASES = {
    "dlrm-field": (1 << 20, 128, 65536, 1),
    "few-rows": (7, 128, 5000, 3),
    "multihot": (5000, 128, 700, 32),
    "dim36": (500, 36, 123, 7),
    "dim21": (64, 21, 300, 2),
    "dim200": (400, 200, 33, 5),
    "criteo-3rows": (3, 128, 65536, 1),
    "heavy-h8": (5, 64, 4096, 8),
}


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(BAG_BWD_CASES))
def test_bag_backward_kernel_matches_plain(dev, case, dtype, mode):
    """The backward kernel against its plain version (``index_add_`` in
    lookup order): within 1e-5 of the largest |grad| (a row's lookups add in
    another grouping), bitwise equal to ``ref.embedding_bag_backward_emulated``
    (the kernel's own order; compared as bits, so -0.0 against +0.0 fails),
    two calls bitwise equal (no atomics), untouched rows zero, one launch
    counted a call; grad_out in the table's dtype."""
    from repro_torch.kernels.embedding_bag.kernel import embedding_bag_backward_cuda
    from repro_torch.kernels.embedding_bag.ref import (
        embedding_bag_backward_emulated, embedding_bag_backward_plain)

    rows, dim, b, h = BAG_BWD_CASES[case]
    g = torch.Generator(device=dev)
    g.manual_seed(sorted(BAG_BWD_CASES).index(case))
    grad = torch.randn((b, dim), generator=g, device=dev).to(getattr(torch, dtype))
    ids = torch.randint(-rows, rows, (b, h), generator=g, device=dev, dtype=torch.int32)
    ids[0, 0] = rows + 3                      # dropped, as jnp.take's scatter drops it
    before = kernels.launch_counts()["embedding_bag_backward"]
    out = embedding_bag_backward_cuda(grad, ids, rows, mode)
    again = embedding_bag_backward_cuda(grad, ids, rows, mode)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["embedding_bag_backward"] == before + 2
    ref = embedding_bag_backward_plain(grad, ids, rows, mode)
    emu = embedding_bag_backward_emulated(grad, ids, rows, mode)
    assert out.dtype == torch.float32 and out.shape == (rows, dim)
    assert torch.equal(out.view(torch.int32), again.view(torch.int32))
    assert torch.equal(out.view(torch.int32), emu.view(torch.int32))
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    touched = torch.zeros(rows, dtype=torch.bool, device=dev)
    keys = ids.long() % rows
    touched[keys[(ids >= -rows) & (ids < rows)]] = True
    assert not out[~touched].any()


def test_bag_backward_takes_strided_operands(dev):
    """A column-major grad_out, a stride-0 (expanded) one and a column slice
    of the ids give the bits of their contiguous copies."""
    from repro_torch.kernels.embedding_bag.kernel import embedding_bag_backward_cuda

    rows, dim, b, h = 300, 64, 2000, 4
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    col_major = torch.randn((dim, b), generator=g, device=dev).t()
    expanded = torch.randn((), generator=g, device=dev).expand(b, dim)
    ids = torch.randint(0, rows, (b, 2 * h), generator=g, device=dev, dtype=torch.int32)[:, ::2]
    for grad in (col_major, expanded, col_major.to(torch.bfloat16)):
        for mode in ("sum", "mean"):
            out = embedding_bag_backward_cuda(grad, ids, rows, mode)
            want = embedding_bag_backward_cuda(grad.contiguous(), ids.contiguous(), rows, mode)
            assert torch.equal(out.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("rows", [3, 512, 1 << 22])
def test_bag_backward_runs_only_its_own_kernels(dev, rows):
    """One backward call under torch.profiler runs the port's own kernels
    (``bag_bwd::``) and nothing else: no fill or zero kernel, no memset, no
    library sort.  2^22 rows takes the path whose zero rows run on the
    caller's stream beside the rest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.embedding_bag.kernel import embedding_bag_backward_cuda

    g = torch.Generator(device=dev)
    g.manual_seed(rows)
    grad = torch.randn((65536, 128), generator=g, device=dev)
    ids = torch.randint(0, rows, (65536, 1), generator=g, device=dev, dtype=torch.int32)
    embedding_bag_backward_cuda(grad, ids, rows)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        embedding_bag_backward_cuda(grad, ids, rows)
        torch.cuda.synchronize()
    names = {ev.name for ev in prof.events() if ev.device_type == DeviceType.CUDA}
    names -= {"Command Buffer Full", "Buffer Flush", "Activity Buffer Request"}
    assert names and all("bag_bwd::" in n for n in names), sorted(names)
    assert not any(re.search(r"(?i)fill|zero|sort|memset", n.replace("bag_bwd::", ""))
                   for n in names), sorted(names)


def test_bag_op_gradient_on_the_card_matches_the_cpu(dev):
    """``embedding_bag_op`` under autograd: the table's gradient on the card
    (the backward kernel) against the CPU's (plain), for sum and mean."""
    for mode in ("sum", "mean"):
        gen = torch.Generator().manual_seed(5)
        table = torch.randn((300, 64), generator=gen)
        ids = torch.randint(0, 300, (2000, 4), generator=gen, dtype=torch.int32)
        w = torch.randn((2000, 64), generator=gen)
        grads = []
        for d in ("cpu", dev):
            t = table.to(d).detach().requires_grad_()
            (embedding_bag_op(t, ids.to(d), mode) * w.to(d)).sum().backward()
            grads.append(t.grad.cpu())
        assert (grads[0] - grads[1]).abs().max() <= 1e-5 * grads[0].abs().max()


def test_bag_backward_rejects_what_it_does_not_take(dev):
    from repro_torch.kernels.embedding_bag.kernel import embedding_bag_backward_cuda

    ids = torch.zeros((4, 2), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        embedding_bag_backward_cuda(torch.zeros((4, 8), device=dev), ids.long(), 10)
    with pytest.raises(ValueError, match="CUDA"):
        embedding_bag_backward_cuda(torch.zeros((4, 8), device=dev), ids.cpu(), 10)


@pytest.mark.parametrize("kernel", ["flash_attention", "approx_topk", "persistent_round"])
def test_forward_only_kernels_refuse_autograd(dev, kernel):
    """A kernel with no backward raises on an input that requires grad under
    grad mode (instead of a result with no grad_fn), runs under
    ``torch.no_grad()``; its plain version stays differentiable on the
    CPU."""
    q = torch.randn((2, 64, 4, 32), device=dev)
    kv = torch.randn((2, 64, 2, 32), device=dev)
    e = torch.randn((4, 64), device=dev)
    r = torch.randn((64, 4096), device=dev)
    calls = {"flash_attention": (lambda x: flash_attention(x, kv, kv, causal=False), q),
             "approx_topk": (lambda x: approx_topk_op(x, r, None, 8), e),
             "persistent_round": (lambda x: persistent_round_op(x, r, k_sample=8, k_prov=8), e)}
    fn, x = calls[kernel]
    x = x.requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        fn(x)
    with torch.no_grad():
        fn(x)
    torch.cuda.synchronize()
    if kernel == "flash_attention":
        xc = x.detach().cpu().requires_grad_()
        out = flash_attention(xc, kv.cpu(), kv.cpu(), causal=False)
        out.sum().backward()
        assert xc.grad is not None


def test_dlrm_train_steps_on_the_card_match_the_cpu(dev):
    """Three full-width DLRM train steps (tables capped at 4,096 rows, B =
    256) on the card (bag kernels forward and backward, 26 each a step) and
    on the CPU (plain): losses within 1e-5 relative, parameters within 1e-5
    of the largest |parameter|; TF32 is off."""
    from repro_torch.configs import dlrm_mlperf
    from repro_torch.configs.base import RecSysShape
    from repro_torch.launch import steps
    from repro_torch.models.recsys import dlrm
    from repro_torch.tree import leaves, tree_map

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dlrm_mlperf.capped(max_rows=4096)
    init = dlrm.init_dlrm(cfg, torch.Generator().manual_seed(0), "cpu")
    batches = [steps.recsys_train_inputs(cfg, 256, seed=i, device="cpu") for i in range(3)]
    out = {}
    for d in ("cpu", dev):
        params = tree_map(lambda t: t.to(d).clone(), init)
        bundle = steps.build_recsys_train("dlrm-mlperf", cfg, RecSysShape("t", "train", 1),
                                          params=params)
        p, s = bundle.args[0], bundle.args[1]
        kernels.reset_launches()
        losses = []
        for b in batches:
            p, s, met = bundle.step(p, s, {k: v.to(d) for k, v in b.items()})
            losses.append(float(met["loss"]))
        out[str(d)] = (p, losses, kernels.launch_counts())
    (hp, hl, _), (cp, cl, counts) = out["cpu"], out[str(dev)]
    assert counts["embedding_bag"] == counts["embedding_bag_backward"] == 3 * cfg.n_sparse
    assert all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(cl, hl))
    top = max(float(t.detach().abs().max()) for t in leaves(hp))
    for a, b in zip(leaves(cp), leaves(hp)):
        assert float((a.detach().cpu() - b.detach()).abs().max()) <= 1e-5 * top


# ---------------------------------------------------------------------------
# the LM family: decode attention, the MoE combine, prefill and decode
# ---------------------------------------------------------------------------


def test_decode_attention_keeps_a_bf16_cache_in_bf16(dev):
    """``decode_attention_local`` over a bf16 cache (B = 2, 65,536 entries,
    8 KV heads of 128: 537 MB for k and v) makes no fp32 copy of it: the
    peak device memory of the call stays below 1.5x the cache.  Its result
    is the fp32 computation's on the same values within bf16 rounding of p
    (2^-7 of the largest |output|), as the reference rounds p."""
    from repro_torch.models import layers

    g = torch.Generator(device=dev).manual_seed(0)
    k = torch.randn((2, 65536, 8, 128), generator=g, device=dev).bfloat16()
    v = torch.randn((2, 65536, 8, 128), generator=g, device=dev).bfloat16()
    q = torch.randn((2, 32, 128), generator=g, device=dev).bfloat16()
    cache_bytes = 2 * k.numel() * k.element_size()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    num, den, m = layers.decode_attention_local(q, k, v, 0, 60000)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() < 1.5 * cache_bytes
    assert num.dtype == den.dtype == m.dtype == torch.float32
    out = num / den[..., None]
    num32, den32, _ = layers.decode_attention_local(q.float(), k.float(), v.float(), 0, 60000)
    ref = num32 / den32[..., None]
    assert float((out - ref).abs().max()) <= 2 ** -7 * float(ref.abs().max())


def test_moe_combine_is_bitwise_deterministic(dev):
    """The MoE layer at granite's width (32 experts, top 8, d 1,024, bf16)
    over 4,096 tokens at capacity factor 1.0, where some expert overflows
    (checked): two calls give the same bits (the combine adds each token's
    slots in a fixed order, no float atomics), and at least 99% of the
    tokens agree with the CPU within bf16 rounding (a router near-tie, fp32
    summed in another order, may send a token elsewhere, and the capacity
    then shifts that expert's later tokens)."""
    from repro_torch.configs import granite_moe_1b_a400m
    from repro_torch.models import moe

    cfg = granite_moe_1b_a400m.CONFIG.moe
    gen = torch.Generator().manual_seed(0)
    params = moe.moe_init(gen, 1024, cfg, dtype=torch.bfloat16)
    x = torch.randn((4096, 1024), generator=gen).bfloat16()
    top_e, _, _ = moe._route(params, x, cfg)
    assert torch.bincount(top_e.reshape(-1)).max() > moe._capacity(4096, cfg, 1.0)
    card = {k: (v.to(dev) if torch.is_tensor(v) else {n: w.to(dev) for n, w in v.items()})
            for k, v in params.items()}
    a, aux_a = moe.moe_apply_local(card, x.to(dev), cfg, 1.0)
    b, aux_b = moe.moe_apply_local(card, x.to(dev), cfg, 1.0)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    cpu, _ = moe.moe_apply_local(params, x, cfg, 1.0)
    row_err = (a.cpu().float() - cpu.float()).abs().amax(1)
    assert float((row_err <= 2 ** -6 * float(cpu.float().abs().max())).float().mean()) >= 0.99


@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-moe-1b-a400m", "moonshot-v1-16b-a3b"])
def test_lm_prefill_and_decode_on_the_card_match_the_cpu(dev, arch):
    """``build_lm_prefill`` (flash kernel) and eight ``decode_step`` calls
    on the card against the CPU (plain versions) at ``smoke_config`` width
    (fp32, TF32 off): the last logits and every decode step's logits within
    1e-4 of the largest |logit|, the flash kernel launched once a layer."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import LMShape
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.tree import tree_map

    cfg = registry.smoke_config(arch)
    init = transformer.init_lm(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(3, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(1))
    out = {}
    for d in ("cpu", dev):
        params = tree_map(lambda t: t.to(d), init)
        b = steps.build_lm_prefill(arch, cfg, LMShape("p", "prefill", 32, 2), params=params,
                                   device=d)
        kernels.reset_launches()
        last, cache = b.step(params, tokens[:, :32].to(d).int())
        flash = kernels.launch_counts()["flash_attention"]
        full = transformer.init_cache(cfg, 2, 40, device=d)
        for part in cache:
            for c, f in zip(cache[part], full[part]):
                f["k"][:, :32], f["v"][:, :32] = c["k"], c["v"]
        steps_out = [transformer.decode_step(params, full, tokens[:, t].to(d), t, cfg)[0]
                     for t in range(32, 40)]
        out[str(d)] = (last, steps_out, flash)
    (hl, hs, _), (cl, cs, flash) = out["cpu"], out[str(dev)]
    assert flash == cfg.n_layers
    top = float(hl.abs()[:, :cfg.vocab_size].max())
    for a, b in zip([cl] + cs, [hl] + hs):
        assert float((a.cpu() - b)[:, :cfg.vocab_size].abs().max()) <= 1e-4 * max(top, 1.0)
