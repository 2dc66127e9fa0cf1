"""Comparators shared by the port's tests and ``chip_smoke.py``, and the
seeded top-k inputs of the card tests (``topk_inputs``, ``ragged_topk_inputs``).

Two (B, k) top-k lists are held against each other and against ``scores``,
the (B, N) dense values every id should carry (noise added, suppressed
entries at ``NEG_INF``: ``kernels.approx_topk.ref.dense_scores``):

- ids lie in ``[0, N)`` and are distinct within each row;
- the two lists' values agree position by position;
- each id's dense value equals the value its list reports at that position.

All closeness is ``rtol = 1e-5`` relative to max(|a|, |b|, 1).  Two fp32
contractions summed in different orders (BLAS vs the CUDA kernel's fixed
k_q order vs XLA) may swap a near-tie: a differing id then passes, since
both ids carry the value of the other list at that position.  An id that is
wrong but reported with the right value (a tile-local id, an id lost in a
merge) fails the last rule.

``FLASH_TOL`` holds the flash-attention kernel to its plain version as
``|out - ref| <= atol + rtol * |ref|``.  fp32: 2e-5 both, the reference
tests' own (the same online softmax summed in another order).  bf16: both
sides compute in fp32 and round to bf16 once, so they differ by at most one
bf16 ulp (2^-8 to 2^-7 of the value) plus the fp32 difference, which the
tiny ``atol`` covers where cancellation leaves an output near zero.
"""

from __future__ import annotations

import numpy as np
import torch

TOPK_RTOL = 1e-5
FLASH_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-6, 2.0 ** -7)}   # (atol, rtol)


def _np(x):
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _close(a, b, rtol):
    return np.abs(a - b) <= rtol * np.maximum(np.maximum(np.abs(a), np.abs(b)), 1.0)


def _rescore(scores, ids):
    """scores[b, ids[b, j]] as float64 numpy, gathered where ``scores``
    lives (a card-resident field is not copied whole to the host)."""
    idx = torch.as_tensor(ids, device=scores.device, dtype=torch.int64)
    return _np(scores.gather(1, idx)).astype(np.float64)


def topk_report(ids_a, vals_a, ids_b, vals_b, scores, rtol: float = TOPK_RTOL) -> dict:
    """Agreement of two (B, k) top-k lists with each other and with the
    dense values ``scores`` (B, N), under the rules of the module doc."""
    ia, ib = _np(ids_a).astype(np.int64), _np(ids_b).astype(np.int64)
    va, vb = _np(vals_a).astype(np.float64), _np(vals_b).astype(np.float64)
    if ia.shape != ib.shape or va.shape != vb.shape or ia.shape != va.shape:
        raise ValueError(f"shape mismatch {ia.shape}/{va.shape} vs {ib.shape}/{vb.shape}")
    b, n = scores.shape
    if ia.shape[0] != b:
        raise ValueError(f"scores has {b} rows for lists of {ia.shape[0]}")
    in_range = (ia >= 0) & (ia < n) & (ib >= 0) & (ib < n)
    sa = _rescore(scores, np.clip(ia, 0, n - 1))
    sb = _rescore(scores, np.clip(ib, 0, n - 1))
    values_agree = _close(va, vb, rtol)
    ids_carry = in_range & _close(sa, va, rtol) & _close(sb, vb, rtol)
    dup_rows = sum(len(set(r)) < len(r) for lst in (ia, ib) for r in lst.tolist())
    bad = ~(values_agree & ids_carry)
    return {
        "ok": bool(not bad.any() and dup_rows == 0),
        "id_mismatches": int((ia != ib).sum()),
        "bad_positions": int(bad.sum()),
        "rows_with_duplicate_ids": int(dup_rows),
        "max_abs_err": float(np.abs(va - vb).max()) if va.size else 0.0,
    }


def assert_topk_agree(ids_a, vals_a, ids_b, vals_b, scores, rtol: float = TOPK_RTOL):
    rep = topk_report(ids_a, vals_a, ids_b, vals_b, scores, rtol)
    assert rep["ok"], f"top-k lists disagree: {rep}"
    return rep


def topk_overlap(a, b) -> float:
    """Mean per-row |set(a_i) ∩ set(b_i)| / k of two (B, k) id arrays."""
    a, b = _np(a), _np(b)
    k = a.shape[1]
    return float(np.mean([len(set(x) & set(y)) / k for x, y in zip(a.tolist(), b.tolist())]))


def topk_inputs(dev, b=40, k_q=96, n=9000, seed=0):
    """Seeded top-k operands on ``dev``: (B, k_q) e, (k_q, N) payload,
    (B, N) noise, a (B, N) suppression mask (~20% set) and (B, 30) anchors."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    e = torch.randn((b, k_q), generator=g, device=dev)
    r = torch.randn((k_q, n), generator=g, device=dev)
    noise = torch.rand((b, n), generator=g, device=dev)
    mask = torch.rand((b, n), generator=g, device=dev) < 0.2
    anchors = torch.randint(0, n, (b, 30), generator=g, device=dev, dtype=torch.int32)
    return e, r, noise, mask, anchors


def ragged_topk_inputs(dev, b, k_q, n, seed):
    """:func:`topk_inputs` with (B, 100) anchors from ``seed + 100``, row 0
    fully suppressed and row 1 left with three valid items (under-filled
    rows)."""
    e, r, noise, mask, _ = topk_inputs(dev, b, k_q, n, seed)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 100)
    anchors = torch.randint(0, n, (b, 100), generator=g, device=dev, dtype=torch.int32)
    mask[0] = True                              # row 0: nothing valid
    if b > 1:
        mask[1] = True
        mask[1, [3, n // 2, n - 6]] = False     # row 1: three valid items
        anchors[1] = n - 1
    return e, r, noise, mask, anchors


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(cmd, world: int, timeout: float, env=None) -> list:
    """Run ``cmd`` (an argv list) as ``world`` ranks of one
    ``torch.distributed`` world, each with the environment ``torchrun``
    gives a rank (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT`` on localhost).  Each rank's output goes to an unnamed
    temporary file, so no rank blocks on a full pipe while another is
    waited for.  Waits at most ``timeout`` seconds in all, then kills every
    rank still running, so a hung rank fails its caller instead of hanging
    it.  Returns ``[(returncode, stdout, stderr)]`` by rank; a killed rank's
    code is None."""
    import os
    import subprocess
    import tempfile
    import time

    base = dict(os.environ if env is None else env, MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(free_port()), WORLD_SIZE=str(world))
    files = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")) for _ in range(world)]
    procs = [subprocess.Popen(cmd, env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=o, stderr=e, text=True)
             for r, (o, e) in enumerate(files)]
    end = time.monotonic() + timeout
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=max(0.1, end - time.monotonic())))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            codes.append(None)
    out = []
    for rc, (o, e) in zip(codes, files):
        o.seek(0)
        e.seek(0)
        out.append((rc, o.read(), e.read()))
        o.close()
        e.close()
    return out


# call sizes the batch-invariance checks try against a 256-row call
BATCH_BITS_ROWS = (*range(1, 65), 100, 128, 200)


def estimate_state_calls(dev, raw: bool = False) -> dict:
    """The engine's per-row estimate math at the serving shapes (k_q 500, 100
    anchors in rounds of 20; the bordered update at its fourth block), over
    a seeded batch of 256 rows: ``{name: (fn, inputs)}`` for the first
    block's pinv, the bordered update and e_q.  ``raw=True`` calls
    ``core/cur.py`` and the product-and-sum e_q directly, with no padding
    (what ``batch_bits.py`` probes); else the engine's own calls."""
    from .core import cur, engine

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    b, k_q, k_i, k_s, start = 256, 500, 100, 20, 60
    a0 = torch.randn((b, k_q, k_s), generator=g, device=dev)
    a_full = torch.zeros((b, k_q, k_i), device=dev)
    a_full[:, :, :start] = torch.randn((b, k_q, start), generator=g, device=dev)
    p_full = torch.zeros((b, k_i, k_q), device=dev)
    p_full[:, :start] = cur.pinv(a_full[:, :, :start])
    new = torch.randn((b, k_q, k_s), generator=g, device=dev)
    c = torch.randn((b, k_i), generator=g, device=dev)
    if raw:
        bordered = lambda a, p, n: cur.block_pinv_extend_static(a, p, n, start)  # noqa: E731
    else:
        bordered = lambda a, p, n: engine._bordered(a, p, n, start)  # noqa: E731
    return {"pinv": (cur.incremental_pinv_init, (a0,)),
            "bordered": (bordered, (a_full, p_full, new)),
            "e_q": (engine._e_q, (c, p_full))}


def synthetic_pair_call(dev) -> tuple:
    """``SyntheticCE.score_pairs`` over a seeded batch of 256 rows of 100
    items (the serve domain's shapes: d 16, 4 mixtures of rank 8):
    ``(fn, inputs)``."""
    from .core import prng
    from .data.synthetic import make_synthetic_ce

    ce = make_synthetic_ce(prng.PRNGKey(0), n_queries=600, n_items=20000, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    qids = torch.randint(0, 600, (256,), generator=g, device=dev)
    items = torch.randint(0, 20000, (256, 100), generator=g, device=dev)
    return ce.score_pairs, (qids, items)


def rows_differing(fn, xs, rows: int) -> int:
    """Entries of ``fn(*xs)`` that differ when the batch (the inputs' first
    axis) is computed in calls of ``rows`` rows (the last call holds the
    rest) from one call over the whole batch."""
    whole = fn(*xs)
    b = xs[0].shape[0]
    parts = torch.cat([fn(*(x[lo:lo + rows] for x in xs)) for lo in range(0, b, rows)])
    return int((parts != whole).sum())
