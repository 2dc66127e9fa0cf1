"""Persistent ADACUR round: one payload sweep -> the sampled top-k and the
provisional top-k — port of ``repro/kernels/approx_topk/persistent.py``.

Backends, as in ``ops.py``:

- ``cuda``: the hand-written kernel ``csrc/persistent_round.cu`` (port of
  the TPU kernel ``_persistent_kernel``, ``persistent.py:232``), wrapped by
  :func:`persistent_round_cuda`, whose ``launches`` counts its calls;
- ``torch``: the plain version, the twin of ``_persistent_scan``: one GEMM
  slab per tile feeds both branches, and each branch's running list merges
  with the tile by (max value, min id) from the sentinel
  ``(NEG_INF, INT32_MAX)`` (``_select_min_id`` semantics).

Both are bit-identical to the corresponding staged calls of their own
backend:

- ``sample`` == ``approx_topk_op(e_q, r_anc, anchors, k_sample, noise=noise,
  mask=mask, n_valid=n_valid)``
- ``prov``   == ``approx_topk_op(e_q, r_anc, None, k_prov, mask=prov_mask,
  n_valid=n_valid)``

Both take every payload policy (fp32, bf16, int8 / fp8 / packed-int4
codes); each branch multiplies the shared GEMM tile by the scale itself,
as the reference does (``persistent.py:132-138``).

A ``noise_key`` (with global ``row_offset``/``col_offset``) in place of a
``noise`` array is materialized with ``sampling.blocked_gumbel`` before the
sweep, on either backend, as the reference's Pallas path does.
"""

from __future__ import annotations

import torch

from .. import LaunchCounter, build
from .kernel import (as_u8, check_operands, fragment_split, payload_operands, plan_grid,
                     sm_count)
from .ops import PlainTiles, anchor_mask, tile_select
from .select import INT32_MAX, NEG_INF, topk_value_id

launches = LaunchCounter()


def _sentinel(b: int, k: int, device):
    return (torch.full((b, k), NEG_INF, dtype=torch.float32, device=device),
            torch.full((b, k), INT32_MAX, dtype=torch.int32, device=device))


def persistent_round_plain(e_q, r_anc, *, k_sample=None, k_prov=None,
                           anchors=None, mask=None, prov_mask=None, noise=None,
                           n_valid=None, tile: int = 512):
    """The plain PyTorch version: one sweep, two running top-k lists."""
    tiles = PlainTiles(e_q, r_anc, tile)
    b, n, dev = e_q.shape[0], tiles.n, e_q.device
    n_eff = n if n_valid is None else min(int(n_valid), n)
    hit = mask
    if anchors is not None:
        am = anchor_mask(anchors, b, n, dev)
        hit = am if hit is None else hit | am
    carry_s = _sentinel(b, k_sample, dev) if k_sample is not None else None
    carry_p = _sentinel(b, k_prov, dev) if k_prov is not None else None
    for lo, hi in tiles.bounds():
        gemm = tiles.gemm(lo, hi)
        base = (torch.arange(lo, hi, device=dev) < n_eff)[None, :]
        if carry_s is not None:
            s = tiles.scaled(gemm, lo, hi)
            if noise is not None:
                s = s + noise[:, lo:hi].to(torch.float32)
            keep = base if hit is None else base & ~hit[:, lo:hi]
            tv, ti = tile_select(s, keep, lo, k_sample)
            carry_s = topk_value_id(torch.cat([carry_s[0], tv], 1),
                                    torch.cat([carry_s[1], ti], 1), k_sample)
        if carry_p is not None:
            keep = base if prov_mask is None else base & ~prov_mask[:, lo:hi]
            tv, ti = tile_select(tiles.scaled(gemm, lo, hi), keep, lo, k_prov)
            carry_p = topk_value_id(torch.cat([carry_p[0], tv], 1),
                                    torch.cat([carry_p[1], ti], 1), k_prov)
    return carry_s, carry_p


def persistent_round_cuda(e_q, r_anc, *, k_sample=None, k_prov=None,
                          anchors=None, mask=None, prov_mask=None, noise=None,
                          n_valid=None):
    """The fused sweep on the card -> (sample, prov) pairs (or None)."""
    codes, kind, scales, qtile, n = payload_operands(r_anc)
    ks, kp = k_sample or 0, k_prov or 0
    check_operands(e_q, codes, n, [k for k in (k_sample, k_prov) if k is not None],
                   noise, [mask, prov_mask], anchors, name="persistent_round")
    b, k_q = e_q.shape
    n_items = n if n_valid is None else min(int(n_valid), n)
    dev = e_q.device
    nblk, cols = plan_grid(b, n, sm_count(dev))
    a_hi, a_lo = fragment_split(e_q)
    noise = None if noise is None else noise.contiguous()
    anchors = None if anchors is None else anchors.to(torch.int32).contiguous()
    n_anc = 0 if anchors is None else anchors.shape[1]

    def buffers(k):
        if not k:
            return None, None, None, None, None
        return (torch.empty((b, nblk, k), dtype=torch.float32, device=dev),
                torch.empty((b, nblk, k), dtype=torch.int32, device=dev),
                torch.empty((b,), dtype=torch.int32, device=dev),
                torch.empty((b, k), dtype=torch.float32, device=dev),
                torch.empty((b, k), dtype=torch.int32, device=dev))

    bsv, bsi, gs, osv, osi = buffers(ks)
    bpv, bpi, gp, opv, opi = buffers(kp)
    m8, pm8 = as_u8(mask), as_u8(prov_mask)
    p = build.ptr
    stream = torch.cuda.current_stream(dev).cuda_stream
    if ks and kp:
        err = build.load(build.topk_library("persistent_round", kind)).persistent_round_launch(
            p(a_hi), p(a_lo), p(codes), kind, p(scales), qtile, p(noise), p(m8),
            p(anchors), n_anc, p(pm8), b, k_q, n, n_items, ks, kp, cols,
            p(bsv), p(bsi), p(bpv), p(bpi), p(gs), p(gp), p(osv), p(osi), p(opv), p(opi),
            stream)
    elif ks:     # one list: the same sweep with one list, compiled in approx_topk.cu
        err = build.load(build.topk_library("approx_topk", kind)).approx_topk_launch(
            p(a_hi), p(a_lo), p(codes), kind, p(scales), qtile, p(noise), p(m8),
            p(anchors), n_anc, b, k_q, n, n_items, ks, cols, p(bsv), p(bsi), p(gs),
            p(osv), p(osi), stream)
    else:        # the provisional list alone: no noise, no anchors, prov_mask
        err = build.load(build.topk_library("approx_topk", kind)).approx_topk_launch(
            p(a_hi), p(a_lo), p(codes), kind, p(scales), qtile, None, p(pm8),
            None, 0, b, k_q, n, n_items, kp, cols, p(bpv), p(bpi), p(gp),
            p(opv), p(opi), stream)
    build.check(err, "persistent_round")
    launches.add()
    return ((osv, osi) if ks else None), ((opv, opi) if kp else None)


def persistent_round_op(e_q, r_anc, *, k_sample=None, k_prov=None,
                        anchors=None, mask=None, prov_mask=None, noise=None,
                        noise_key=None, row_offset: int = 0,
                        col_offset: int = 0, n_valid=None, tile: int = 512,
                        interpret: bool = True, impl: str = "auto"):
    """One fused payload sweep -> ``(sample, prov)``, each a ``(vals (B,k),
    idx (B,k))`` pair or ``None`` when its k was not requested."""
    if k_sample is None and k_prov is None:
        raise ValueError("persistent_round_op needs k_sample and/or k_prov")
    if noise is None and noise_key is not None:
        from ...core.sampling import blocked_gumbel

        n = r_anc.shape[1]
        noise = blocked_gumbel(noise_key, e_q.shape[0], n, row_offset,
                               col_offset, device=e_q.device)
    kw = dict(k_sample=k_sample, k_prov=k_prov, anchors=anchors, mask=mask,
              prov_mask=prov_mask, noise=noise, n_valid=n_valid)
    if impl == "auto":
        impl = "cuda" if e_q.is_cuda else "torch"
    if impl == "cuda":
        return persistent_round_cuda(e_q, r_anc, **kw)
    if impl == "torch":
        return persistent_round_plain(e_q, r_anc, tile=tile, **kw)
    raise ValueError(f"unknown impl '{impl}' (auto|cuda|torch)")
