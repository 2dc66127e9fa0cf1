"""Quantized anchor payload — port of ``repro/kernels/approx_topk/quant.py``.

``R_anc`` (k_q, N) is stored as codes plus one fp32 scale per
``tile``-column item tile (``scale = amax_tile / qmax``; an all-zero tile
stores 1.0), in one of three code formats (``QuantizedRanc.code_dtype``):

- ``"int8"``: (k_q, N) int8, qmax 127 (0.25x fp32 bytes);
- ``"int4"``: (k_q, ceil(N/2)) uint8, two signed nibbles a byte (column 2j
  in the low nibble, 2j+1 in the high one; an odd tail packs against a
  zero nibble), qmax 7 (0.125x fp32 bytes);
- ``"fp8"``: (k_q, N) float8_e4m3fn, qmax 448, e4m3's largest finite value
  (0.25x fp32 bytes, about 2 more bits of dynamic range a tile than int8).

Scores dequantize per column,
``S_hat[:, j] = (e_q @ codes[:, j]) * scales[j // tile]``, so the kernels
apply the scale to the GEMM output and the fp32 ``R_anc`` never exists.
The payload policies (``AdaCURConfig.payload_dtype``) are plain fp32 and
bf16 tensors and :class:`QuantizedRanc`; the engine and the fused ops call
the dispatchers here (:func:`matmul`, :func:`gather_columns`, ...) and never
branch on the payload type themselves.

Tile-local scales make mutation cheap: ``add_items`` / ``remove_items``
re-quantize only the tiles whose columns changed (:func:`update_columns`,
:func:`requantize_preserving_prefix`) and every other tile keeps its codes
and scale byte for byte (packed int4 too: the tile is even, so a tile
boundary is a byte boundary).  :func:`subset_columns` gathers a candidate
subset into a compact payload of the same policy, per-column scales
(``tile=1``), each column dequantizing bit-equal to its source.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch

PAYLOAD_DTYPES = ("float32", "bfloat16", "int8", "int4", "fp8")
CODE_DTYPES = ("int8", "int4", "fp8")
DEFAULT_TILE = 512
_QMAX = {"int8": 127.0, "int4": 7.0, "fp8": 448.0}
# storage bytes a column takes in each k_q row (scales add 4 / tile a column)
BYTES_PER_COL = {"float32": 4.0, "bfloat16": 2.0, "int8": 1.0, "int4": 0.5, "fp8": 1.0}


def fp8_supported() -> bool:
    """Whether this torch build carries float8_e4m3fn."""
    return hasattr(torch, "float8_e4m3fn")


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """(k_q, n) signed nibble values in [-8, 7] -> (k_q, ceil(n/2)) uint8."""
    c = codes.to(torch.int32)
    if c.shape[1] % 2:
        c = torch.nn.functional.pad(c, (0, 1))
    c = c & 0xF
    return (c[:, 0::2] | (c[:, 1::2] << 4)).to(torch.uint8)


def _nibbles(packed: torch.Tensor):
    """The low and high nibbles of uint8 bytes as sign-extended int8: the
    nibble moved to the top of the byte, then an arithmetic shift right."""
    return (packed << 4).view(torch.int8) >> 4, packed.view(torch.int8) >> 4


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(k_q, m) uint8 -> (k_q, 2m) int8 signed nibble values."""
    lo, hi = _nibbles(packed)
    return torch.stack([lo, hi], dim=-1).reshape(packed.shape[0], -1)


def _take_nibbles(packed: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Logical int4 columns ``pos`` (any shape) -> (k_q, *pos.shape) int8,
    reading one byte a column."""
    pos = pos.long()
    lo, hi = _nibbles(packed[:, pos // 2].contiguous())
    return torch.where(pos % 2 == 0, lo, hi)


@dataclass
class QuantizedRanc:
    """Codes (int8 / packed-int4 uint8 / fp8) + per-item-tile fp32 scales
    (ceil(N / tile),).  ``n_cols`` is the logical width of an odd-width
    int4 payload (its packed bytes over-state it by one) and -1 elsewhere."""

    codes: torch.Tensor
    scales: torch.Tensor
    tile: int
    code_dtype: str = "int8"
    n_cols: int = -1

    @property
    def packing(self) -> int:
        """Logical columns per stored code element (2 for packed int4)."""
        return 2 if self.code_dtype == "int4" else 1

    @property
    def shape(self):
        k_q, m = self.codes.shape
        if self.code_dtype == "int4":
            return (k_q, m * 2 if self.n_cols < 0 else self.n_cols)
        return (k_q, m)

    @property
    def device(self) -> torch.device:
        return self.codes.device

    @property
    def nbytes(self) -> int:
        """Storage bytes (packed int4 counts half a byte a column)."""
        return (self.codes.numel() * self.codes.element_size()
                + self.scales.numel() * self.scales.element_size())

    @property
    def n_tiles(self) -> int:
        return self.scales.shape[0]

    def col_scales(self) -> torch.Tensor:
        """(N,) per-column fp32 scales (tile scales expanded)."""
        return torch.repeat_interleave(self.scales, self.tile)[: self.shape[1]]

    def to(self, device) -> "QuantizedRanc":
        return replace(self, codes=self.codes.to(device), scales=self.scales.to(device))


def payload_dtype_of(r_anc) -> str:
    """The policy name of a payload ("float32"/"bfloat16"/"int8"/"int4"/"fp8")."""
    if isinstance(r_anc, QuantizedRanc):
        return r_anc.code_dtype
    return str(r_anc.dtype).replace("torch.", "")


def _check_policy(payload_dtype: str) -> None:
    if payload_dtype not in PAYLOAD_DTYPES:
        raise ValueError(f"unknown payload_dtype '{payload_dtype}' (one of {PAYLOAD_DTYPES})")


def payload_nbytes(payload_dtype: str, k_q: int, n: int, tile: int = DEFAULT_TILE) -> int:
    """Analytic storage bytes of a (k_q, n) payload under a policy: a packed
    int4 column is half a byte a row, and the coded dtypes add their
    4-byte-a-tile scales.  Equals ``.nbytes`` of the operand, up to int4's
    padding byte a row at an odd width."""
    _check_policy(payload_dtype)
    values = int(math.ceil(k_q * n * BYTES_PER_COL[payload_dtype]))
    return values + (4 * (-(-n // tile)) if payload_dtype in CODE_DTYPES else 0)


def unpacked_codes(payload: QuantizedRanc) -> torch.Tensor:
    """Codes at logical width: int4 nibbles widened to int8, others as-is."""
    if payload.code_dtype == "int4":
        return unpack_int4(payload.codes)[:, : payload.shape[1]]
    return payload.codes


def quantize_ranc(r_anc: torch.Tensor, tile: int = DEFAULT_TILE,
                  code_dtype: str = "int8") -> QuantizedRanc:
    """Symmetric per-item-tile quantization: round half to even for the
    integer formats (as ``jnp.round``; ``torch.round`` rounds the same
    way), the fp8 cast's round to nearest even for fp8."""
    if code_dtype not in CODE_DTYPES:
        raise ValueError(f"unknown code_dtype '{code_dtype}' (one of {CODE_DTYPES})")
    if code_dtype == "int4" and tile % 2:
        raise ValueError(f"int4 payloads need an even tile, got {tile}")
    if code_dtype == "fp8" and not fp8_supported():
        raise ValueError("fp8 payloads need torch.float8_e4m3fn in this torch build")
    x = r_anc.to(torch.float32)
    k_q, n = x.shape
    n_tiles = -(-n // tile)
    n_pad = n_tiles * tile
    if n_pad != n:
        x = torch.nn.functional.pad(x, (0, n_pad - n))
    qmax = _QMAX[code_dtype]
    amax = x.reshape(k_q, n_tiles, tile).abs().amax(dim=(0, 2))
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by its
    # reciprocal, which can round the scale an ulp away from the reference's
    scales = torch.where(amax > 0, amax / torch.full_like(amax, qmax), torch.ones_like(amax))
    y = x / torch.repeat_interleave(scales, tile)[None, :]
    if code_dtype == "fp8":
        # the clip keeps the reference's codes: amax / scale can land an ulp
        # above qmax, where JAX's cast gives NaN and torch's saturates
        codes = torch.clamp(y, -qmax, qmax).to(torch.float8_e4m3fn)
        return QuantizedRanc(codes[:, :n].contiguous(), scales, tile, "fp8")
    q = torch.clamp(torch.round(y), -qmax, qmax)
    if code_dtype == "int4":
        return QuantizedRanc(pack_int4(q[:, :n]), scales, tile, "int4", n if n % 2 else -1)
    return QuantizedRanc(q.to(torch.int8)[:, :n].contiguous(), scales, tile)


def dequantize(payload: QuantizedRanc) -> torch.Tensor:
    """(k_q, N) fp32 reconstruction — offline/debug only."""
    return unpacked_codes(payload).to(torch.float32) * payload.col_scales()[None, :]


def as_payload(r_anc, payload_dtype: str, tile: int = DEFAULT_TILE):
    """Apply the config's payload policy to a raw operand: a bf16 cast or a
    quantization; a payload that is already quantized passes unchanged."""
    _check_policy(payload_dtype)
    if isinstance(r_anc, QuantizedRanc) or payload_dtype == "float32":
        return r_anc
    if payload_dtype == "bfloat16":
        return r_anc.to(torch.bfloat16)
    return quantize_ranc(r_anc, tile, code_dtype=payload_dtype)


def matmul(e_q: torch.Tensor, r_anc) -> torch.Tensor:
    """Dense ``e_q @ R_anc`` -> (B, N) fp32 for any payload type; the
    per-column scale multiplies the GEMM output, as in the kernels."""
    if isinstance(r_anc, QuantizedRanc):
        s = e_q.to(torch.float32) @ unpacked_codes(r_anc).to(torch.float32)
        return s * r_anc.col_scales()[None, :]
    return e_q.to(torch.float32) @ r_anc.to(torch.float32)


def _codes_at(r_anc: QuantizedRanc, pos: torch.Tensor) -> torch.Tensor:
    """(k_q, *pos.shape) fp32 codes of logical columns ``pos``."""
    if r_anc.code_dtype == "int4":
        return _take_nibbles(r_anc.codes, pos).to(torch.float32)
    return r_anc.codes[:, pos.long()].to(torch.float32)


def take_columns(r_anc, pos: torch.Tensor) -> torch.Tensor:
    """R_anc[:, pos] -> (k_q, k) fp32 for an unbatched position vector."""
    pos = pos.long()
    if isinstance(r_anc, QuantizedRanc):
        return _codes_at(r_anc, pos) * r_anc.scales[pos // r_anc.tile][None, :]
    return r_anc[:, pos].to(torch.float32)


def gather_columns(r_anc, anchor_idx: torch.Tensor) -> torch.Tensor:
    """R_anc[:, I_anc] for per-query anchor sets (B, k) -> (B, k_q, k) fp32,
    dequantizing exactly the gathered columns (k nibble reads for packed
    int4, never a full unpack)."""
    idx = anchor_idx.long()
    if isinstance(r_anc, QuantizedRanc):
        cols = _codes_at(r_anc, idx).permute(1, 0, 2)
        return cols * r_anc.scales[idx // r_anc.tile][:, None, :]
    return r_anc[:, idx].to(torch.float32).permute(1, 0, 2).contiguous()


def subset_columns(r_anc, pos: torch.Tensor, valid: torch.Tensor):
    """Columns ``pos`` (C,) of a payload as a compact (k_q, C) payload of the
    same policy, whose column j dequantizes bit-equal to column ``pos[j]``;
    ``valid`` (C,) marks the real entries, the others become exact zeros
    (codes 0, scale 1.0).  Coded payloads keep their code bytes and carry
    each column's source-tile scale (``tile=1``), so nothing re-quantizes;
    packed int4 widens to int8 codes (the nibble values, exactly), since a
    scattered, odd-width subset has no packed layout."""
    pos = pos.long()
    if isinstance(r_anc, QuantizedRanc):
        scales = torch.where(valid, r_anc.scales[pos // r_anc.tile], 1.0).to(torch.float32)
        if r_anc.code_dtype == "int4":
            codes = torch.where(valid[None, :], _take_nibbles(r_anc.codes, pos), 0)
            return QuantizedRanc(codes.to(torch.int8), scales, 1, "int8")
        # the bytes, so every code type goes through one integer where
        raw = r_anc.codes.view(torch.uint8)[:, pos]
        raw = torch.where(valid[None, :], raw, 0).to(torch.uint8)
        return QuantizedRanc(raw.view(r_anc.codes.dtype), scales, 1, r_anc.code_dtype)
    cols = r_anc[:, pos]
    return torch.where(valid[None, :], cols, torch.zeros((), dtype=cols.dtype, device=cols.device))


# ---------------------------------------------------------------------------
# Tile-local mutation: re-quantize only the touched tiles.
# ---------------------------------------------------------------------------


def _tile_scales(payload: QuantizedRanc, lo: int, hi: int) -> torch.Tensor:
    cols = torch.arange(lo, hi, device=payload.scales.device)
    return payload.scales[cols // payload.tile]


def dequantize_slice(payload: QuantizedRanc, lo: int, hi: int) -> torch.Tensor:
    """fp32 reconstruction of columns [lo, hi); for packed int4 ``lo`` is
    even (a byte boundary) and an odd ``hi`` decodes and drops a phantom
    high nibble."""
    if payload.code_dtype == "int4":
        if lo % 2:
            raise ValueError("int4 slices must start on a byte boundary")
        codes = unpack_int4(payload.codes[:, lo // 2:-(-hi // 2)])[:, :hi - lo]
    else:
        codes = payload.codes[:, lo:hi]
    return codes.to(torch.float32) * _tile_scales(payload, lo, hi)[None, :]


def update_columns(payload: QuantizedRanc, cols: torch.Tensor, start: int) -> QuantizedRanc:
    """Columns [start, start + m) overwritten with fp32 ``cols``, re-quantizing
    only the tiles that range touches; every other tile is returned byte for
    byte (packed int4 spliced at byte granularity, exact since tiles are
    even)."""
    m = cols.shape[1]
    tile, n = payload.tile, payload.shape[1]
    t0 = start // tile
    t1 = -(-(start + m) // tile)                   # exclusive touched-tile end
    lo, hi = t0 * tile, min(t1 * tile, n)
    region = dequantize_slice(payload, lo, hi)
    region[:, start - lo:start - lo + m] = cols.to(torch.float32)
    sub = quantize_ranc(region, tile, code_dtype=payload.code_dtype)
    codes, scales = payload.codes.clone(), payload.scales.clone()
    c0 = lo // payload.packing
    codes[:, c0:c0 + sub.codes.shape[1]] = sub.codes
    scales[t0:t0 + sub.n_tiles] = sub.scales
    return QuantizedRanc(codes, scales, tile, payload.code_dtype, payload.n_cols)


def requantize_preserving_prefix(old: QuantizedRanc, new_f32: torch.Tensor,
                                 first_touched_col: int) -> QuantizedRanc:
    """``new_f32`` quantized, with every tile strictly before the first
    touched column restored from ``old`` byte for byte: those tiles hold the
    same values, and restoring their bytes keeps them bit-identical where a
    recomputed scale could move an ulp (and fp8's grid could move a code).
    ``new_f32`` may be wider or narrower than ``old``."""
    newp = quantize_ranc(new_f32, old.tile, code_dtype=old.code_dtype)
    t0 = min(first_touched_col // old.tile, old.n_tiles, newp.n_tiles)
    keep = t0 * old.tile
    if keep == 0:
        return newp
    kc = keep // old.packing            # tile evenness: byte-aligned for int4
    codes, scales = newp.codes.clone(), newp.scales.clone()
    codes[:, :kc] = old.codes[:, :kc]
    scales[:t0] = old.scales[:t0]
    return QuantizedRanc(codes, scales, old.tile, old.code_dtype, newp.n_cols)
