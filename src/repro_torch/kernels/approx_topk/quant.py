"""Quantized anchor payload, int8 only — port of
``repro/kernels/approx_topk/quant.py``.

``R_anc`` (k_q, N) is stored as int8 codes plus one fp32 scale per
``tile``-column item tile (``scale = amax_tile / 127``; an all-zero tile
stores 1.0).  Scores dequantize per column,
``S_hat[:, j] = (e_q @ codes[:, j]) * scales[j // tile]``, so the kernels
apply the scale to the GEMM output and the fp32 ``R_anc`` never exists.

bfloat16, fp8 and packed int4 payloads are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

PAYLOAD_DTYPES = ("float32", "bfloat16", "int8", "int4", "fp8")
PORTED_DTYPES = ("float32", "int8")
CODE_DTYPES = ("int8",)
DEFAULT_TILE = 512
_QMAX = {"int8": 127.0}


def _unported(dtype: str) -> ValueError:
    return ValueError(
        f"payload dtype '{dtype}' is not ported yet (the port serves "
        f"{PORTED_DTYPES}); bfloat16, fp8 and packed int4 are still to do"
    )


@dataclass
class QuantizedRanc:
    """int8 codes (k_q, N) + per-item-tile fp32 scales (ceil(N / tile),)."""

    codes: torch.Tensor
    scales: torch.Tensor
    tile: int
    code_dtype: str = "int8"

    @property
    def shape(self):
        return tuple(self.codes.shape)

    @property
    def device(self) -> torch.device:
        return self.codes.device

    @property
    def nbytes(self) -> int:
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
    if isinstance(r_anc, QuantizedRanc):
        return r_anc.code_dtype
    return str(r_anc.dtype).replace("torch.", "")


def payload_nbytes(payload_dtype: str, k_q: int, n: int, tile: int = DEFAULT_TILE) -> int:
    """Analytic byte footprint of a (k_q, n) payload under a policy."""
    if payload_dtype not in PAYLOAD_DTYPES:
        raise ValueError(f"unknown payload_dtype '{payload_dtype}' (one of {PAYLOAD_DTYPES})")
    if payload_dtype == "float32":
        return k_q * n * 4
    if payload_dtype not in CODE_DTYPES:
        raise _unported(payload_dtype)
    return k_q * n + 4 * (-(-n // tile))


def quantize_ranc(r_anc: torch.Tensor, tile: int = DEFAULT_TILE,
                  code_dtype: str = "int8") -> QuantizedRanc:
    """Symmetric per-item-tile quantization, round half to even (as
    ``jnp.round``; ``torch.round`` rounds the same way)."""
    if code_dtype not in CODE_DTYPES:
        raise _unported(code_dtype)
    x = r_anc.to(torch.float32)
    k_q, n = x.shape
    n_tiles = -(-n // tile)
    n_pad = n_tiles * tile
    if n_pad != n:
        x = torch.nn.functional.pad(x, (0, n_pad - n))
    qmax = _QMAX[code_dtype]
    amax = x.reshape(k_q, n_tiles, tile).abs().amax(dim=(0, 2))
    scales = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    y = x / torch.repeat_interleave(scales, tile)[None, :]
    q = torch.clamp(torch.round(y), -qmax, qmax)
    return QuantizedRanc(q.to(torch.int8)[:, :n].contiguous(), scales, tile)


def dequantize(payload: QuantizedRanc) -> torch.Tensor:
    """(k_q, N) fp32 reconstruction — offline/debug only."""
    return payload.codes.to(torch.float32) * payload.col_scales()[None, :]


def as_payload(r_anc, payload_dtype: str, tile: int = DEFAULT_TILE):
    """Apply the config's payload policy to a raw operand (a payload that
    is already quantized passes through unchanged)."""
    if payload_dtype not in PAYLOAD_DTYPES:
        raise ValueError(f"unknown payload_dtype '{payload_dtype}' (one of {PAYLOAD_DTYPES})")
    if isinstance(r_anc, QuantizedRanc) or payload_dtype == "float32":
        return r_anc
    return quantize_ranc(r_anc, tile, code_dtype=payload_dtype)


def matmul(e_q: torch.Tensor, r_anc) -> torch.Tensor:
    """Dense ``e_q @ R_anc`` -> (B, N) fp32 for any payload type."""
    if isinstance(r_anc, QuantizedRanc):
        s = e_q.to(torch.float32) @ r_anc.codes.to(torch.float32)
        return s * r_anc.col_scales()[None, :]
    return e_q.to(torch.float32) @ r_anc.to(torch.float32)


def take_columns(r_anc, pos: torch.Tensor) -> torch.Tensor:
    """R_anc[:, pos] -> (k_q, k) fp32 for an unbatched position vector."""
    pos = pos.long()
    if isinstance(r_anc, QuantizedRanc):
        cols = r_anc.codes[:, pos].to(torch.float32)
        return cols * r_anc.scales[pos // r_anc.tile][None, :]
    return r_anc[:, pos].to(torch.float32)


def gather_columns(r_anc, anchor_idx: torch.Tensor) -> torch.Tensor:
    """R_anc[:, I_anc] for per-query anchor sets (B, k) -> (B, k_q, k) fp32,
    dequantizing exactly the gathered columns."""
    idx = anchor_idx.long()
    if isinstance(r_anc, QuantizedRanc):
        cols = r_anc.codes[:, idx].to(torch.float32).permute(1, 0, 2)
        return cols * r_anc.scales[idx // r_anc.tile][:, None, :]
    return r_anc[:, idx].to(torch.float32).permute(1, 0, 2).contiguous()
