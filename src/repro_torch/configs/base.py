"""ADACUR runtime config — the port's own copy of the reference's
``AdaCURConfig`` and ``replace`` (``repro/configs/base.py``), with the same
field names, defaults and checks, so both packages can be built from one
kwargs dict.

``fused_interpret`` is kept only for that reason and has no effect here: in
the port the backend follows the tensor's device (CUDA kernels for CUDA
tensors, the plain PyTorch versions for CPU tensors).  Likewise
``fused_tile`` is the CPU plain version's item tile; the CUDA kernels pick
their own tiling, and their results do not depend on it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class AdaCURConfig:
    """Inference-time configuration for the multi-round adaptive retriever.

    A CE-call budget ``budget_ce`` split between ``k_anchor`` anchor items
    sampled over ``n_rounds`` rounds and ``budget_ce - k_anchor`` items
    re-ranked with exact CE scores (``split_budget=False`` is
    ADACUR^No-Split).  See the reference config for each field's story.
    """

    k_anchor: int = 100
    n_rounds: int = 5
    budget_ce: int = 200
    strategy: str = "topk"           # "topk" | "softmax" | "random"
    first_round: str = "random"      # "random" | "retriever"
    split_budget: bool = True
    k_retrieve: int = 100
    softmax_temp: float = 1.0
    round_epsilon: float = 0.0
    incremental_pinv: bool = True
    distributed_gather: bool = False
    loop_mode: str = "unrolled"      # "unrolled" | "fori"
    use_fused_topk: bool = False
    fused_tile: int = 6144
    fused_interpret: bool = True     # no effect in the port (see module doc)
    early_exit_tol: float = 0.0
    round_kernel: str = "staged"     # "staged" | "persistent"
    payload_dtype: str = "float32"   # "float32"|"bfloat16"|"int8"|"int4"|"fp8"
    payload_tile: int = 512
    pinv_rcond: float = 1e-4

    def __post_init__(self):
        if self.k_anchor % self.n_rounds != 0:
            raise ValueError(
                f"k_anchor={self.k_anchor} must divide evenly into n_rounds={self.n_rounds}"
            )
        if self.split_budget and self.budget_ce < self.k_anchor:
            raise ValueError("budget_ce must cover k_anchor when splitting budget")
        if self.loop_mode not in ("unrolled", "fori"):
            raise ValueError(f"unknown loop_mode '{self.loop_mode}'")
        if self.early_exit_tol > 0.0 and self.loop_mode != "fori":
            raise ValueError("early_exit_tol requires loop_mode='fori'")
        if self.payload_dtype not in (
            "float32", "bfloat16", "int8", "int4", "fp8"
        ):
            raise ValueError(
                f"unknown payload_dtype '{self.payload_dtype}' "
                "(float32|bfloat16|int8|int4|fp8)"
            )
        if self.payload_tile <= 0:
            raise ValueError("payload_tile must be positive")
        if self.payload_dtype == "int4" and self.payload_tile % 2:
            raise ValueError("int4 payloads need an even payload_tile "
                             "(two codes pack per byte)")
        if self.round_kernel not in ("staged", "persistent"):
            raise ValueError(f"unknown round_kernel '{self.round_kernel}'")
        if self.round_kernel == "persistent" and not self.use_fused_topk:
            raise ValueError(
                "round_kernel='persistent' fuses the round into one payload "
                "sweep; it requires use_fused_topk=True"
            )


def replace(cfg, **kw):
    """dataclasses.replace that works through our frozen configs."""
    return dataclasses.replace(cfg, **kw)
