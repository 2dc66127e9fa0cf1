"""Atomic checkpointing of named tensors — port of
``repro/checkpoint/checkpointer.py`` (numpy + json), with its on-disk layout:

- ``step_N/`` holds one ``.npy`` per leaf and a ``manifest.json`` giving
  each leaf's file, logical shape, logical dtype and partition spec;
- a save writes ``step_N.tmp``, fsyncs the manifest and renames the
  directory into place, so a preempted job never sees a torn checkpoint.

Leaves are a flat ``{name: tensor}`` dict, written in sorted name order as
JAX flattens a dict.  bfloat16 and float8 leaves are written as their raw
bytes, ``uint8`` with the last axis widened by the element size, and the
manifest keeps the logical dtype's name (``"bfloat16"``,
``"float8_e4m3fn"``), exactly as the reference writes ``ml_dtypes``
leaves; restore views the bytes back through torch, so no numpy extension
dtype is needed on either side.

A spec is the JSON form of the reference's ``PartitionSpec`` (``[null,
"data"]``, ``["data"]``, ``[]``): the port writes what it is given, so the
reference can restore a port-written tree onto a mesh, and reads specs back
without acting on them (the port has no sharded restore yet, ROADMAP.md).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve_device

# dtypes numpy has no name for without an extension: stored as raw bytes
_BYTE_DTYPES = {"bfloat16": torch.bfloat16}
if hasattr(torch, "float8_e4m3fn"):
    _BYTE_DTYPES["float8_e4m3fn"] = torch.float8_e4m3fn
_TORCH_NAMES = {v: k for k, v in _BYTE_DTYPES.items()}


def dtype_name(t: torch.Tensor) -> str:
    """numpy's name of a tensor's dtype (``"float32"``, ``"bfloat16"``...)."""
    if t.dtype in _TORCH_NAMES:
        return _TORCH_NAMES[t.dtype]
    return str(t.dtype).replace("torch.", "")


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor as the numpy array the reference would write: raw bytes for
    bfloat16 / float8 (last axis widened), the array itself otherwise."""
    t = t.detach().contiguous()
    if t.dtype in _TORCH_NAMES:
        t = t.view(torch.uint8)
    return t.cpu().numpy()


def from_host(arr: np.ndarray, dtype: str, shape, device) -> torch.Tensor:
    """A leaf read from disk as a tensor of its logical dtype and shape."""
    t = torch.from_numpy(np.require(arr, requirements="C"))   # keeps a 0-d leaf 0-d
    if dtype in _BYTE_DTYPES and t.dtype != _BYTE_DTYPES[dtype]:
        t = t.view(torch.uint8).view(_BYTE_DTYPES[dtype])
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"checkpoint leaf of shape {tuple(t.shape)} != manifest {tuple(shape)}")
    return t.to(device)


class Checkpointer:
    """``save(step, leaves, specs)`` / ``restore(step, device=None)`` with
    atomic writes."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, leaves: Dict[str, torch.Tensor],
             specs: Optional[Dict[str, list]] = None) -> None:
        """``specs``: each leaf's JSON partition spec (a missing one records
        ``null``)."""
        specs = specs or {}
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": {}}
        for key in sorted(leaves):
            leaf = leaves[key]
            fn = key + ".npy"
            np.save(os.path.join(tmp, fn), to_host(leaf))
            manifest["leaves"][key] = {"file": fn, "shape": list(leaf.shape),
                                       "dtype": dtype_name(leaf), "spec": specs.get(key)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic commit

    def restore(self, step: int, device=None) -> Dict[str, torch.Tensor]:
        """Every leaf saved at ``step``, on ``device`` (the card unless
        ``device="cpu"``)."""
        device = resolve_device(device)
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)["leaves"]
        return {key: from_host(np.load(os.path.join(path, meta["file"])), meta["dtype"],
                               meta["shape"], device)
                for key, meta in manifest.items()}
