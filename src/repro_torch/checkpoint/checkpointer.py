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
reference can restore a port-written tree onto a mesh.  The port's
counterpart of the reference's ``restore(..., mesh)`` is ``restore(...,
slices=)``: each rank names the range of a leaf's axis it holds and reads
only those bytes (the ``.npy`` is memory-mapped), so no rank ever holds a
whole sharded leaf.
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
    t = torch.from_numpy(np.array(arr, order="C", copy=True))   # keeps a 0-d leaf 0-d
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

    def restore(self, step: int, device=None, slices: Optional[Dict[str, tuple]] = None
                ) -> Dict[str, torch.Tensor]:
        """Every leaf saved at ``step``, on ``device`` (the card unless
        ``device="cpu"``).  ``slices`` maps a leaf to ``(axis, lo, hi)``, a
        range of its logical axis: only that range is read (through a memory
        map; a raw-byte leaf's last axis scales by its element size).
        ``bytes_read`` is what the last restore copied off the disk."""
        device = resolve_device(device)
        slices = slices or {}
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)["leaves"]
        out, self.bytes_read = {}, 0
        for key, meta in manifest.items():
            arr = np.load(os.path.join(path, meta["file"]), mmap_mode="r")
            shape = list(meta["shape"])
            if key in slices:
                axis, lo, hi = slices[key]
                shape[axis] = hi - lo
                scale = arr.shape[axis] // meta["shape"][axis] if meta["shape"][axis] else 1
                index = [slice(None)] * arr.ndim
                index[axis] = slice(lo * scale, hi * scale)
                arr = arr[tuple(index)]
            self.bytes_read += arr.nbytes
            out[key] = from_host(arr, meta["dtype"], shape, device)
        return out
