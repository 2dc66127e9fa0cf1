"""Atomic checkpointing of named tensors — port of
``repro/checkpoint/checkpointer.py`` (numpy + json), with its on-disk layout:

- ``step_N/`` holds one ``.npy`` per leaf and a ``manifest.json`` giving
  each leaf's file, logical shape, logical dtype and partition spec;
- a save writes ``step_N.tmp``, fsyncs the manifest and renames the
  directory into place, so a preempted job never sees a torn checkpoint.

A saved tree is a nested tree of dicts, lists and named tuples of tensors
(``repro_torch.tree``): a flat ``{name: tensor}`` dict (the index's), or a
training state ``{"params": ..., "opt": AdamWState(...)}``.  Each leaf is
written under the reference's path (``opt/.mu/tables/0``; the file name
joins the keys with ``__``), so either package restores the other's
training checkpoint.  A save may run on a background thread
(``async_save``): every leaf is first copied to host memory, before
``save`` returns, so a step that updates the parameters in place cannot
change what the writer is still writing.

bfloat16 and float8 leaves are written as their raw
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
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..tree import SEP, leaves_with_paths, unflatten_like

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
    bfloat16 / float8 (last axis widened), the array itself otherwise.
    Always a copy: a CPU tensor's memory is not shared with it."""
    t = t.detach().contiguous()
    if t.dtype in _TORCH_NAMES:
        t = t.view(torch.uint8)
    if t.is_cuda:
        return t.cpu().numpy()
    return t.numpy().copy()


def from_host(arr: np.ndarray, dtype: str, shape, device) -> torch.Tensor:
    """A leaf read from disk as a tensor of its logical dtype and shape."""
    t = torch.from_numpy(np.array(arr, order="C", copy=True))   # keeps a 0-d leaf 0-d
    if dtype in _BYTE_DTYPES and t.dtype != _BYTE_DTYPES[dtype]:
        t = t.view(torch.uint8).view(_BYTE_DTYPES[dtype])
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"checkpoint leaf of shape {tuple(t.shape)} != manifest {tuple(shape)}")
    return t.to(device)


class Checkpointer:
    """``save(step, tree, specs)`` / ``restore(step, like=None, device=None)``
    with atomic writes, synchronous unless ``async_save``."""

    def __init__(self, directory: str, async_save: bool = False):
        self.dir = directory
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree: Any, specs: Optional[Dict[str, list]] = None) -> None:
        """``specs``: a leaf's JSON partition spec by its path (a missing
        one records ``null``).  Every leaf is on the host when this
        returns."""
        host = [(key, to_host(leaf), dtype_name(leaf), list(leaf.shape))
                for key, leaf in leaves_with_paths(tree)]
        spec_map = specs or {}

        def write():
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            manifest = {"step": step, "leaves": {}}
            for key, arr, dtype, shape in host:
                fn = key.replace(SEP, "__") + ".npy"
                np.save(os.path.join(tmp, fn), arr)
                manifest["leaves"][key] = {"file": fn, "shape": shape, "dtype": dtype,
                                           "spec": spec_map.get(key)}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)  # atomic commit

        self.wait()
        if self.async_save:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self) -> None:
        """Block until the last asynchronous save is on disk."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def available_steps(self) -> list:
        """The steps of the committed checkpoints, ascending."""
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(steps)

    def restore(self, step: int, device=None, slices: Optional[Dict[str, tuple]] = None,
                like: Any = None) -> Any:
        """Every leaf saved at ``step``, on ``device`` (the card unless
        ``device="cpu"``), as a flat ``{path: tensor}`` dict; with ``like``
        (a tree of tensors), in ``like``'s structure, each leaf checked
        against its shape, cast to its dtype and, where it requires grad,
        requiring grad.  ``slices`` maps a leaf to ``(axis, lo, hi)``, a
        range of its logical axis: only that range is read (through a memory
        map; a raw-byte leaf's last axis scales by its element size).
        ``bytes_read`` is what the last restore copied off the disk."""
        device = resolve_device(device)
        if like is not None:
            flat = self.restore(step, device, slices)
            out = []
            for key, ref in leaves_with_paths(like):
                if key not in flat:
                    raise KeyError(f"checkpoint step {step} has no leaf {key}")
                t = flat[key]
                if tuple(t.shape) != tuple(ref.shape):
                    raise ValueError(f"checkpoint leaf {key} shape {tuple(t.shape)} != "
                                     f"expected {tuple(ref.shape)}")
                t = t.to(ref.dtype)
                out.append(t.requires_grad_() if ref.requires_grad else t)
            return unflatten_like(like, out)
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
