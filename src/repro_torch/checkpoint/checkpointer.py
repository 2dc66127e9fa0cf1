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
reference can restore a port-written tree onto a mesh.
``restore(..., mesh=)`` is the reference's elastic restore: each leaf's
saved spec is re-resolved on the new mesh (the dimensions it lacks
dropped) and each rank reads only its piece (``restore(..., slices=)``:
the ranges of a leaf's axes it holds; the ``.npy`` is memory-mapped), so
no rank ever holds a whole sharded leaf.  ``save_pieces`` writes a sharded
train state in the unsharded layout with its specs.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

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


def _disk_layout(dtype: torch.dtype, shape) -> tuple:
    """(numpy dtype, shape) of the ``.npy`` :func:`to_host` writes for a
    tensor of ``dtype`` and ``shape``."""
    if dtype in _TORCH_NAMES:
        size = torch.empty((), dtype=dtype).element_size()
        return np.dtype(np.uint8), tuple(shape[:-1]) + (shape[-1] * size,)
    return torch.empty((), dtype=dtype).numpy().dtype, tuple(shape)


def from_host(arr: np.ndarray, dtype: str, shape, device) -> torch.Tensor:
    """A leaf read from disk as a tensor of its logical dtype and shape."""
    t = torch.from_numpy(np.array(arr, order="C", copy=True))   # keeps a 0-d leaf 0-d
    if dtype in _BYTE_DTYPES and t.dtype != _BYTE_DTYPES[dtype]:
        t = t.view(torch.uint8).view(_BYTE_DTYPES[dtype])
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"checkpoint leaf of shape {tuple(t.shape)} != manifest {tuple(shape)}")
    return t.to(device)


class _Like:
    """A leaf's expected piece: its shape on this rank, the dtype and grad
    flag of the leaf it stands for."""

    def __init__(self, shape, ref):
        self.shape, self.dtype, self.requires_grad = tuple(shape), ref.dtype, ref.requires_grad


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

    @staticmethod
    def _into(step: int, flat: Dict[str, torch.Tensor], like: Any) -> Any:
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

    def save_sharded(self, step: int, tree: Any, specs: Dict[str, list],
                     placed: Dict[str, Any], group, write_pieces,
                     on_commit: Optional[Callable[[], None]] = None) -> None:
        """Save a tree whose ``placed`` leaves are split over the ranks of
        ``group`` (every rank calls this; synchronous).  ``placed`` maps a
        leaf to ``(axis, global length, offset)``, or to a list of them (one
        per split axis): this rank's leaf is the piece [offset, offset + its
        length) of each such axis; the other leaves are whole on every rank.
        The files are the ones :meth:`save` would write for the whole tree,
        byte for byte: the group's rank 0 lays out each placed leaf's
        ``.npy`` at its global shape (a memory map) and writes the whole
        leaves, then every rank with ``write_pieces`` (True, or the set of
        leaves it writes: one rank a piece) writes its pieces into the maps,
        and rank 0 writes the manifest and renames the directory into
        place.  Between the stages
        the ranks agree that every rank's writes succeeded (an all-reduce
        MIN of a flag), so a failure anywhere raises on every rank and
        leaves no committed step; no rank holds another's piece.  Rank 0
        calls ``on_commit`` after the rename, inside the last stage."""
        lead = dist.get_rank(group) == 0
        dev = next(iter(leaves_with_paths(tree)))[1].device
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        entries = [(key, leaf, key.replace(SEP, "__") + ".npy")
                   for key, leaf in leaves_with_paths(tree)]
        placed = {k: ([v] if isinstance(v, tuple) else list(v)) for k, v in placed.items()}

        def whole_shape(key, leaf):
            shape = list(leaf.shape)
            for axis, total, _ in placed.get(key, ()):
                shape[axis] = total
            return shape

        def agree(stage: str, fn) -> None:
            err = None
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — every rank must hear of it
                err = f"{type(e).__name__}: {e}"
            flag = torch.tensor([0 if err else 1], dtype=torch.int32, device=dev)
            dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group)
            if not int(flag[0]):
                if lead:
                    shutil.rmtree(tmp, ignore_errors=True)
                dist.all_reduce(flag, group=group)     # every rank leaves after the cleanup
                raise RuntimeError(f"sharded save failed at {stage}: "
                                   f"{err or 'another rank failed'}")

        def layout():
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            for key, leaf, fn in entries:
                if key not in placed:
                    np.save(os.path.join(tmp, fn), to_host(leaf))
                    continue
                dtype, shape = _disk_layout(leaf.dtype, whole_shape(key, leaf))
                mm = np.lib.format.open_memmap(os.path.join(tmp, fn), mode="w+",
                                               dtype=dtype, shape=shape)
                mm.flush()
                del mm

        def pieces():
            if not write_pieces:
                return
            for key, leaf, fn in entries:
                if key not in placed or (write_pieces is not True and key not in write_pieces):
                    continue
                host = to_host(leaf)
                mm = np.load(os.path.join(tmp, fn), mmap_mode="r+")
                index = [slice(None)] * host.ndim
                for axis, _, off in placed[key]:
                    # a raw-byte leaf's last axis counts bytes
                    scale = leaf.element_size() if (leaf.dtype in _TORCH_NAMES
                                                    and axis == leaf.dim() - 1) else 1
                    index[axis] = slice(off * scale, (off + leaf.shape[axis]) * scale)
                mm[tuple(index)] = host
                mm.flush()
                del mm

        def commit():
            manifest = {"step": step, "leaves": {}}
            for key, leaf, fn in entries:
                manifest["leaves"][key] = {"file": fn, "shape": whole_shape(key, leaf),
                                           "dtype": dtype_name(leaf), "spec": specs.get(key)}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            if on_commit is not None:
                on_commit()

        self.wait()
        agree("layout", layout if lead else lambda: None)
        agree("pieces", pieces)
        agree("commit", commit if lead else lambda: None)

    def save_pieces(self, step: int, tree: Any, shardings: Any) -> None:
        """Save a tree of this rank's pieces (a sharded train state) in the
        unsharded layout, byte for byte, with each leaf's spec in the
        manifest, so the reference's ``Checkpointer.restore`` reads it and
        :meth:`restore` re-places it on another mesh.  ``shardings`` is a
        tree of ``distributed.sharding.Sharding`` shaped like ``tree``
        (``sharding.replicated(mesh)`` for a whole leaf); every rank of the
        mesh calls this, and of the ranks holding one piece the first writes
        it."""
        from ..distributed.fsdp import mesh_group
        from ..distributed.sharding import spec_json

        specs, placed, mine, mesh = {}, {}, set(), None
        for (key, leaf), (_, sh) in zip(leaves_with_paths(tree), leaves_with_paths(shardings)):
            mesh = sh.mesh
            specs[key] = spec_json(sh.spec)
            whole = sh.whole_shape(leaf.shape)
            parts = [(d, whole[d], sh.index(d) * leaf.shape[d])
                     for d in range(len(sh.spec)) if sh.parts(d) > 1]
            if parts:
                placed[key] = parts
                if sh.is_writer():
                    mine.add(key)
        self.save_sharded(step, tree, specs, placed, mesh_group(mesh, mesh.mesh_dim_names),
                          mine)

    def shardings(self, step: int, like: Any, mesh) -> Any:
        """The shardings :meth:`restore` places ``like``'s leaves with on
        ``mesh``: each leaf's saved spec re-resolved there, the mesh
        dimensions it lacks dropped (the reference's elastic restore)."""
        from ..distributed.sharding import Sharding, respec

        with open(os.path.join(self.dir, f"step_{step}", "manifest.json")) as f:
            manifest = json.load(f)["leaves"]
        return unflatten_like(like, [Sharding(mesh, respec(mesh, manifest[key]["spec"]))
                                     for key, _ in leaves_with_paths(like)])

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

    def restore(self, step: int, device=None, slices: Optional[Dict[str, Any]] = None,
                like: Any = None, mesh=None) -> Any:
        """Every leaf saved at ``step``, on ``device`` (the card unless
        ``device="cpu"``), as a flat ``{path: tensor}`` dict; with ``like``
        (a tree of tensors, or of anything with ``shape``, ``dtype`` and
        ``requires_grad``, such as ``meta`` tensors), in ``like``'s
        structure, each leaf checked against its shape, cast to its dtype
        and, where it requires grad, requiring grad.  ``slices`` maps a leaf
        to ``(axis, lo, hi)``, a range of its logical axis, or to a list of
        them: only that range is read (through a memory map; a raw-byte
        leaf's last axis scales by its element size).

        With ``mesh`` (and ``like`` at the leaves' whole shapes, as the
        reference's ``restore(step, like, mesh)`` takes them) each leaf's
        saved spec is re-resolved on ``mesh`` (:meth:`shardings`: the mesh
        dimensions it lacks dropped) and this rank reads only its piece,
        which is what is returned.  ``bytes_read`` is what the last restore
        copied off the disk."""
        device = resolve_device(device)
        if mesh is not None:
            if like is None:
                raise ValueError("a restore onto a mesh needs like (the leaves' whole shapes)")
            shardings = leaves_with_paths(self.shardings(step, like, mesh))
            slices = {key: sh.piece(ref.shape)
                      for (key, ref), (_, sh) in zip(leaves_with_paths(like), shardings)}
            pieces = self.restore(step, device, slices)
            like = unflatten_like(like, [_Like(sh.local_shape(ref.shape), ref)
                                         for (_, ref), (_, sh)
                                         in zip(leaves_with_paths(like), shardings)])
            return self._into(step, pieces, like)
        if like is not None:
            return self._into(step, self.restore(step, device, slices), like)
        slices = slices or {}
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)["leaves"]
        out, self.bytes_read = {}, 0
        for key, meta in manifest.items():
            arr = np.load(os.path.join(path, meta["file"]), mmap_mode="r")
            shape = list(meta["shape"])
            if key in slices:
                ranges = slices[key]
                index = [slice(None)] * arr.ndim
                for axis, lo, hi in ([ranges] if isinstance(ranges, tuple) else ranges):
                    shape[axis] = hi - lo
                    scale = arr.shape[axis] // meta["shape"][axis] if meta["shape"][axis] else 1
                    index[axis] = slice(lo * scale, hi * scale)
                arr = arr[tuple(index)]
            self.bytes_read += arr.nbytes
            out[key] = from_host(arr, meta["dtype"], shape, device)
        return out
