"""Logical-axis sharding rules over a ``DeviceMesh`` — port of
``repro/distributed/sharding.py``.

Model inits come with spec trees (each family's ``param_specs``) whose
leaves are tuples of *logical* axis names (("embed", "heads",
"head_dim"), ...).  This module translates them into specs for a concrete
mesh:

- "data"  = the combined DP/FSDP axis (parameters FSDP-shard their
  "embed" / "vocab" dims here; batches shard here and, multi-pod, on "pod"
  too);
- "model" = the tensor / expert parallel axis;
- "pod"   = cross-pod data parallelism.

A spec here is a tuple with one entry per tensor dimension: ``None``
(replicated), a mesh dimension name, or a tuple of names (that dimension
split over several mesh dimensions, major to minor).  Rules are
divisibility-checked per tensor: a logical dimension that does not divide
by its mesh dimensions falls back to replication, and a mesh dimension is
used at most once per spec (the first logical dimension wins).

A "sharding" (:class:`Sharding`, what ``tree_shardings`` returns and
``replicated`` gives) is the (mesh, spec) of one leaf, in PyTorch's idiom:
it cuts this rank's piece out of a whole tensor (``local``), names the
piece's ranges (``piece``) and gathers the pieces back (``gather``).  The
pieces are plain tensors and the collectives ``torch.distributed``'s
(``distributed/fsdp.py`` differentiates them), not ``DTensor``: gloo on
CUDA tensors, which several ranks on one card need, runs ``all_gather``,
``all_reduce``, ``broadcast`` and ``all_to_all`` and nothing else the
port relies on.

The functions read only a mesh's dimension names and sizes (and a
sharding's collectives its groups), so anything with ``mesh_dim_names`` and
``shape`` works for the specs: the tests hand them a stub mesh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..device import resolve_device

Axes = Union[str, Tuple[str, ...], None]

# logical axis -> preferred mesh dimensions, tried in order (a tuple: that
# one dimension split over several mesh dimensions, e.g. huge table rows).
# On a serving (data x items) mesh the item axis lives on "items" (the data
# dimension shards the query batch); on other meshes it spreads over the
# whole mesh.
DEFAULT_RULES: Dict[str, Sequence[Axes]] = {
    # LM
    "vocab": ("model",),
    "embed": ("data",),            # FSDP
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (None,),
    "mlp": ("model",),
    "expert": ("model",),
    "layers": (None,),
    "seq": (None,),
    "unit": (None,),
    # recsys
    "table_rows": (("pod", "data", "model"), ("data", "model"), ("data",)),
    # retrieval (AnchorIndex)
    "items": (
        ("items",),
        ("pod", "data", "model"), ("data", "model"), ("data",), ("model",),
    ),
    "anchor_q": (None,),
    "mlp_in": ("data",),
    "mlp_out": ("model",),
    "interest": (None,),
    # gnn
    "feat": (None,),
    "species": (None,),
    "ch": (None,),
    "ch_in": (None,),
    "rbf": (None,),
    "radial_out": (None,),
}


def mesh_dims(mesh) -> Dict[str, int]:
    """{dimension name: size} of a mesh."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def axis_size(mesh, axes: Axes) -> int:
    if axes is None:
        return 1
    dims = mesh_dims(mesh)
    size = 1
    for a in ((axes,) if isinstance(axes, str) else axes):
        size *= dims[a]
    return size


def spec_for(mesh, logical: Tuple[str, ...], shape: Tuple[int, ...],
             rules: Optional[Dict[str, Sequence[Axes]]] = None) -> tuple:
    """One logical-axes tuple -> a spec (trailing replicated dims dropped)."""
    rules = rules or DEFAULT_RULES
    dims = mesh_dims(mesh)
    used: set = set()
    out = []
    for name, dim in zip(logical, shape):
        chosen: Axes = None
        for cand in rules.get(name, (None,)):
            if cand is None:
                break
            cand_t = (cand,) if isinstance(cand, str) else tuple(cand)
            if any(a not in dims for a in cand_t) or any(a in used for a in cand_t):
                continue
            if dim % axis_size(mesh, cand_t):
                continue
            chosen = cand if isinstance(cand, str) else cand_t
            used.update(cand_t)
            break
        out.append(chosen)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh dimensions that shard the batch (pod composes with data)."""
    dims = mesh_dims(mesh)
    return tuple(a for a in ("pod", "data") if a in dims)


def check_mesh_device(mesh, device=None) -> torch.device:
    """The device rule for an entry point over a mesh: ``device`` (the card
    unless the caller passes ``"cpu"``), which the mesh must live on."""
    dev = resolve_device(device)
    if mesh is not None and mesh.device_type != dev.type:
        raise ValueError(f"a {mesh.device_type} mesh cannot run on device {dev}")
    return dev


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        isinstance(e, str) for e in x)


def _map_specs(fn, logical_specs, params):
    """``fn(logical, leaf)`` over a logical-spec tree (its leaves tuples of
    axis names) and the matching leaves of ``params``."""
    if _is_axes(logical_specs):
        return fn(logical_specs, params)
    if isinstance(logical_specs, dict):
        return {k: _map_specs(fn, logical_specs[k], params[k]) for k in logical_specs}
    if isinstance(logical_specs, tuple) and hasattr(logical_specs, "_fields"):
        return type(logical_specs)(*(_map_specs(fn, getattr(logical_specs, f),
                                                getattr(params, f))
                                     for f in logical_specs._fields))
    if isinstance(logical_specs, (list, tuple)):
        return type(logical_specs)(_map_specs(fn, s, params[i])
                                   for i, s in enumerate(logical_specs))
    raise TypeError(f"not a logical spec: {logical_specs!r}")


def tree_specs(mesh, params, logical_specs, rules=None):
    """A whole (params, logical-spec) tree -> a tree of specs shaped like
    ``params``.  The logical-spec tree leads the walk (its leaves are tuples
    of strings); a parameter leaf needs only ``.shape``."""
    return _map_specs(lambda s, p: spec_for(mesh, s, tuple(p.shape), rules),
                      logical_specs, params)


def logical_by_path(logical_specs, prefix: str = "") -> Dict[str, tuple]:
    """{leaf path: logical axes} of a logical-spec tree, its paths spelt as
    ``tree.leaves_with_paths`` spells the parameters'."""
    if _is_axes(logical_specs):
        return {prefix: logical_specs}
    join = (lambda k: f"{prefix}/{k}" if prefix else str(k))  # noqa: E731
    if isinstance(logical_specs, dict):
        items = ((k, logical_specs[k]) for k in sorted(logical_specs))
    else:
        items = enumerate(logical_specs)
    out: Dict[str, tuple] = {}
    for k, v in items:
        out.update(logical_by_path(v, join(k)))
    return out


def tree_shardings(mesh, params, logical_specs, rules=None):
    """:func:`tree_specs` as a tree of :class:`Sharding`."""
    return _map_specs(lambda s, p: Sharding(mesh, spec_for(mesh, s, tuple(p.shape), rules)),
                      logical_specs, params)


def batch_spec(mesh, extra_dims: int = 1) -> tuple:
    """The spec of a batch-leading tensor: its batch over the batch axes (a
    single one by its name, as ``PartitionSpec`` spells it), ``extra_dims``
    more dimensions replicated."""
    axes = batch_axes(mesh)
    return ((axes[0] if len(axes) == 1 else axes or None),) + (None,) * extra_dims


def replicated(mesh) -> "Sharding":
    """The sharding of a leaf whole on every rank."""
    return Sharding(mesh, ())


def _names(axes: Axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def mesh_coordinate(mesh) -> Dict[str, int]:
    """{dimension name: this rank's index along it} on a DeviceMesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


@dataclass(frozen=True)
class Sharding:
    """The (mesh, spec) of one leaf: which mesh dimensions split which of
    its dimensions.  A dimension split over several mesh dimensions is cut
    major to minor (row-major over them), as ``all_gather`` over their
    flattened group concatenates."""

    mesh: Any
    spec: tuple

    def dim_axes(self, d: int) -> Tuple[str, ...]:
        return _names(self.spec[d]) if d < len(self.spec) else ()

    @property
    def sharded_axes(self) -> Tuple[str, ...]:
        return tuple(a for e in self.spec for a in _names(e))

    @property
    def replicated_axes(self) -> Tuple[str, ...]:
        used = set(self.sharded_axes)
        return tuple(a for a in self.mesh.mesh_dim_names if a not in used)

    def parts(self, d: int) -> int:
        """How many pieces dimension ``d`` is cut into."""
        return axis_size(self.mesh, self.dim_axes(d) or None)

    def index(self, d: int, coord: Optional[Dict[str, int]] = None) -> int:
        """This rank's piece of dimension ``d`` (mixed radix, major first)."""
        coord = mesh_coordinate(self.mesh) if coord is None else coord
        dims = mesh_dims(self.mesh)
        i = 0
        for a in self.dim_axes(d):
            i = i * dims[a] + coord[a]
        return i

    def whole_shape(self, shape) -> tuple:
        """The whole leaf's shape from a piece's."""
        return tuple(n * self.parts(d) if d < len(self.spec) else n
                     for d, n in enumerate(shape))

    def local_shape(self, shape) -> tuple:
        shape = tuple(shape)
        for d in range(min(len(self.spec), len(shape))):
            if shape[d] % self.parts(d):
                raise ValueError(f"dimension {d} of {shape} does not split into "
                                 f"{self.parts(d)} pieces ({self.spec})")
        return tuple(n // self.parts(d) if d < len(self.spec) else n
                     for d, n in enumerate(shape))

    def piece(self, shape, coord: Optional[Dict[str, int]] = None) -> List[tuple]:
        """[(dimension, lo, hi)] of this rank's piece of a whole ``shape``,
        one per split dimension."""
        local = self.local_shape(shape)
        out = []
        for d in range(len(self.spec)):
            if self.parts(d) > 1:
                i = self.index(d, coord)
                out.append((d, i * local[d], (i + 1) * local[d]))
        return out

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's piece of the whole tensor ``x`` (a view)."""
        for d, lo, hi in self.piece(x.shape):
            x = x.narrow(d, lo, hi - lo)
        return x

    def is_writer(self, coord: Optional[Dict[str, int]] = None) -> bool:
        """Whether this rank is the first of the ranks holding its piece
        (index 0 along every replicated mesh dimension)."""
        coord = mesh_coordinate(self.mesh) if coord is None else coord
        return all(coord[a] == 0 for a in self.replicated_axes)

    def group(self, axes: Sequence[str]):
        """The process group over mesh dimensions ``axes`` (this rank's)."""
        from .collectives import _dims_group

        return _dims_group(self.mesh, axes)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole tensor from this rank's piece (no gradient; see
        ``fsdp.gather`` for the differentiable one)."""
        from .collectives import _all_gather

        for d in range(len(self.spec)):
            if self.parts(d) > 1:
                x = _all_gather(self.group(self.dim_axes(d)), x, d)
        return x


def respec(mesh, spec) -> tuple:
    """A saved spec re-resolved on another mesh (the elastic restore): each
    entry whose mesh dimensions the mesh lacks becomes replicated, as the
    reference drops them; ``mesh`` None drops every entry."""
    if mesh is None or spec is None:
        return ()
    dims = mesh_dims(mesh)
    out = [e if all(a in dims for a in _names(e)) else None for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(tuple(e) if isinstance(e, list) else e for e in out)


def spec_json(spec) -> list:
    """A spec as the reference's checkpoint manifests write a
    ``PartitionSpec``: a list of null, a name or a list of names."""
    return [list(e) if isinstance(e, tuple) else e for e in spec]
