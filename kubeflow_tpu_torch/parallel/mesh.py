"""Device mesh of the port: one process per device, a mesh axis per process group.

The port of ``kubeflow_tpu/parallel/mesh.py``. The axis vocabulary,
:data:`CANONICAL_AXES`, :data:`BATCH_AXES` and :meth:`MeshConfig.sizes`
(with JAX's messages) are JAX's. Where JAX lays a ``jax.sharding.Mesh``
over the devices of one program, the port's manual SPMD runs one process
per device: :func:`make_mesh` arranges the ``torch.distributed`` world's
ranks in JAX's row-major order over the canonical axes, and each axis (or
tuple of axes, such as :data:`BATCH_AXES`) is the process group of the
ranks that differ only along it. A rank holds its local shard of every
array as a plain tensor; :func:`local_shard` cuts it from a global array by
a JAX ``PartitionSpec``-shaped tuple, :func:`local_batch` by
:func:`batch_spec`, in place of ``batch_sharding``/``replicated``.

``torch.distributed.new_group`` is collective over the whole world, so
:func:`make_mesh` creates every group it will ever hand out (each axis and
:data:`BATCH_AXES`) at once, in one fixed order on every rank. Given
``devices`` (JAX's argument: here a list of world ranks), it lays the mesh
over those ranks alone; the others still take part in the ``new_group``
calls and get no mesh (the elastic trainer's offer smaller than the world). The backend
follows the device: ``nccl`` on CUDA, ``gloo`` on the CPU
(:func:`backend_for`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_MODEL = "model"
AXIS_SEQ = "seq"
AXIS_PIPE = "pipe"
AXIS_EXPERT = "expert"

#: Order matters: outermost (slowest-varying) first, as in JAX.
CANONICAL_AXES: Tuple[str, ...] = (AXIS_DATA, AXIS_FSDP, AXIS_PIPE, AXIS_EXPERT, AXIS_SEQ,
                                   AXIS_MODEL)

#: Axes over which a batch is split (each holds a distinct slice of examples).
BATCH_AXES: Tuple[str, ...] = (AXIS_DATA, AXIS_FSDP)

Axes = Union[str, Tuple[str, ...]]
#: a JAX ``PartitionSpec`` as a tuple: per dim None, an axis, or a tuple of axes
Spec = Tuple[Optional[Axes], ...]


@dataclass(frozen=True)
class MeshConfig:
    """Sizes for each canonical axis; unspecified axes default to 1, and one
    axis set to -1 takes what is left of the world, as in JAX."""

    data: int = -1
    fsdp: int = 1
    pipe: int = 1
    expert: int = 1
    seq: int = 1
    model: int = 1

    def sizes(self, num_devices: int) -> Dict[str, int]:
        raw = {
            AXIS_DATA: self.data,
            AXIS_FSDP: self.fsdp,
            AXIS_PIPE: self.pipe,
            AXIS_EXPERT: self.expert,
            AXIS_SEQ: self.seq,
            AXIS_MODEL: self.model,
        }
        wild = [a for a, s in raw.items() if s == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one mesh axis may be -1; got {wild}")
        fixed = 1
        for a, s in raw.items():
            if s != -1:
                if s < 1:
                    raise ValueError(f"mesh axis {a!r} must be >= 1 or -1, got {s}")
                fixed *= s
        if wild:
            if num_devices % fixed:
                raise ValueError(
                    f"{num_devices} devices not divisible by fixed axes product {fixed}")
            raw[wild[0]] = num_devices // fixed
        total = int(np.prod(list(raw.values())))
        if total != num_devices:
            raise ValueError(
                f"mesh axes {raw} multiply to {total}, but {num_devices} devices are present")
        return raw

    def axis_names(self) -> Tuple[str, ...]:
        return CANONICAL_AXES


def backend_for(device: DeviceLike) -> str:
    """The ``torch.distributed`` backend a device's collectives run on."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """This rank's view of the world laid out over :data:`CANONICAL_AXES`.

    ``shape`` maps each axis to its size (``mesh.shape[axis]`` as in JAX);
    ``rank`` is this rank's place among the mesh's ranks (its world rank
    unless :func:`make_mesh` was given ``devices``);
    ``coordinate(axis)`` is ``lax.axis_index`` for this rank;
    ``group(axes)`` the process group of one axis or a tuple of axes
    (flattened row-major, data outermost), ``size(axes)`` its size and
    ``index(axes)`` this rank's place in it."""

    def __init__(self, sizes: Dict[str, int], rank: int, device: torch.device,
                 groups: Dict[Tuple[str, ...], object], members: Dict[Tuple[str, ...], list]):
        self.shape = {a: sizes[a] for a in CANONICAL_AXES}
        self.rank = rank
        self.device = device
        self._groups = groups
        self._members = members
        dims = tuple(self.shape[a] for a in CANONICAL_AXES)
        self._coords = dict(zip(CANONICAL_AXES, np.unravel_index(rank, dims)))

    def coordinate(self, axis: str) -> int:
        return int(self._coords[axis])

    def size(self, axes: Axes) -> int:
        return int(np.prod([self.shape[a] for a in _axes(axes)]))

    def index(self, axes: Axes) -> int:
        """This rank's row-major index over ``axes`` (its place in ``group(axes)``)."""
        idx = 0
        for a in _axes(axes):
            idx = idx * self.shape[a] + self.coordinate(a)
        return idx

    def _key(self, axes: Axes) -> Tuple[str, ...]:
        key = _axes(axes)
        if key not in self._groups:
            raise KeyError(f"mesh has no group for axes {key}; it builds one per axis "
                           f"and {BATCH_AXES}")
        return key

    def group(self, axes: Axes):
        return self._groups[self._key(axes)]

    def group_ranks(self, axes: Axes) -> list:
        """Global ranks of this rank's group over ``axes``, in index order."""
        return self._members[self._key(axes)]

    def __repr__(self) -> str:
        return f"Mesh(rank={self.rank}, shape={self.shape}, device={self.device})"


def _member_lists(sizes: Dict[str, int], axes: Tuple[str, ...]) -> list:
    """Every group over ``axes``: the global ranks that share the other
    coordinates, each list ordered by the row-major index over ``axes``."""
    dims = tuple(sizes[a] for a in CANONICAL_AXES)
    ranks = np.arange(int(np.prod(dims))).reshape(dims)
    pos = [CANONICAL_AXES.index(a) for a in axes]
    rest = [i for i in range(len(CANONICAL_AXES)) if i not in pos]
    moved = ranks.transpose(rest + pos).reshape(-1, int(np.prod([dims[p] for p in pos])))
    return [row.tolist() for row in moved]


def make_mesh(config: Optional[MeshConfig] = None, *, devices: Optional[Sequence[int]] = None,
              device: DeviceLike = "cuda") -> Optional[Mesh]:
    """The mesh over the initialized ``torch.distributed`` world, in JAX's
    row-major order. Collective: every rank of the world calls it with the
    same ``config`` and ``devices``. ``devices`` (JAX's argument) lays the
    mesh over these world ranks, in increasing order, instead of the whole
    world; ``MeshConfig(data=-1)`` then resolves against their count, and a
    rank outside the list gets None (it still takes part in every
    ``new_group``). ``device`` is where this rank's tensors live (``"cuda"``
    means the current card; raises without CUDA unless ``"cpu"``)."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized torch.distributed world "
                           "(parallel.distributed.initialize, or init_process_group)")
    world, rank = dist.get_world_size(), dist.get_rank()
    ranks = list(range(world)) if devices is None else [int(r) for r in devices]
    if not ranks or ranks != sorted(set(ranks)) or ranks[0] < 0 or ranks[-1] >= world:
        raise ValueError(f"devices must be distinct world ranks in increasing order "
                         f"(world {world}), got {ranks}")
    sizes = (config or MeshConfig()).sizes(len(ranks))
    groups: Dict[Tuple[str, ...], object] = {}
    members: Dict[Tuple[str, ...], list] = {}
    # new_group is collective over the world: same calls, same order, everywhere
    for key in [(a,) for a in CANONICAL_AXES] + [BATCH_AXES]:
        for local in _member_lists(sizes, key):
            world_ranks = [ranks[i] for i in local]
            if len(world_ranks) == world:
                g = dist.group.WORLD
            else:
                g = dist.new_group(world_ranks)
            if rank in world_ranks:
                groups[key], members[key] = g, world_ranks
    if rank not in ranks:
        return None
    return Mesh(sizes, ranks.index(rank), dev, groups, members)


def batch_spec(extra_dims: int = 0) -> Spec:
    """Dim 0 over every batch axis, the rest replicated (JAX's ``batch_spec``)."""
    return (BATCH_AXES,) + (None,) * extra_dims


def global_batch_divisor(mesh: Mesh) -> int:
    """How many ways the batch dimension is split on this mesh."""
    return mesh.size(BATCH_AXES)


def local_shard(x, mesh: Mesh, spec: Spec):
    """This rank's block of the global array ``x`` (tensor or numpy) under
    ``spec``: each dim named by axes is cut into as many equal blocks as
    they have ranks, and the block at this rank's row-major index over them
    is kept. A dim that does not divide raises."""
    out = x
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        n = mesh.size(axes)
        if out.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {out.shape[dim]} does not split "
                             f"{n} ways over {axes}")
        step = out.shape[dim] // n
        i = mesh.index(axes)
        index = [slice(None)] * out.ndim
        index[dim] = slice(i * step, (i + 1) * step)
        out = out[tuple(index)]
    return out


def local_batch(x, mesh: Mesh):
    """This rank's slice of a global batch (dim 0 over :data:`BATCH_AXES`)."""
    return local_shard(x, mesh, batch_spec())

