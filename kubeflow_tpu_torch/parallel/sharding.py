"""Logical-axis sharding rules: how a parameter dict lands on the mesh.

The port of ``kubeflow_tpu/parallel/sharding.py``. :class:`LogicalRules`
and the tables :data:`REPLICATED_RULES`, :data:`FSDP_RULES` and
:data:`TENSOR_PARALLEL_RULES` are JAX's; a spec is a tuple (per dim None,
a mesh axis or a tuple of axes) where JAX has a ``PartitionSpec``.

:func:`_infer_logical_axes` is JAX's heuristic on a flax path. The port's
parameters have their own names and layouts, so a ``layout`` maps each
name to the flax path, the flax shape and, per port dim, the flax dims it
is made of (``models/convert.py`` ``gpt_flax_layout``); the heuristic runs
on the flax path and its spec is carried onto the port's dims, so a leaf
gets JAX's spec for the same flax path. Without a layout a name is its own
flax path (``a.b.kernel`` is ``a/b/kernel``, the layout-preserving names of
the port's ResNet). :func:`_divisible_spec` drops axes that do not divide,
as JAX's; :func:`shard_pytree` returns this rank's local shard of each
leaf where JAX returns ``NamedSharding``s.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from .mesh import AXIS_EXPERT, AXIS_FSDP, AXIS_MODEL, Mesh, Spec, local_shard

MeshAxes = Union[str, Tuple[str, ...], None]
#: port name -> (flax path, flax shape, per port dim the flax dims it merges)
Layout = Callable[[str, Tuple[int, ...]],
                  Tuple[Tuple[str, ...], Tuple[int, ...], Tuple[Tuple[int, ...], ...]]]


@dataclass(frozen=True)
class LogicalRules:
    """Mapping from logical axis name -> mesh axis (or None = replicate)."""

    rules: Tuple[Tuple[str, MeshAxes], ...]

    @classmethod
    def of(cls, **rules: MeshAxes) -> "LogicalRules":
        return cls(tuple(rules.items()))

    def mesh_axes(self, logical: str) -> MeshAxes:
        for name, axes in self.rules:
            if name == logical:
                return axes
        return None

    def spec(self, logical_axes: Sequence[Optional[str]]) -> Spec:
        return tuple(self.mesh_axes(a) if a else None for a in logical_axes)

    def extended(self, **overrides: MeshAxes) -> "LogicalRules":
        kept = tuple((n, a) for n, a in self.rules if n not in overrides)
        return LogicalRules(kept + tuple(overrides.items()))


#: Everything replicated — single device or pure data parallelism.
REPLICATED_RULES = LogicalRules.of()

#: ZeRO-3: shard the largest parameter axis over the fsdp mesh axis.
FSDP_RULES = LogicalRules.of(
    embed=AXIS_FSDP,
    vocab=AXIS_FSDP,
    conv_out=AXIS_FSDP,
)

#: Megatron-style tensor parallelism for transformer blocks, composed with
#: fsdp on the embedding axis.
TENSOR_PARALLEL_RULES = LogicalRules.of(
    embed=AXIS_FSDP,
    vocab=AXIS_MODEL,
    heads=AXIS_MODEL,
    mlp=AXIS_MODEL,
    conv_out=AXIS_MODEL,
    expert=AXIS_EXPERT,
)


def _infer_logical_axes(path: Sequence[str], rank: int) -> Tuple[Optional[str], ...]:
    """JAX's heuristic logical axes for a parameter at flax ``path`` of
    ``rank`` dims, classified by its owning module (the path component
    before the leaf name). Biases and norms replicate."""
    names = [str(p).lower() for p in path]
    leaf_name = names[-1] if names else ""
    parent = names[-2] if len(names) >= 2 else leaf_name
    if rank <= 1:
        return (None,) * rank
    if leaf_name == "embedding" or "embedding" in parent:
        return ("vocab", "embed") + (None,) * (rank - 2)
    if "conv" in parent and rank == 4:
        return (None, None, None, "conv_out")
    if any(k in parent for k in ("query", "key", "value", "qkv")):
        return ("embed", "heads", None) if rank == 3 else ("embed", "heads")
    if any(k in parent for k in ("out_proj", "wo", "down_proj", "o_proj")):
        return ("heads", None, "embed") if rank == 3 else ("mlp", "embed")
    if "expert" in parent and rank >= 3:
        return ("expert",) + (None,) * (rank - 1)
    if parent in ("router", "gate", "gating") or "router" in parent:
        # the router kernel feeds a per-token top-k: shard nothing ("gate"
        # alone must not land here: "gate_proj" is an MLP kernel)
        return (None,) * rank
    if any(k in parent for k in ("mlp", "intermediate", "wi", "up_proj", "gate")):
        return (None,) * (rank - 1) + ("mlp",)
    if rank == 2:
        return ("embed", None)
    return (None,) * rank


def _divisible_spec(spec: Spec, shape: Tuple[int, ...], mesh: Mesh) -> Spec:
    """Drop mesh axes that don't divide the dimension (tiny embeddings etc.)."""
    fixed = []
    for dim, axes in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if axes is None:
            fixed.append(None)
            continue
        fixed.append(axes if dim % mesh.size(axes) == 0 else None)
    return tuple(fixed)


def identity_layout(name: str, shape: Tuple[int, ...]):
    """A port name that is its flax path with ``.`` for ``/``, same layout."""
    return tuple(name.split(".")), tuple(shape), tuple((i,) for i in range(len(shape)))


def param_spec(name: str, shape: Tuple[int, ...], mesh: Mesh, rules: LogicalRules,
               layout: Optional[Layout] = None) -> Spec:
    """The spec, on the port's dims, that JAX gives the flax leaf behind
    ``name``: the heuristic and the rules on the flax path and shape,
    :func:`_divisible_spec` there, then each port dim takes the spec of the
    first flax dim it merges (the others must be unsharded)."""
    path, flax_shape, groups = (layout or identity_layout)(name, tuple(shape))
    flax_spec = _divisible_spec(
        rules.spec(_infer_logical_axes(path, len(flax_shape))), flax_shape, mesh)
    spec = []
    for group in groups:
        if any(flax_spec[d] is not None for d in group[1:]):
            raise ValueError(f"{name}: flax dims {group} merge into one port dim but "
                             f"{flax_spec} shards an inner one")
        spec.append(flax_spec[group[0]])
    return tuple(spec)


def param_specs(params: Dict[str, torch.Tensor], mesh: Mesh, rules: LogicalRules,
                layout: Optional[Layout] = None) -> Dict[str, Spec]:
    return {n: param_spec(n, tuple(p.shape), mesh, rules, layout) for n, p in params.items()}


def shard_pytree(params: Dict[str, torch.Tensor], mesh: Mesh, rules: LogicalRules,
                 layout: Optional[Layout] = None) -> Dict[str, torch.Tensor]:
    """This rank's local shard of each (global) parameter, on the mesh's device."""
    specs = param_specs(params, mesh, rules, layout)
    return {n: local_shard(p, mesh, specs[n]).to(mesh.device).contiguous()
            for n, p in params.items()}
