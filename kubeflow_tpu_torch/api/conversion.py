"""API version conversion: hub and spoke, served at the REST layer.

A trimmed copy of ``kubeflow_tpu/api/conversion.py``: spoke versions are
registered REST surfaces, objects are stored at the hub version only, and
the apiserver converts on the way in and out (a stamp swap plus any
registered field mapper). In-process clients speak the hub version. The
Notebook kind serves v1alpha1 and v1 as spokes of its v1beta1 hub, as in
the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from . import meta as apimeta
from .meta import REGISTRY, Resource

#: (group, kind) -> hub (storage) version
_HUBS: Dict[Tuple[str, str], str] = {}

#: (group, kind, from_version, to_version) -> field mapper (post stamp-swap)
_MAPPERS: Dict[Tuple[str, str, str, str], Callable[[Dict[str, Any]], Dict[str, Any]]] = {}


def register_spokes(group: str, kind: str, hub_version: str, *spoke_versions: str) -> None:
    """Declare spoke versions for a kind whose hub Resource is registered."""
    hub = REGISTRY.for_gvk(apimeta.GroupVersionKind(group, hub_version, kind))
    _HUBS[(group, kind)] = hub_version
    for version in spoke_versions:
        REGISTRY.register(
            Resource(group, version, kind, hub.plural, namespaced=hub.namespaced,
                     list_kind=hub.list_kind)
        )


def register_mapper(group: str, kind: str, from_version: str, to_version: str,
                    fn: Callable[[Dict[str, Any]], Dict[str, Any]]) -> None:
    _MAPPERS[(group, kind, from_version, to_version)] = fn


def hub_version(group: str, kind: str) -> Optional[str]:
    return _HUBS.get((group, kind))


def hub_resource(res: Resource) -> Resource:
    """The storage Resource for ``res`` (itself if it IS the hub or has none)."""
    hub = _HUBS.get((res.group, res.kind))
    if hub is None or hub == res.version:
        return res
    return REGISTRY.for_gvk(apimeta.GroupVersionKind(res.group, hub, res.kind))


def convert(obj: Dict[str, Any], group: str, kind: str, to_version: str) -> Dict[str, Any]:
    """Convert between served versions: stamp swap + registered mapper."""
    current = apimeta.gvk_of(obj).version
    if current == to_version:
        return obj
    out = apimeta.deepcopy(obj)
    out["apiVersion"] = f"{group}/{to_version}" if group else to_version
    mapper = _MAPPERS.get((group, kind, current, to_version))
    if mapper is not None:
        out = mapper(out)
    return out


def convert_fragment(
    fragment: Dict[str, Any], group: str, kind: str, from_version: str, to_version: str
) -> Dict[str, Any]:
    """Convert a PARTIAL object (merge-patch body) between versions.

    Mappers must tolerate partial objects (missing sections untouched) —
    the contract a merge patch at a spoke endpoint needs so version-specific
    field renames apply before the merge into hub storage."""
    if from_version == to_version:
        return fragment
    mapper = _MAPPERS.get((group, kind, from_version, to_version))
    if mapper is None:
        return fragment
    return mapper(apimeta.deepcopy(fragment))


# --- platform registrations --------------------------------------------------
# Notebook: hub v1beta1, spokes v1alpha1 + v1 (reference hub-and-spoke —
# notebook-controller registers 3 API versions, main.go:40-47; conversion is
# structural identity, api/v1/notebook_conversion.go).
register_spokes("kubeflow.org", "Notebook", "v1beta1", "v1alpha1", "v1")
