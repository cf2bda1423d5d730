"""Create-or-update reconcile helpers with field-copy diffing.

A copy of ``kubeflow_tpu/runtime/reconcile.py``: create the desired object
if it is absent; otherwise copy only the fields a controller owns onto the
found object and update only when something changed, never clobbering
fields the cluster manages (``spec.clusterIP``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ..api import meta as apimeta
from ..apiserver.client import Client


def _copy_meta_fields(desired: Dict[str, Any], found: Dict[str, Any]) -> bool:
    changed = False
    for field in ("labels", "annotations", "ownerReferences"):
        want = desired["metadata"].get(field)
        if want is not None and found["metadata"].get(field) != want:
            found["metadata"][field] = want
            changed = True
    return changed


def copy_statefulset_fields(desired: Dict[str, Any], found: Dict[str, Any]) -> bool:
    """reference: CopyStatefulSetFields (util.go:107-134)."""
    changed = _copy_meta_fields(desired, found)
    if found.get("spec", {}).get("replicas") != desired.get("spec", {}).get("replicas"):
        found.setdefault("spec", {})["replicas"] = desired["spec"].get("replicas")
        changed = True
    if found.get("spec", {}).get("template") != desired.get("spec", {}).get("template"):
        found.setdefault("spec", {})["template"] = desired["spec"]["template"]
        changed = True
    return changed


def copy_deployment_fields(desired: Dict[str, Any], found: Dict[str, Any]) -> bool:
    changed = _copy_meta_fields(desired, found)
    if found.get("spec") != desired.get("spec"):
        found["spec"] = desired["spec"]
        changed = True
    return changed


def copy_service_fields(desired: Dict[str, Any], found: Dict[str, Any]) -> bool:
    """Preserves clusterIP (reference: util.go:166-197)."""
    changed = _copy_meta_fields(desired, found)
    cluster_ip = found.get("spec", {}).get("clusterIP")
    if found.get("spec") != desired.get("spec"):
        preserved = desired["spec"].get("clusterIP", cluster_ip)
        if found.get("spec", {}) != {**desired["spec"], "clusterIP": preserved}:
            found["spec"] = dict(desired["spec"])
            if cluster_ip is not None:
                found["spec"]["clusterIP"] = cluster_ip
            changed = True
    return changed


def copy_spec_fields(desired: Dict[str, Any], found: Dict[str, Any]) -> bool:
    """Generic: controller owns metadata labels/annotations + whole spec
    (used for VirtualService & other unstructured — util.go:199-219)."""
    changed = _copy_meta_fields(desired, found)
    if found.get("spec") != desired.get("spec"):
        found["spec"] = desired["spec"]
        changed = True
    return changed


def copy_rolebinding_fields(desired: Dict[str, Any], found: Dict[str, Any]) -> bool:
    """RBAC objects carry top-level roleRef/subjects rather than a spec."""
    changed = _copy_meta_fields(desired, found)
    for field in ("roleRef", "subjects"):
        if field in desired and found.get(field) != desired[field]:
            found[field] = desired[field]
            changed = True
    return changed


_COPIERS = {
    "StatefulSet": copy_statefulset_fields,
    "Deployment": copy_deployment_fields,
    "Service": copy_service_fields,
    "RoleBinding": copy_rolebinding_fields,
    "ClusterRoleBinding": copy_rolebinding_fields,
}


def reconcile_object(
    client: Client, desired: Dict[str, Any], owner: Optional[Dict[str, Any]] = None
) -> Dict[str, Any]:
    """Create-or-update ``desired``; returns the live object."""
    if owner is not None:
        apimeta.set_owner_reference(desired, owner)
    found = client.get_opt(
        apimeta.api_version_of(desired),
        desired["kind"],
        apimeta.name_of(desired),
        apimeta.namespace_of(desired),
    )
    if found is None:
        return client.create(desired)
    copier = _COPIERS.get(desired["kind"], copy_spec_fields)
    if copier(desired, found):
        return client.update(found)
    return found
