"""API machinery: the object model, the kind registry and label selectors.

A trimmed copy of ``kubeflow_tpu/api/meta.py`` for the port's control
plane. Objects are plain dicts in Kubernetes wire shape (``apiVersion``,
``kind``, ``metadata``, ``spec``, ``status``). The registry maps each kind
to its REST coordinates so the client, the store, the apiserver and the
controllers agree on addressing; it holds the same kinds as the JAX
package's, so the port's apiserver accepts what JAX's accepts.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional


@dataclass(frozen=True)
class GroupVersionKind:
    group: str
    version: str
    kind: str

    @property
    def api_version(self) -> str:
        return f"{self.group}/{self.version}" if self.group else self.version


@dataclass(frozen=True)
class Resource:
    """REST coordinates for a kind."""

    group: str
    version: str
    kind: str
    plural: str
    namespaced: bool = True
    list_kind: str = ""

    @property
    def api_version(self) -> str:
        return f"{self.group}/{self.version}" if self.group else self.version

    @property
    def gvk(self) -> GroupVersionKind:
        return GroupVersionKind(self.group, self.version, self.kind)

    @property
    def key(self) -> str:
        """Storage/watch key prefix: group/version/plural."""
        return f"{self.group or 'core'}/{self.version}/{self.plural}"


class ResourceRegistry:
    def __init__(self) -> None:
        self._by_gvk: Dict[GroupVersionKind, Resource] = {}
        self._by_plural: Dict[tuple, Resource] = {}  # (apiVersion, plural)

    def register(self, res: Resource) -> Resource:
        self._by_gvk[res.gvk] = res
        self._by_plural[(res.api_version, res.plural)] = res
        return res

    def for_object(self, obj: Dict[str, Any]) -> Resource:
        return self.for_gvk(gvk_of(obj))

    def for_gvk(self, gvk: GroupVersionKind) -> Resource:
        try:
            return self._by_gvk[gvk]
        except KeyError:
            raise KeyError(f"kind not registered: {gvk}") from None

    def for_kind(self, api_version: str, kind: str) -> Resource:
        group, _, version = api_version.rpartition("/")
        return self.for_gvk(GroupVersionKind(group, version, kind))

    def for_plural(self, api_version: str, plural: str) -> Resource:
        try:
            return self._by_plural[(api_version, plural)]
        except KeyError:
            raise KeyError(f"resource not registered: {api_version}/{plural}") from None

    def all(self) -> List[Resource]:
        return list(self._by_gvk.values())


REGISTRY = ResourceRegistry()

# --- Built-in kinds (the subset of core Kubernetes the platform touches) ----
for _res in [
    Resource("", "v1", "Pod", "pods"),
    Resource("", "v1", "Service", "services"),
    Resource("", "v1", "Endpoints", "endpoints"),
    Resource("", "v1", "Namespace", "namespaces", namespaced=False),
    Resource("", "v1", "Node", "nodes", namespaced=False),
    Resource("", "v1", "Event", "events"),
    Resource("", "v1", "ConfigMap", "configmaps"),
    Resource("", "v1", "Secret", "secrets"),
    Resource("", "v1", "PersistentVolumeClaim", "persistentvolumeclaims"),
    Resource("", "v1", "ServiceAccount", "serviceaccounts"),
    Resource("", "v1", "ResourceQuota", "resourcequotas"),
    Resource("apps", "v1", "StatefulSet", "statefulsets"),
    Resource("apps", "v1", "Deployment", "deployments"),
    Resource("rbac.authorization.k8s.io", "v1", "Role", "roles"),
    Resource("rbac.authorization.k8s.io", "v1", "RoleBinding", "rolebindings"),
    Resource("rbac.authorization.k8s.io", "v1", "ClusterRole", "clusterroles", namespaced=False),
    Resource(
        "rbac.authorization.k8s.io", "v1", "ClusterRoleBinding", "clusterrolebindings", namespaced=False
    ),
    Resource("storage.k8s.io", "v1", "StorageClass", "storageclasses", namespaced=False),
    # Dynamic admission registration (reference: admission-webhook/manifests/
    # base/mutating-webhook-configuration.yaml:1-23) — the apiserver watches
    # these instead of being wired by a WEBHOOK_URL env.
    Resource(
        "admissionregistration.k8s.io", "v1", "MutatingWebhookConfiguration",
        "mutatingwebhookconfigurations", namespaced=False,
    ),
    # Controller HA leases (reference: -enable-leader-election on every
    # controller binary, notebook-controller/main.go:55-66).
    Resource("coordination.k8s.io", "v1", "Lease", "leases"),
    # Istio objects the controllers emit (stored as unstructured, same as the
    # reference does via the dynamic client — notebook_controller.go:401-496).
    Resource("networking.istio.io", "v1beta1", "VirtualService", "virtualservices"),
    Resource("security.istio.io", "v1beta1", "AuthorizationPolicy", "authorizationpolicies"),
    # Platform CRDs (their schemas are in the JAX package, api/crds.py).
    Resource("kubeflow.org", "v1beta1", "Notebook", "notebooks"),
    Resource("kubeflow.org", "v1", "Profile", "profiles", namespaced=False),
    Resource("tensorboard.kubeflow.org", "v1alpha1", "Tensorboard", "tensorboards"),
    Resource("kubeflow.org", "v1alpha1", "PodDefault", "poddefaults"),
    Resource("katib.kubeflow.org", "v1alpha1", "StudyJob", "studyjobs"),
    Resource("katib.kubeflow.org", "v1alpha1", "Trial", "trials"),
    Resource("serving.kubeflow.org", "v1alpha1", "InferenceService", "inferenceservices"),
]:
    REGISTRY.register(_res)


# --- Object helpers ---------------------------------------------------------


def new_object(
    api_version: str,
    kind: str,
    name: str,
    namespace: Optional[str] = None,
    labels: Optional[Dict[str, str]] = None,
    annotations: Optional[Dict[str, str]] = None,
    **top_level: Any,
) -> Dict[str, Any]:
    meta: Dict[str, Any] = {"name": name}
    if namespace is not None:
        meta["namespace"] = namespace
    if labels:
        meta["labels"] = dict(labels)
    if annotations:
        meta["annotations"] = dict(annotations)
    obj: Dict[str, Any] = {"apiVersion": api_version, "kind": kind, "metadata": meta}
    obj.update(top_level)
    return obj


def now_rfc3339() -> str:
    """RFC3339 with microseconds (metav1.MicroTime) — Lease renewTime needs
    sub-second resolution so rapid renewals are distinguishable."""
    import datetime as _dt

    return _dt.datetime.now(_dt.timezone.utc).strftime("%Y-%m-%dT%H:%M:%S.%fZ")


def gvk_of(obj: Dict[str, Any]) -> GroupVersionKind:
    api_version = obj.get("apiVersion", "")
    group, _, version = api_version.rpartition("/")
    return GroupVersionKind(group, version, obj.get("kind", ""))


def api_version_of(obj: Dict[str, Any]) -> str:
    return obj.get("apiVersion", "")


def name_of(obj: Dict[str, Any]) -> str:
    return obj.get("metadata", {}).get("name", "")


def namespace_of(obj: Dict[str, Any]) -> Optional[str]:
    return obj.get("metadata", {}).get("namespace")


def uid_of(obj: Dict[str, Any]) -> str:
    return obj.get("metadata", {}).get("uid", "")


def labels_of(obj: Dict[str, Any]) -> Dict[str, str]:
    return obj.get("metadata", {}).get("labels") or {}


def annotations_of(obj: Dict[str, Any]) -> Dict[str, str]:
    return obj.get("metadata", {}).get("annotations") or {}


def owner_reference(owner: Dict[str, Any], controller: bool = True) -> Dict[str, Any]:
    return {
        "apiVersion": api_version_of(owner),
        "kind": owner.get("kind", ""),
        "name": name_of(owner),
        "uid": uid_of(owner),
        "controller": controller,
        "blockOwnerDeletion": True,
    }


def set_owner_reference(obj: Dict[str, Any], owner: Dict[str, Any]) -> Dict[str, Any]:
    refs = obj.setdefault("metadata", {}).setdefault("ownerReferences", [])
    ref = owner_reference(owner)
    for existing in refs:
        if existing.get("uid") == ref["uid"] and existing.get("name") == ref["name"]:
            return obj
    refs.append(ref)
    return obj


def controller_owner_of(obj: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    for ref in obj.get("metadata", {}).get("ownerReferences", []) or []:
        if ref.get("controller"):
            return ref
    return None


def deepcopy(obj: Dict[str, Any]) -> Dict[str, Any]:
    return copy.deepcopy(obj)


# --- Label selectors --------------------------------------------------------
# Full LabelSelector semantics (matchLabels + matchExpressions with
# In/NotIn/Exists/DoesNotExist), as consumed by the PodDefault webhook
# (reference: admission-webhook/main.go:69-94).


def matches_selector(labels: Dict[str, str], selector: Optional[Dict[str, Any]]) -> bool:
    if selector is None:
        return True
    labels = labels or {}
    for key, value in (selector.get("matchLabels") or {}).items():
        if labels.get(key) != value:
            return False
    for expr in selector.get("matchExpressions") or []:
        key = expr.get("key", "")
        op = expr.get("operator", "")
        values = expr.get("values") or []
        if op == "In":
            if labels.get(key) not in values:
                return False
        elif op == "NotIn":
            if key in labels and labels[key] in values:
                return False
        elif op == "Exists":
            if key not in labels:
                return False
        elif op == "DoesNotExist":
            if key in labels:
                return False
        else:
            raise ValueError(f"unknown selector operator: {op!r}")
    return True


def match_label_selector(
    objects: Iterable[Dict[str, Any]], selector: Optional[Dict[str, Any]]
) -> List[Dict[str, Any]]:
    return [o for o in objects if matches_selector(labels_of(o), selector)]


def parse_selector_string(sel: str) -> Dict[str, str]:
    """Parse ``k1=v1,k2=v2`` query-string selectors (list/watch requests)."""
    out: Dict[str, str] = {}
    for part in sel.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad selector segment: {part!r}")
        k, _, v = part.partition("=")
        out[k.strip()] = v.strip().lstrip("=")
    return out


@dataclass
class Condition:
    """Status condition helper (Profile/Notebook conditions —
    profile-controller api/v1/profile_types.go:49-53)."""

    type: str
    status: str = "True"
    reason: str = ""
    message: str = ""
    extra: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self, now: str) -> Dict[str, Any]:
        d = {
            "type": self.type,
            "status": self.status,
            "lastTransitionTime": now,
        }
        if self.reason:
            d["reason"] = self.reason
        if self.message:
            d["message"] = self.message
        d.update(self.extra)
        return d
