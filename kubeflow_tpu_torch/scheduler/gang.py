"""Gang (pod-group) model: labels, sizes, priorities, the drain protocol
and the predicate deciding which pods the scheduler owns.

The port of ``kubeflow_tpu/scheduler/gang.py`` for ``nvidia.com/gpu``
nodes. A multi-node job is useless until EVERY member is bound: owners
stamp their pods with a pod-group label and an expected-size annotation,
and the scheduler (``core.py``) places the members all-or-nothing. Pods
without the label form an implicit gang of one. With JAX's names and
values:

- the gang label and size annotation, priorities, and :func:`gang_of`;
- the drain protocol the elastic trainer speaks: a workload opts in with
  ``DRAIN_GRACE``, the scheduler (or the straggler detector) writes
  ``DRAIN_DEADLINE`` (unix seconds), the workload acks with ``DRAIN_ACK``
  (the step it saved);
- the node quarantine annotation the straggler detector stamps;
- the namespace ResourceQuota the scheduler admits against, whose hard
  key here is ``requests.nvidia.com/gpu`` (JAX: ``requests.google.com/tpu``);
- :func:`requires_scheduling`, with a ``nvidia.com/gpu`` ask where JAX
  reads ``google.com/tpu``;
- ``annotations_of`` and friends, the accessors of ``api/meta.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from ..gpu.topology import RESOURCE_GPU, pod_gpu_chips

#: Label naming the gang a pod belongs to (value: gang name, unique per ns).
POD_GROUP_LABEL = "scheduling.kubeflow.org/pod-group"
#: Annotation carrying the expected member count of the gang.
POD_GROUP_SIZE_ANNOTATION = "scheduling.kubeflow.org/pod-group-size"

#: Drain protocol annotations: grace opted into, the eviction deadline
#: (unix seconds), and the workload's ack (the step it checkpointed).
DRAIN_GRACE_ANNOTATION = "scheduling.kubeflow.org/drain-grace-seconds"
DRAIN_DEADLINE_ANNOTATION = "scheduling.kubeflow.org/drain-deadline"
DRAIN_ACK_ANNOTATION = "scheduling.kubeflow.org/drain-acked"

#: Node quarantine annotation, stamped by the straggler detector on a node
#: hosting a hung worker (a JSON verdict; cordon, not drain).
QUARANTINE_ANNOTATION = "scheduling.kubeflow.org/quarantined"

#: Name of the per-namespace ResourceQuota the scheduler admits against.
QUOTA_NAME = "kf-resource-quota"
#: The hard-limit key for GPU cards inside that quota.
GPU_QUOTA_KEY = f"requests.{RESOURCE_GPU}"

#: priorityClassName → numeric priority. Notebooks outrank trials: an
#: interactive user waiting on cards preempts batch HPO.
PRIORITY_CLASSES: Dict[str, int] = {
    "system": 1000,
    "notebook": 100,
    "default": 50,
    "trial": 10,
    "batch": 0,
}
DEFAULT_PRIORITY = PRIORITY_CLASSES["default"]

TERMINAL_PHASES = ("Succeeded", "Failed")


def name_of(obj: Dict[str, Any]) -> str:
    return obj.get("metadata", {}).get("name", "")


def namespace_of(obj: Dict[str, Any]) -> Optional[str]:
    return obj.get("metadata", {}).get("namespace")


def labels_of(obj: Dict[str, Any]) -> Dict[str, str]:
    return obj.get("metadata", {}).get("labels") or {}


def annotations_of(obj: Dict[str, Any]) -> Dict[str, str]:
    return obj.get("metadata", {}).get("annotations") or {}


@dataclass(frozen=True)
class Gang:
    """One co-scheduling unit: which pods, how many expected, what rank."""

    namespace: Optional[str]
    name: str
    size: int
    priority: int
    labeled: bool  # explicit pod-group label vs implicit gang-of-one

    @property
    def key(self) -> Tuple[Optional[str], str]:
        return (self.namespace, self.name)


def priority_of(pod: Dict[str, Any]) -> int:
    spec = pod.get("spec") or {}
    explicit = spec.get("priority")
    if isinstance(explicit, int):
        return explicit
    return PRIORITY_CLASSES.get(spec.get("priorityClassName", ""), DEFAULT_PRIORITY)


def gang_of(pod: Dict[str, Any]) -> Gang:
    ns = namespace_of(pod)
    group = labels_of(pod).get(POD_GROUP_LABEL)
    if not group:
        # implicit gang of one; "pod:" keeps the key space disjoint from
        # label values (which cannot contain ":")
        return Gang(ns, f"pod:{name_of(pod)}", 1, priority_of(pod), False)
    try:
        size = int(annotations_of(pod).get(POD_GROUP_SIZE_ANNOTATION, "1"))
    except ValueError:
        size = 1
    return Gang(ns, group, max(size, 1), priority_of(pod), True)


def drain_grace_of(pod: Dict[str, Any]) -> float:
    """Seconds of drain grace this pod opted into (0 = evict immediately)."""
    raw = annotations_of(pod).get(DRAIN_GRACE_ANNOTATION)
    if raw is None:
        return 0.0
    try:
        return max(0.0, float(raw))
    except (TypeError, ValueError):
        return 0.0


def is_quarantined(node: Dict[str, Any]) -> bool:
    """Is this node cordoned by the straggler detector? Any value other
    than empty/"false" counts — the annotation carries a JSON verdict."""
    raw = annotations_of(node).get(QUARANTINE_ANNOTATION)
    return raw is not None and raw not in ("", "false")


def is_terminal(pod: Dict[str, Any]) -> bool:
    return (pod.get("status") or {}).get("phase") in TERMINAL_PHASES


def requires_scheduling(pod: Dict[str, Any], have_nodes: bool) -> bool:
    """Does this pod need a node before the kubelet may run it? With zero
    nodes in the store, pods that ask for no card just run; a pod asking
    for ``nvidia.com/gpu`` cards waits for a node with capacity, as on a
    cluster with no GPU node pool."""
    if is_terminal(pod):
        return False
    if (pod.get("spec") or {}).get("nodeName"):
        return False
    return have_nodes or pod_gpu_chips(pod) > 0
