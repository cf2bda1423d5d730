"""Gang labels and the drain protocol's annotations: a trimmed copy of
``kubeflow_tpu/scheduler/gang.py``.

The port has no scheduler (ROADMAP: the control plane is not ported). It
keeps what the elastic trainer and the straggler detector read and write
on a gang's Pods and Nodes, with JAX's names and values, so they speak the
JAX scheduler's drain protocol (docs/ELASTICITY.md) to any client that
holds those objects:

- the gang label and size annotation, and :func:`gang_of`;
- the drain protocol: a workload opts in with ``DRAIN_GRACE``, the
  scheduler (or the straggler detector) writes ``DRAIN_DEADLINE`` (unix
  seconds), the workload acks with ``DRAIN_ACK`` (the step it saved);
- the node quarantine annotation the straggler detector stamps;
- :data:`TERMINAL_PHASES` and :func:`is_terminal`;
- ``annotations_of`` and friends, the accessors of ``api/meta.py``.

Priorities, quotas and the scheduling predicate stay in the control plane.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

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
    """One co-scheduling unit: which pods and how many expected. The JAX
    copy carries a priority too, which only its scheduler reads."""

    namespace: Optional[str]
    name: str
    size: int
    labeled: bool  # explicit pod-group label vs implicit gang-of-one

    @property
    def key(self) -> Tuple[Optional[str], str]:
        return (self.namespace, self.name)


def gang_of(pod: Dict[str, Any]) -> Gang:
    ns = namespace_of(pod)
    group = labels_of(pod).get(POD_GROUP_LABEL)
    if not group:
        # implicit gang of one; "pod:" keeps the key space disjoint from
        # label values (which cannot contain ":")
        return Gang(ns, f"pod:{name_of(pod)}", 1, False)
    try:
        size = int(annotations_of(pod).get(POD_GROUP_SIZE_ANNOTATION, "1"))
    except ValueError:
        size = 1
    return Gang(ns, group, max(size, 1), True)


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
