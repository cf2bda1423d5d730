"""Cluster-substrate controllers: a fake kubelet and the GPU node fixture.

The part of ``kubeflow_tpu/controllers/builtin.py`` the scheduling path
needs. ``PodletReconciler`` is a pure kubelet: it runs whatever the
scheduler bound and never places a pod itself. ``make_gpu_node`` is the
counterpart of JAX's ``make_tpu_node``: a node advertising
``nvidia.com/gpu`` capacity and the ``nvidia.com/gpu.product`` label GPU
feature discovery sets. The StatefulSet and Deployment reconcilers wait
for the notebook path.
"""

from __future__ import annotations

from typing import Any, Dict

from ..api import meta as apimeta
from ..apiserver.client import Client
from ..gpu.topology import ACCELERATORS, NODE_LABEL_PRODUCT, RESOURCE_GPU
from ..runtime.manager import Reconciler, Request, Result
from ..runtime.tracing import BIND_TRACEPARENT_ANNOTATION, TRACER
from ..scheduler.gang import requires_scheduling

#: the instance-type label a cloud node carries (well-known Kubernetes label)
NODE_LABEL_INSTANCE_TYPE = "node.kubernetes.io/instance-type"


class PodletReconciler(Reconciler):
    """Pure kubelet: runs whatever is bound; placement lives in the
    scheduler (``scheduler/core.py``).

    A pod that needs scheduling (a node exists, or it asks for
    ``nvidia.com/gpu`` cards) is left alone until the scheduler's bind
    re-triggers this reconciler through the pod watch. With zero nodes in
    the store and no card asked for, a pod just runs.
    """

    FOR = ("v1", "Pod")

    def reconcile(self, client: Client, req: Request) -> Result:
        pod = client.get_opt("v1", "Pod", req.name, req.namespace)
        # Running is steady state; Succeeded/Failed are terminal (a kubelet
        # never restarts a completed restartPolicy=Never pod)
        if pod is None or pod.get("status", {}).get("phase") in ("Running", "Succeeded", "Failed"):
            return Result()
        if not pod.get("spec", {}).get("nodeName"):
            if requires_scheduling(pod, have_nodes=bool(client.list("v1", "Node"))):
                # unbound and schedulable: the scheduler's bind update
                # re-triggers this reconciler
                return Result()
            # no nodes and no card asked for: run in place
        return self._start(client, pod)

    def _start(self, client: Client, pod: Dict[str, Any]) -> Result:
        # pod.start joins the gang trace through the scheduler's bind
        # annotation: the critical path's post-bind segment
        with TRACER.span(
            "pod.start",
            traceparent=apimeta.annotations_of(pod).get(BIND_TRACEPARENT_ANNOTATION),
            pod=f"{apimeta.namespace_of(pod) or ''}/{apimeta.name_of(pod)}",
            node=str((pod.get("spec") or {}).get("nodeName") or ""),
        ):
            pod["status"] = {
                "phase": "Running",
                "podIP": "10.1.0.1",
                "conditions": [
                    {"type": "PodScheduled", "status": "True"},
                    {"type": "Ready", "status": "True"},
                ],
                "containerStatuses": [
                    {
                        "name": c.get("name", "main"),
                        "ready": True,
                        "restartCount": 0,
                        "state": {"running": {"startedAt": client.store.now()}},
                    }
                    for c in pod.get("spec", {}).get("containers", [])
                ],
            }
            client.update_status(pod)
        return Result()


def make_gpu_node(name: str, product: str, cards: int,
                  instance_type: str = "", pool: str = "") -> Dict[str, Any]:
    """Fixture: a GPU node with ``cards`` cards of ``product``, the value
    of the ``nvidia.com/gpu.product`` label (a catalog key such as
    ``"h100"`` is taken for its ``gfd_product``). ``instance_type`` sets
    ``node.kubernetes.io/instance-type``; ``pool`` names the node pool."""
    if product in ACCELERATORS:
        product = ACCELERATORS[product].gfd_product
    labels = {NODE_LABEL_PRODUCT: product,
              "cloud.google.com/gke-nodepool": pool or f"gpu-{cards}x-pool"}
    if instance_type:
        labels[NODE_LABEL_INSTANCE_TYPE] = instance_type
    node = apimeta.new_object("v1", "Node", name, labels=labels,
                              spec={"providerID": f"gce://gpu-project/us-central1-a/{name}"})
    node["status"] = {
        # host resources in an A3 High machine's proportion: 26 vCPUs and
        # 234 GB a card
        "capacity": {RESOURCE_GPU: str(cards), "cpu": str(26 * cards),
                     "memory": f"{234 * cards}Gi"},
        "allocatable": {RESOURCE_GPU: str(cards)},
        "conditions": [{"type": "Ready", "status": "True"}],
    }
    return node
