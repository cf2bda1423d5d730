"""The drivers' stand-in for a cluster: Pods, Nodes and Events in memory.

The elastic, goodput and straggler drivers of the JAX package run against
its in-process apiserver, scheduler and chaos harness; the port has no
control plane (as its other drivers), so these three script the same
protocol on a :class:`PodClient`, a small in-memory client with the
methods the port's ``PreemptionHandler`` and ``StragglerDetector`` call
(``get_opt``, ``patch``, ``list``, ``emit_event``), the ones the drivers
use (``create``, ``delete_opt``), the serving fleet's Pod path
(``create_or_get``, ``get_opt``, ``delete_opt``) and the monitoring
plane's (``list("v1", "Pod")`` for scrape discovery, ``events`` for the
rule engine). Events go through one ``runtime.events.EventRecorder`` a
client, as on JAX's ``Client``, so duplicates aggregate into one Event
object with a ``count``:

- :func:`place_gang` binds a gang's pods to nodes with room that are not
  quarantined (chips as a per-node capacity), Running at once;
- :func:`bind_pending` binds, the same way, the pods of a gang that a
  workload created and left unbound (a serving fleet replica's);
- :func:`preempt_gang` is the scheduler's drain signal: a drain-deadline
  annotation on every live pod of the gang;
- :func:`evict` deletes a gang's pods, and says which had acked
  (``DRAIN_ACK``) first: the scheduler's second phase.

:func:`run_in_world` runs a driver's ranks (``parallel.launch.run_world``)
and :func:`driver_main` is their command line.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import shutil
import tempfile
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..gpu.topology import RESOURCE_GPU
from ..runtime.events import EventRecorder
from ..scheduler.gang import (DRAIN_ACK_ANNOTATION, DRAIN_DEADLINE_ANNOTATION,
                              DRAIN_GRACE_ANNOTATION, POD_GROUP_LABEL, POD_GROUP_SIZE_ANNOTATION,
                              annotations_of, is_quarantined, labels_of, name_of)

NAMESPACE = "default"
Key = Tuple[str, Optional[str], str]


def _merge(dst: Dict[str, Any], patch: Dict[str, Any]) -> None:
    for k, v in patch.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v)


class PodClient:
    """Pods, Nodes and Events by (kind, namespace, name); thread-safe, and
    every read returns a copy, as an apiserver's would."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._objects: Dict[Key, Dict[str, Any]] = {}
        #: the client's EventRecorder (``emit_event`` goes through it)
        self.events = EventRecorder(self)

    def create(self, obj: Dict[str, Any]) -> Dict[str, Any]:
        """Store ``obj``; an empty name with ``metadata.generateName`` gets
        that prefix and six hex digits, as an apiserver mints it."""
        obj = copy.deepcopy(obj)
        meta = obj.setdefault("metadata", {})
        with self._lock:
            if not meta.get("name") and meta.get("generateName"):
                while True:
                    meta["name"] = meta["generateName"] + uuid.uuid4().hex[:6]
                    if (obj["kind"], meta.get("namespace"), meta["name"]) not in self._objects:
                        break
            key = (obj["kind"], meta.get("namespace"), meta["name"])
            if key in self._objects:
                raise ValueError(f"{key} already exists")
            self._objects[key] = copy.deepcopy(obj)
        return obj

    def create_or_get(self, obj: Dict[str, Any]) -> Dict[str, Any]:
        """Create ``obj``, or return the object of its name that exists."""
        try:
            return self.create(obj)
        except ValueError:
            meta = obj["metadata"]
            return self.get_opt(obj.get("apiVersion", "v1"), obj["kind"], meta["name"],
                                meta.get("namespace"))

    def get_opt(self, api: str, kind: str, name: str,
                namespace: Optional[str] = None) -> Optional[Dict[str, Any]]:
        with self._lock:
            obj = self._objects.get((kind, namespace, name))
            return copy.deepcopy(obj) if obj is not None else None

    def patch(self, api: str, kind: str, name: str, body: Dict[str, Any],
              namespace: Optional[str] = None) -> Dict[str, Any]:
        with self._lock:
            obj = self._objects.get((kind, namespace, name))
            if obj is None:
                raise KeyError(f"{kind} {namespace}/{name} not found")
            _merge(obj, body)
            return copy.deepcopy(obj)

    def delete_opt(self, api: str, kind: str, name: str,
                   namespace: Optional[str] = None) -> None:
        with self._lock:
            self._objects.pop((kind, namespace, name), None)

    def list(self, api: str, kind: str, namespace: Optional[str] = None,
             label_selector: Optional[Dict[str, str]] = None) -> List[Dict[str, Any]]:
        with self._lock:
            objs = [copy.deepcopy(o) for (k, ns, _n), o in sorted(self._objects.items())
                    if k == kind and (namespace is None or ns == namespace)]
        sel = label_selector or {}
        return [o for o in objs if all(labels_of(o).get(k) == v for k, v in sel.items())]

    def emit_event(self, obj: Dict[str, Any], reason: str, message: str, *,
                   type_: str = "Normal",
                   component: str = "kubeflow-tpu") -> Optional[Dict[str, Any]]:
        """A v1 Event against ``obj`` through the recorder: a duplicate
        (same object, reason, component, type) bumps the stored Event's
        ``count``. Returns the Event, or None when the spam filter dropped
        it."""
        return self.events.emit(obj, reason, message, type_=type_, component=component)


def add_nodes(client: PodClient, names: Sequence[str], chips: int) -> None:
    for n in names:
        client.create({"apiVersion": "v1", "kind": "Node",
                       "metadata": {"name": n, "namespace": None, "annotations": {}},
                       "status": {"capacity": {"chips": chips}}})


def pod_chips(pod: Dict[str, Any]) -> int:
    """The cards a pod holds: its ``spec.chips`` (the drivers' own pods), or
    the ``nvidia.com/gpu`` limits of its containers."""
    spec = pod.get("spec") or {}
    if "chips" in spec:
        return int(spec["chips"])
    return sum(int(((c.get("resources") or {}).get("limits") or {}).get(RESOURCE_GPU, 0))
               for c in spec.get("containers") or ())


def _free_chips(client: PodClient) -> Dict[str, int]:
    free = {name_of(n): int(n["status"]["capacity"]["chips"])
            for n in client.list("v1", "Node") if not is_quarantined(n)}
    for pod in client.list("v1", "Pod"):
        node = (pod.get("spec") or {}).get("nodeName")
        if node in free:
            free[node] -= pod_chips(pod)
    return free


def _first_fit(client: PodClient, chips: List[int]) -> Optional[List[str]]:
    free = _free_chips(client)
    nodes = []
    for want in chips:
        fit = next((n for n in sorted(free) if free[n] >= want), None)
        if fit is None:
            return None
        free[fit] -= want
        nodes.append(fit)
    return nodes


def place_gang(client: PodClient, gang: str, pods: int, chips: int,
               grace: Optional[float] = None) -> Optional[List[str]]:
    """Bind ``pods`` pods of ``chips`` each, all or none, first fit over the
    nodes that are not quarantined; the pod names, or None if it does not
    fit now."""
    nodes = _first_fit(client, [chips] * pods)
    if nodes is None:
        return None
    names = [f"{gang}-{i}" for i in range(pods)]
    annotations = {POD_GROUP_SIZE_ANNOTATION: str(pods)}
    if grace is not None:
        annotations[DRAIN_GRACE_ANNOTATION] = str(grace)
    for name, node in zip(names, nodes):
        client.create({"apiVersion": "v1", "kind": "Pod",
                       "metadata": {"name": name, "namespace": NAMESPACE,
                                    "labels": {POD_GROUP_LABEL: gang},
                                    "annotations": dict(annotations)},
                       "spec": {"nodeName": node, "chips": chips},
                       "status": {"phase": "Running"}})
    return names


def bind_pending(client: PodClient, gang: str) -> Optional[List[str]]:
    """Bind the gang's existing unbound pods with their own cards, all or
    none, first fit as :func:`place_gang`; their names (empty if none
    waits), or None if they do not fit now."""
    waiting = [p for p in client.list("v1", "Pod", NAMESPACE,
                                      label_selector={POD_GROUP_LABEL: gang})
               if not (p.get("spec") or {}).get("nodeName")]
    nodes = _first_fit(client, [pod_chips(p) for p in waiting])
    if nodes is None:
        return None
    for pod, node in zip(waiting, nodes):
        client.patch("v1", "Pod", name_of(pod),
                     {"spec": {"nodeName": node}, "status": {"phase": "Running"}}, NAMESPACE)
    return [name_of(p) for p in waiting]


def preempt_gang(client: PodClient, pods: Sequence[str], grace: float) -> None:
    """The drain signal: a deadline ``grace`` seconds out on every live pod."""
    deadline = str(time.time() + grace)
    for name in pods:
        if client.get_opt("v1", "Pod", name, NAMESPACE) is not None:
            client.patch("v1", "Pod", name,
                         {"metadata": {"annotations": {DRAIN_DEADLINE_ANNOTATION: deadline}}},
                         NAMESPACE)


def evict(client: PodClient, pods: Sequence[str]) -> List[str]:
    """Delete the pods; returns the acks (``DRAIN_ACK``, the step saved)
    they carried."""
    acks = []
    for name in pods:
        pod = client.get_opt("v1", "Pod", name, NAMESPACE)
        if pod is None:
            continue
        ack = annotations_of(pod).get(DRAIN_ACK_ANNOTATION)
        if ack is not None:
            acks.append(ack)
        client.delete_opt("v1", "Pod", name, NAMESPACE)
    return acks


def poll(fn: Callable[[], Any], timeout: float = 30.0, interval: float = 0.05,
         desc: str = "condition") -> Any:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = fn()
        if value:
            return value
        time.sleep(interval)
    raise AssertionError(f"timed out after {timeout}s waiting for {desc}")


def run_in_world(module: str, device: str, ranks: int, timeout: float,
                 extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Run ``module``'s ``_rank_main`` in a fresh world of ``ranks``; rank
    0's summary."""
    from ..parallel.launch import run_world

    workdir = tempfile.mkdtemp(prefix=module.rsplit(".", 1)[-1] + "-")
    try:
        with open(os.path.join(workdir, "args.json"), "w") as f:
            json.dump(dict(extra or {}, device=device), f)
        return run_world(f"{module}:_rank_main", ranks, workdir, timeout=timeout,
                         device=device, pg_timeout=timeout)[0]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def driver_main(argv, doc: str, run_fn: Callable[..., Dict[str, Any]], ranks: int) -> int:
    """A driver's command line: ``--device cuda|cpu`` (one rank a card on
    nccl, the default, or gloo ranks on the CPU), ``--ranks`` (the cards
    on CUDA, ``ranks`` on the CPU, unless given), ``--timeout``; prints
    the summary as one JSON line (0), or ``{"ok": false, "error": ...}``
    (1)."""
    parser = argparse.ArgumentParser(description=doc.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--ranks", type=int, default=None)
    parser.add_argument("--timeout", type=float, default=300.0)
    args = parser.parse_args(argv)
    if args.ranks is None:
        import torch

        args.ranks = torch.cuda.device_count() if args.device == "cuda" else ranks
    try:
        summary = run_fn(args.device, args.ranks, args.timeout)
    except (AssertionError, RuntimeError, ValueError) as e:
        print(json.dumps({"ok": False, "error": str(e)[-4000:]}))
        return 1
    print(json.dumps(summary))
    return 0
