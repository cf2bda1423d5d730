"""The Pod path of kubeflow_tpu_torch/serving/fleet.py against
kubeflow_tpu/serving/fleet.py.

JAX's ``EngineFleet`` and the port's are driven the same way, each with a
stub engine factory and its own instance of one scripted in-memory client
(``create_or_get``, ``get_opt``, ``delete_opt``), through create → bind →
serve → delete → re-create → a ``Failed`` Pod → close. They must match on
the Pod bodies (equal but for the resource key: ``nvidia.com/gpu`` where
JAX asks for ``google.com/tpu``), the replicas' states and nodes,
``wait_ready``, the drain reasons and re-queued counts,
``fleet_requeued_total`` and ``fleet_replicas``, the cold-start samples,
``/debug/fleet``'s ``pod`` field and the Pods deleted. A watcher whose poll
raises restarts and counts ``fleet_watcher_restarts_total`` on both. The
port's fleet binds through JAX's real ``SchedulerReconciler`` when its
replicas ask for no cards, and through the port's own ``PodClient`` and
``bind_pending`` with its cards counted; a client that lacks a method is
refused.
"""

import copy
import threading
import time

import numpy as np
import pytest

from kubeflow_tpu.runtime.metrics import METRICS as JMETRICS
from kubeflow_tpu.serving.fleet import EngineFleet as JFleet
from kubeflow_tpu.tpu.topology import RESOURCE_TPU
from kubeflow_tpu_torch.gpu.topology import RESOURCE_GPU
from kubeflow_tpu_torch.runtime.metrics import METRICS
from kubeflow_tpu_torch.serving.fleet import EngineFleet


def wait_for(predicate, timeout=10.0, desc="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {desc}")


class StubRequest:
    def __init__(self, prompt_ids, max_new_tokens, eos_id=None, temperature=0.0):
        self.prompt = np.asarray(prompt_ids, np.int32)
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.temperature = temperature
        self.tokens, self.error, self.span = [], None, None
        self.finish_reason = "ok"
        self.deadline = None
        self.priority = "interactive"
        self.on_done = None
        self.done = threading.Event()


class StubEngine:
    """Serves at once (tokens = the engine's number, repeated); ``drain``
    hands back ``unserved``."""

    def __init__(self, engine_id: str):
        self.engine_id = engine_id
        self.unserved = []
        self.closed = False

    def submit(self, prompt_ids, max_new_tokens, eos_id=None, temperature=0.0,
               traceparent=None, deadline=None, priority="interactive", on_done=None):
        req = StubRequest(prompt_ids, max_new_tokens, eos_id, temperature)
        req.deadline, req.priority = deadline, priority
        req.tokens = [int(self.engine_id.rsplit("-", 1)[1])] * max_new_tokens
        req.done.set()
        if on_done is not None:
            on_done(req)
        return req

    def drain(self):
        out, self.unserved = self.unserved, []
        return out

    def close(self):
        self.closed = True


class ScriptedClient:
    """Pods in memory, by (namespace, name); every read is a copy. The
    test binds, deletes and fails Pods; ``created`` and ``deleted`` record
    what the fleet did. ``malformed`` makes the next ``get_opt`` answer a
    non-object."""

    def __init__(self):
        self._lock = threading.Lock()
        self.pods = {}
        self.created, self.deleted = [], []
        self.malformed = 0

    def create_or_get(self, obj):
        key = (obj["metadata"].get("namespace"), obj["metadata"]["name"])
        with self._lock:
            if key not in self.pods:
                self.pods[key] = copy.deepcopy(obj)
                self.created.append(copy.deepcopy(obj))
            return copy.deepcopy(self.pods[key])

    def get_opt(self, api, kind, name, namespace=None):
        with self._lock:
            if self.malformed:
                self.malformed -= 1
                return 42
            pod = self.pods.get((namespace, name))
            return copy.deepcopy(pod) if pod is not None else None

    def delete_opt(self, api, kind, name, namespace=None):
        with self._lock:
            if self.pods.pop((namespace, name), None) is not None:
                self.deleted.append(name)

    # -- the test's side: the scheduler and the kubelet
    def bind(self, name, node, namespace="ns"):
        with self._lock:
            pod = self.pods[(namespace, name)]
            pod.setdefault("spec", {})["nodeName"] = node
            pod["status"] = {"phase": "Running"}

    def fail(self, name, namespace="ns"):
        with self._lock:
            self.pods[(namespace, name)]["status"] = {"phase": "Failed"}

    def remove(self, name, namespace="ns"):
        with self._lock:
            del self.pods[(namespace, name)]


def _snapshot(fleet):
    return [(r["id"], r["state"], r["pod"], r["node"])
            for r in fleet.debug_snapshot()["replicas"]]


def _drive(make, registry, **kw):
    """One scripted life of a two-replica Pod fleet; the trace to compare."""
    registry.reset()
    client = ScriptedClient()
    fleet = make(replicas=2, max_replicas=3, name="srv", engine_factory=StubEngine,
                 client=client, namespace="ns", replica_chips=1, priority_class="serving",
                 poll_interval=0.01, register_debug=False, **kw)
    trace = {}
    try:
        trace["bodies"] = [copy.deepcopy(b) for b in client.created]
        trace["pending"] = _snapshot(fleet)
        trace["desired_pending"] = fleet.desired_replicas
        trace["wait_ready_unbound"] = fleet.wait_ready(timeout=0.1)
        try:
            fleet.submit(np.arange(1, 9), 4)
            trace["submit_unbound"] = None
        except RuntimeError as e:
            trace["submit_unbound"] = type(e).__name__
        client.bind("srv-0", "node-a")
        trace["wait_ready_one"] = fleet.wait_ready(1, timeout=10)
        client.bind("srv-1", "node-b")
        trace["wait_ready_all"] = fleet.wait_ready(timeout=10)
        trace["bound"] = _snapshot(fleet)
        trace["served"] = [int(t) for t in fleet.submit(np.arange(1, 9), 4).tokens]

        # preemption: srv-0's Pod deleted with a request still queued on it
        parked = StubRequest(np.arange(3, 11), 5)
        fleet.live_handles()[0].engine.unserved = [parked]
        client.remove("srv-0")
        wait_for(lambda: [h.pod_name for h in fleet.live_handles()] == ["srv-1", "srv-2"],
                 desc="the replacement replica")
        trace["parked"] = (parked.done.wait(10), [int(t) for t in parked.tokens], parked.error)
        trace["after_delete"] = _snapshot(fleet)
        client.bind("srv-2", "node-a")
        trace["wait_ready_replacement"] = fleet.wait_ready(timeout=10)

        # a Failed Pod drains its replica the same way
        client.fail("srv-1")
        wait_for(lambda: [h.pod_name for h in fleet.live_handles()] == ["srv-2", "srv-3"],
                 desc="the second replacement")
        client.bind("srv-3", "node-c")
        trace["wait_ready_second"] = fleet.wait_ready(timeout=10)
        trace["final"] = _snapshot(fleet)
        trace["drains"] = [(d["replica"], d["reason"], d["requeued"])
                           for d in fleet.debug_snapshot()["drains"]]
        trace["requeued_total"] = registry.value("fleet_requeued_total")
        trace["replicas_gauge"] = registry.value("fleet_replicas")
        trace["cold_starts"] = registry.histogram_counts("fleet_replica_cold_start_seconds")[2]
        trace["created"] = [b["metadata"]["name"] for b in client.created]
        trace["deleted_before_close"] = list(client.deleted)
    finally:
        fleet.close()
    trace["deleted"] = list(client.deleted)
    trace["pods_left"] = sorted(client.pods)
    return trace


def _as_tpu(body):
    """A port Pod body with JAX's resource key."""
    body = copy.deepcopy(body)
    for c in body["spec"]["containers"]:
        limits = (c.get("resources") or {}).get("limits")
        if limits is not None:
            limits[RESOURCE_TPU] = limits.pop(RESOURCE_GPU)
    return body


def test_pod_path_equals_the_jax_fleets():
    want = _drive(JFleet, JMETRICS)
    got = _drive(EngineFleet, METRICS, device="cpu")
    assert [_as_tpu(b) for b in got.pop("bodies")] == want.pop("bodies")
    assert got == want
    assert got["pending"] == [("srv-0", "pending", "srv-0", None),
                              ("srv-1", "pending", "srv-1", None)]
    assert got["wait_ready_unbound"] is False and got["submit_unbound"] == "FleetSaturated"
    assert got["final"] == [("srv-2", "ready", "srv-2", "node-a"),
                            ("srv-3", "ready", "srv-3", "node-c")]
    assert got["parked"] == (True, [1] * 5, None)
    assert got["drains"] == [("srv-0", "preempted", 1), ("srv-1", "preempted", 0)]
    assert (got["requeued_total"], got["replicas_gauge"], got["cold_starts"]) == (1.0, 2.0, 4)
    # the Failed Pod is deleted by its drain, the bound ones by close
    assert got["deleted_before_close"] == ["srv-1"]
    assert got["deleted"] == ["srv-1", "srv-2", "srv-3"] and got["pods_left"] == []


def test_the_pod_body():
    client = ScriptedClient()
    fleet = EngineFleet(replicas=1, name="gpt", engine_factory=StubEngine, client=client,
                        replica_chips=2, poll_interval=0.01, register_debug=False,
                        device="cpu")
    fleet.close()
    plain = EngineFleet(replicas=1, name="b", engine_factory=StubEngine, client=client,
                        namespace=None, register_debug=False, device="cpu")
    plain.close()
    assert client.created == [
        {"apiVersion": "v1", "kind": "Pod",
         "metadata": {"name": "gpt-0", "namespace": "default",
                      "labels": {"scheduling.kubeflow.org/pod-group": "gpt-0",
                                 "app": "serving-fleet", "fleet": "gpt"},
                      "annotations": {"scheduling.kubeflow.org/pod-group-size": "1"}},
         "spec": {"priorityClassName": "default",
                  "containers": [{"name": "engine", "image": "kubeflow-tpu/model-server",
                                  "resources": {"limits": {"nvidia.com/gpu": "2"}}}]}},
        {"apiVersion": "v1", "kind": "Pod",
         "metadata": {"name": "b-0",
                      "labels": {"scheduling.kubeflow.org/pod-group": "b-0",
                                 "app": "serving-fleet", "fleet": "b"},
                      "annotations": {"scheduling.kubeflow.org/pod-group-size": "1"}},
         "spec": {"priorityClassName": "default",
                  "containers": [{"name": "engine", "image": "kubeflow-tpu/model-server"}]}}]


def _restart_trace(make, registry, **kw):
    registry.reset()
    client = ScriptedClient()
    client.malformed = 1
    fleet = make(replicas=1, name="w", engine_factory=StubEngine, client=client,
                 namespace="ns", poll_interval=0.01, register_debug=False, **kw)
    try:
        restarts = wait_for(lambda: registry.value("fleet_watcher_restarts_total"),
                            desc="a watcher restart")
        client.bind("w-0", "node-a")
        ready = fleet.wait_ready(timeout=10)
        return restarts, ready, _snapshot(fleet)
    finally:
        fleet.close()


def test_a_crashed_watcher_restarts_as_jax():
    want = _restart_trace(JFleet, JMETRICS)
    got = _restart_trace(EngineFleet, METRICS, device="cpu")
    assert got == want == (1.0, True, [("w-0", "ready", "w-0", "node-a")])


def test_a_client_without_the_pod_methods_is_refused():
    class NoDelete:
        def create_or_get(self, obj):
            return obj

        def get_opt(self, *a):
            return None

    with pytest.raises(TypeError, match="delete_opt"):
        EngineFleet(replicas=1, engine_factory=StubEngine, client=NoDelete(),
                    register_debug=False, device="cpu")


def test_binds_through_the_jax_scheduler():
    """JAX's gang scheduler binds a replica Pod that asks for no cards to a
    node, and binds its replacement after the Pod is deleted."""
    from kubeflow_tpu.controllers.builtin import PodletReconciler, make_tpu_node
    from kubeflow_tpu.runtime.manager import Manager
    from kubeflow_tpu.scheduler import SchedulerReconciler

    METRICS.reset()
    mgr = Manager()
    mgr.add(SchedulerReconciler(assembly_timeout=5.0, reservation_ttl=5.0, backoff_base=0.02,
                                backoff_cap=0.5)).add(PodletReconciler())
    mgr.client.create(make_tpu_node("tpu-node-0", "v5e", "2x4", 4))
    mgr.start()
    fleet = None
    try:
        fleet = EngineFleet(replicas=1, max_replicas=2, name="srv", engine_factory=StubEngine,
                            client=mgr.client, replica_chips=0, priority_class="trial",
                            poll_interval=0.05, register_debug=False, device="cpu")
        assert fleet.wait_ready(1, timeout=15), "the scheduler never bound the replica"
        handle = fleet.live_handles()[0]
        assert (handle.pod_name, handle.node) == ("srv-0", "tpu-node-0")
        assert fleet.submit(np.arange(1, 9), 4).tokens == [0] * 4
        mgr.client.delete("v1", "Pod", "srv-0", "default")
        wait_for(lambda: [h.pod_name for h in fleet.live_handles()] == ["srv-1"],
                 timeout=15, desc="the replacement replica")
        assert fleet.wait_ready(1, timeout=15)
        assert fleet.live_handles()[0].node == "tpu-node-0"
        assert fleet.debug_snapshot()["drains"][0]["reason"] == "preempted"
    finally:
        if fleet is not None:
            fleet.close()
        mgr.stop()
    assert mgr.client.get_opt("v1", "Pod", "srv-1", "default") is None


def test_binds_through_the_port_pod_client():
    """``bind_pending`` binds a replica's own Pod with the cards it asks
    for, so a one-card node takes one replica and no second until the
    first Pod is deleted; ``place_gang`` sees the same cards held."""
    from kubeflow_tpu_torch.e2e.elastic_cluster import (NAMESPACE, PodClient, add_nodes,
                                                         bind_pending, place_gang)

    METRICS.reset()
    client = PodClient()
    add_nodes(client, ["gpu-node-0"], 1)
    fleet = EngineFleet(replicas=2, max_replicas=2, name="srv", engine_factory=StubEngine,
                        client=client, replica_chips=1, poll_interval=0.01,
                        register_debug=False, device="cpu")
    try:
        assert bind_pending(client, "srv-0") == ["srv-0"]
        assert fleet.wait_ready(1, timeout=10)
        assert bind_pending(client, "srv-1") is None  # the node's one card is held
        assert place_gang(client, "train", 1, 1) is None
        assert bind_pending(client, "srv-0") == []  # nothing of that gang waits
        assert not fleet.wait_ready(2, timeout=0.1)
        client.delete_opt("v1", "Pod", "srv-0", NAMESPACE)
        wait_for(lambda: [h.pod_name for h in fleet.live_handles()] == ["srv-1", "srv-2"],
                 desc="the replacement replica")
        assert bind_pending(client, "srv-1") == ["srv-1"]
        assert fleet.wait_ready(1, timeout=10)
        assert [(h.pod_name, h.state, h.node) for h in fleet.live_handles()] == [
            ("srv-1", "ready", "gpu-node-0"), ("srv-2", "pending", None)]
    finally:
        fleet.close()
    assert client.list("v1", "Pod", NAMESPACE) == []
