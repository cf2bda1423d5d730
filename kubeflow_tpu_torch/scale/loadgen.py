"""Seeded load generator: drives the real apiserver and scheduler over HTTP.

The port of ``kubeflow_tpu/scale/loadgen.py``. Every step (gang arrivals,
pod churn, node kills, watch storms) draws from one
``random.Random(seed)`` stream, so a run replays from ``(topology, seed)``.
All traffic goes through the apiserver's HTTP listener; gang members ask
for ``nvidia.com/gpu`` cards. The generator never writes ``spec.nodeName``:
binding is the scheduler's job, and the generator only reads it back.
"""

from __future__ import annotations

import json
import random
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Dict, Iterable, List, Optional

from ..runtime.tracing import TRACER, format_traceparent
from ..scheduler.gang import POD_GROUP_LABEL, POD_GROUP_SIZE_ANNOTATION
from ..gpu.topology import RESOURCE_GPU
from .topology import GangShape, SyntheticTopology


def _percentile(samples: List[float], q: float) -> float:
    if not samples:
        return 0.0
    ordered = sorted(samples)
    idx = min(len(ordered) - 1, int(round(q * (len(ordered) - 1))))
    return ordered[idx]


class LoadGenerator:
    def __init__(self, base_url: str, topology: SyntheticTopology,
                 seed: int = 0, namespace: str = "default",
                 timeout_s: float = 30.0, flow: Optional[str] = None,
                 traceparent: Optional[str] = None) -> None:
        self.base = base_url.rstrip("/")
        self.topology = topology
        self.namespace = namespace
        self.timeout_s = timeout_s
        self.rng = random.Random(f"loadgen:{seed}")
        self.submitted_gangs: Dict[str, GangShape] = {}
        #: flow identity stamped on every request (X-Flow-Client), for an
        #: apiserver with a fairness gate (the port's has none yet)
        self.flow = flow
        #: W3C trace context for this generator's traffic: gang submits open
        #: a client-side ``gang.submit`` span continuing it, so the trace
        #: federation e2e can inject a known trace id at the user edge and
        #: find it again in the bound pod's annotation
        self.traceparent = traceparent

    # -- raw HTTP -------------------------------------------------------------

    def _request(self, method: str, path: str, body: Optional[dict] = None) -> Any:
        data = json.dumps(body).encode() if body is not None else None
        headers = {"content-type": "application/json"} if data else {}
        if self.flow:
            headers["x-flow-client"] = self.flow
        cur = TRACER.current_span()
        if cur is not None:
            headers["traceparent"] = format_traceparent(cur)
        elif self.traceparent:
            headers["traceparent"] = self.traceparent
        req = urllib.request.Request(
            self.base + path, data=data, headers=headers, method=method)
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            payload = resp.read()
        return json.loads(payload) if payload else None

    def _get(self, path: str) -> Any:
        return self._request("GET", path)

    def _post(self, path: str, body: dict) -> Any:
        return self._request("POST", path, body)

    def _delete(self, path: str) -> None:
        try:
            self._request("DELETE", path)
        except urllib.error.HTTPError as err:
            if err.code != 404:  # racing a GC is fine, anything else is not
                raise

    # -- topology -------------------------------------------------------------

    def register_nodes(self, limit: Optional[int] = None) -> int:
        """POST every synthetic node; returns how many were created."""
        count = 0
        for node in self.topology.nodes():
            if limit is not None and count >= limit:
                break
            self._post("/api/v1/nodes", node)
            count += 1
        return count

    def kill_nodes(self, count: int) -> List[str]:
        """Seeded node kills — the churn a preemptible fleet sees."""
        names = self.topology.node_names()
        doomed = self.rng.sample(names, min(count, len(names)))
        for name in doomed:
            self._delete(f"/api/v1/nodes/{name}")
        return doomed

    # -- gangs ----------------------------------------------------------------

    def pod_name(self, gang: str, i: int) -> str:
        return f"{gang}-{i}"

    def submit_gang(self, shape: GangShape) -> List[str]:
        # The user edge of the gang journey: every member POST runs under
        # one client-side span (continuing self.traceparent when set), so
        # the federated trace starts in THIS process, not at the apiserver.
        with TRACER.span("gang.submit", traceparent=self.traceparent,
                         gang=shape.name, size=shape.size):
            return self._submit_gang(shape)

    def _submit_gang(self, shape: GangShape) -> List[str]:
        names = []
        for i in range(shape.size):
            name = self.pod_name(shape.name, i)
            pod = {
                "apiVersion": "v1",
                "kind": "Pod",
                "metadata": {
                    "name": name,
                    "namespace": self.namespace,
                    "labels": {POD_GROUP_LABEL: shape.name},
                    "annotations": {POD_GROUP_SIZE_ANNOTATION: str(shape.size)},
                },
                "spec": {
                    "nodeSelector": dict(shape.selector),
                    "containers": [{
                        "name": "trainer",
                        "resources": {
                            "limits": {RESOURCE_GPU: str(shape.chips_per_pod)}},
                    }],
                },
            }
            self._post(f"/api/v1/namespaces/{self.namespace}/pods", pod)
            names.append(name)
        self.submitted_gangs[shape.name] = shape
        return names

    def gang_wave(self, shapes: Iterable[GangShape]) -> List[str]:
        pods: List[str] = []
        for shape in shapes:
            pods.extend(self.submit_gang(shape))
        return pods

    def _list_pods(self) -> List[Dict[str, Any]]:
        return self._get(f"/api/v1/namespaces/{self.namespace}/pods")["items"]

    def bound_gangs(self) -> Dict[str, int]:
        """gang name -> members bound so far (observed via reads)."""
        bound: Dict[str, int] = {}
        for pod in self._list_pods():
            gang = (pod["metadata"].get("labels") or {}).get(POD_GROUP_LABEL)
            if gang and (pod.get("spec") or {}).get("nodeName"):
                bound[gang] = bound.get(gang, 0) + 1
        return bound

    def wait_gangs_bound(self, gangs: Iterable[str], timeout_s: float = 60.0,
                         interval_s: float = 0.1) -> None:
        want = {g: self.submitted_gangs[g].size for g in gangs}
        missing = dict(want)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            bound = self.bound_gangs()
            missing = {g: n for g, n in want.items() if bound.get(g, 0) < n}
            if not missing:
                return
            time.sleep(interval_s)
        raise AssertionError(f"gangs not fully bound after {timeout_s}s: {missing}")

    def churn_pods(self, fraction: float) -> int:
        """Delete a seeded fraction of bound pods (notebook-style churn)."""
        bound = [p["metadata"]["name"] for p in self._list_pods()
                 if (p.get("spec") or {}).get("nodeName")]
        doomed = self.rng.sample(bound, int(len(bound) * fraction))
        for name in doomed:
            self._delete(f"/api/v1/namespaces/{self.namespace}/pods/{name}")
        return len(doomed)

    # -- watch storm ----------------------------------------------------------

    def watch_storm(self, streams: int = 8, relists: int = 32,
                    duration_s: float = 2.0) -> Dict[str, Any]:
        """Mass relist: ``streams`` concurrent watch streams draining events
        while ``relists`` full LISTs fire back-to-back (a fanout burst). Returns client-side latency stats; the server-side view
        is ``apiserver_request_seconds{verb="list"}``."""
        stop = threading.Event()
        events_seen = [0] * streams

        def drain(idx: int) -> None:
            url = (f"{self.base}/api/v1/namespaces/{self.namespace}/pods"
                   "?watch=true&sendInitial=true")
            req = urllib.request.Request(
                url, headers={"x-flow-client": self.flow} if self.flow else {})
            try:
                with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                    while not stop.is_set():
                        line = resp.readline()
                        if not line:
                            break
                        events_seen[idx] += 1
            except (OSError, urllib.error.URLError):
                pass  # the server tearing down mid-storm is part of the storm

        threads = [threading.Thread(target=drain, args=(i,), daemon=True)
                   for i in range(streams)]
        for t in threads:
            t.start()
        latencies_ms: List[float] = []
        deadline = time.monotonic() + duration_s
        fired = 0
        while fired < relists or time.monotonic() < deadline:
            t0 = time.perf_counter()
            self._list_pods()
            latencies_ms.append((time.perf_counter() - t0) * 1000.0)
            fired += 1
        stop.set()
        for t in threads:
            t.join(timeout=5.0)
        return {
            "streams": streams,
            "lists": fired,
            "watch_events": sum(events_seen),
            "list_p50_ms": _percentile(latencies_ms, 0.50),
            "list_p99_ms": _percentile(latencies_ms, 0.99),
        }
