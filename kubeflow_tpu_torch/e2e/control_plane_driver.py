"""Control-plane e2e: an oversized gang against a small GPU topology,
observed end to end over REAL HTTP — the port of
``e2e/control_plane_driver.py``.

Serves the apiserver app (``apiserver.server``, with the ops endpoints of
``runtime.obs.mount_observability``) on a real listener over the store of
the drivers' cluster (``elastic_cluster.cluster``: a ``Manager`` running
the gang scheduler and the podlet in-process), then over HTTP:

1. POSTs two 4-card GPU nodes (``controllers.builtin.make_gpu_node``) and
   a 2-member gang asking 16 cards a pod;
2. polls ``GET /debug/scheduler?gang=...`` until the flight recorder holds
   >= ``MIN_DECISIONS`` unschedulable decisions, and asserts every
   candidate node is named with the machine-readable verdict
   ``insufficient_chips`` (free 4 < need 16);
3. LISTs Events and asserts each gang member carries exactly ONE
   aggregated ``FailedScheduling`` Warning from ``gpu-scheduler`` with
   count > 1: retries bump the counter instead of spamming new objects;
4. scrapes ``/metrics`` for the decision, workqueue and apiserver series
   the cycle must have produced.

It imports no torch. ``python -m
kubeflow_tpu_torch.e2e.control_plane_driver`` prints the report as one
JSON line and exits 0, or prints ``{"ok": false, "error": ...}`` and
exits 1; CPU-only, seconds.
"""

from __future__ import annotations

import json
import sys
import time
import urllib.request
from typing import Any, Dict

GANG = "huge"
GANG_KEY = f"default/{GANG}"
MEMBERS = ("huge-0", "huge-1")
NODES = 2
NODE_CHIPS = 4
POD_CHIPS = 16
MIN_DECISIONS = 3


def _get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=30) as resp:
        return resp.read()


def _post(url: str, body: dict) -> dict:
    req = urllib.request.Request(
        url, json.dumps(body).encode(), {"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def _poll(fn, timeout: float = 30.0, interval: float = 0.1, desc: str = "condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = fn()
        if value:
            return value
        time.sleep(interval)
    raise AssertionError(f"timed out after {timeout}s waiting for {desc}")


def _metric_value(text: str, name: str, **labels) -> float:
    """Sum of series for ``name`` whose label set includes ``labels``."""
    total = 0.0
    for line in text.splitlines():
        if not line.startswith(name):
            continue
        rest = line[len(name):]
        if rest[:1] not in ("{", " "):
            continue  # e.g. name_bucket / name_count suffixes
        if all(f'{k}="{v}"' in rest for k, v in labels.items()):
            total += float(line.rsplit(" ", 1)[1])
    return total


def run() -> Dict[str, Any]:
    from ..apiserver.server import make_apiserver_app
    from ..controllers.builtin import make_gpu_node
    from ..gpu.topology import RESOURCE_GPU
    from ..runtime.obs import mount_observability
    from ..scheduler.core import COMPONENT
    from ..scheduler.gang import POD_GROUP_LABEL, POD_GROUP_SIZE_ANNOTATION
    from .elastic_cluster import cluster

    mgr = cluster().manager
    app = make_apiserver_app(mgr.store)
    mount_observability(app)
    httpd = app.serve(0)
    base = f"http://127.0.0.1:{httpd.port}"
    try:
        # -- populate over HTTP: topology first, then the doomed gang ---------
        names = []
        for i in range(NODES):
            node = make_gpu_node(f"gpu-node-{i}", "h100", NODE_CHIPS)
            _post(f"{base}/api/v1/nodes", node)
            names.append(node["metadata"]["name"])
        for name in MEMBERS:
            _post(f"{base}/api/v1/namespaces/default/pods", {
                "apiVersion": "v1",
                "kind": "Pod",
                "metadata": {
                    "name": name,
                    "namespace": "default",
                    "labels": {POD_GROUP_LABEL: GANG},
                    "annotations": {POD_GROUP_SIZE_ANNOTATION: str(len(MEMBERS))},
                },
                "spec": {"containers": [{
                    "name": "trainer",
                    "resources": {"limits": {RESOURCE_GPU: str(POD_CHIPS)}},
                }]},
            })

        # -- flight recorder over HTTP ----------------------------------------
        def unschedulable_decisions():
            doc = json.loads(_get(f"{base}/debug/scheduler?gang={GANG_KEY}&limit=512"))
            hits = [d for d in doc["decisions"] if d["outcome"] == "unschedulable"]
            return hits if len(hits) >= MIN_DECISIONS else None

        decisions = _poll(unschedulable_decisions, timeout=30.0,
                          desc=f">= {MIN_DECISIONS} unschedulable decisions for {GANG_KEY}")
        last = decisions[-1]
        verdicts = {n["node"]: n for n in last.get("nodes", [])}
        assert set(verdicts) == set(names), \
            f"flight recorder must name every candidate node: {sorted(verdicts)}"
        for node_name, verdict in verdicts.items():
            assert verdict["reason"] == "insufficient_chips", (node_name, verdict)
            assert verdict["capacity"] == NODE_CHIPS and verdict["needed"] == POD_CHIPS, verdict
        assert last["attempt"] >= 1 and last["backoffSeconds"] > 0, last
        assert "insufficient chips" in last["message"], last["message"]

        # -- aggregated Events over HTTP --------------------------------------
        events = json.loads(_get(f"{base}/api/v1/namespaces/default/events"))["items"]
        counts = {}
        for member in MEMBERS:
            failed = [e for e in events
                      if (e.get("involvedObject") or {}).get("name") == member
                      and e.get("reason") == "FailedScheduling"]
            assert len(failed) == 1, \
                f"{member}: want ONE aggregated FailedScheduling, got {len(failed)}"
            ev = failed[0]
            assert ev["type"] == "Warning", ev
            assert ev["source"]["component"] == COMPONENT, ev["source"]
            assert ev["count"] > 1, f"{member}: retries must aggregate (count={ev['count']})"
            counts[member] = ev["count"]

        # -- metrics scrape ----------------------------------------------------
        text = _get(f"{base}/metrics").decode()
        decision_total = _metric_value(text, "scheduler_decision_total",
                                       outcome="unschedulable", reason="insufficient_chips")
        assert decision_total >= MIN_DECISIONS, \
            f"scheduler_decision_total(unschedulable)={decision_total}"
        assert _metric_value(text, "workqueue_adds_total", queue="SchedulerReconciler") > 0
        assert "workqueue_depth{" in text and "workqueue_unfinished_work_seconds{" in text
        assert _metric_value(text, "apiserver_request_seconds_count", verb="create",
                             resource="pods") >= len(MEMBERS)
        assert _metric_value(text, "apiserver_inflight_requests", verb="create") == 0

        return {
            "ok": True,
            "unschedulable_decisions": len(decisions),
            "verdicts": {n: v["reason"] for n, v in verdicts.items()},
            "event_counts": counts,
            "decision_total": decision_total,
        }
    finally:
        httpd.close()
        mgr.stop()


def main() -> int:
    try:
        report = run()
    except AssertionError as e:
        print(json.dumps({"ok": False, "error": str(e)}))
        return 1
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
