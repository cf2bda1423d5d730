"""kubeflow_tpu_torch/runtime/events.py ``EventRecorder`` and the port's
``PodClient`` Event path, against JAX's recorder on its ``Client``.

The same scripted emits go into JAX's recorder (over its in-process
apiserver) and the port's (over ``PodClient``). The stored Events agree
field for field but for what each store mints (names, uids, resource
versions, timestamps); the return values, the ``events_*`` counters, the
spam bucket's drops and the retention GC agree exactly.
"""

from __future__ import annotations

import pytest

from kubeflow_tpu.apiserver.client import Client as JClient
from kubeflow_tpu.apiserver.store import Store as JStore
from kubeflow_tpu.runtime.events import EventRecorder as JRecorder
from kubeflow_tpu.runtime.metrics import METRICS as J_METRICS
from kubeflow_tpu_torch.e2e.elastic_cluster import PodClient
from kubeflow_tpu_torch.runtime.events import EventRecorder as TRecorder
from kubeflow_tpu_torch.runtime.metrics import METRICS as T_METRICS


@pytest.fixture(autouse=True)
def _reset_port_metrics():
    T_METRICS.reset()
    yield


def _pod(name, ns="default", uid=None):
    meta = {"name": name, "namespace": ns}
    if uid:
        meta["uid"] = uid
    return {"apiVersion": "v1", "kind": "Pod", "metadata": meta}


NODE = {"apiVersion": "v1", "kind": "Node", "metadata": {"name": "node-a"}}


def _view(events):
    """The Events without what each store mints, in a stable order."""
    out = []
    for e in events:
        out.append((e["metadata"]["namespace"], e["metadata"]["name"].rsplit(".", 1)[0] + ".",
                    e["involvedObject"]["kind"], e["involvedObject"]["name"],
                    e["involvedObject"]["namespace"], e["reason"], e["message"], e["type"],
                    e["source"], e["count"]))
    return sorted(out)


def _counters(reg):
    return {k: reg.total(k) for k in ("events_emitted_total", "events_discarded_total",
                                      "events_retention_deleted_total",
                                      "events_retention_saturated_total")} | {
        "created": reg.value("events_emitted_total", component="c", outcome="created"),
        "aggregated": reg.value("events_emitted_total", component="c",
                                outcome="aggregated")}


def _script(recorder_cls, client, **kw):
    rec = recorder_cls(client, **kw)
    returned = []

    def emit(obj, reason, msg, type_="Normal", component="c"):
        ev = rec.emit(obj, reason, msg, type_=type_, component=component)
        returned.append(None if ev is None else (ev["reason"], ev["count"], ev["message"]))

    for i in range(3):  # one Event, count 3, the last message
        emit(_pod("a"), "Backoff", f"attempt {i}", "Warning")
    emit(_pod("a"), "Backoff", "normal now")          # another type: its own Event
    emit(_pod("a"), "Pulled", "image")                # another reason
    emit(_pod("a"), "Backoff", "other source", "Warning", component="d")
    emit(_pod("b", ns="team"), "Started", "ok")       # its namespace
    emit(_pod("u", uid="uid-1"), "Started", "by uid")
    emit(_pod("renamed", uid="uid-1"), "Started", "same uid")  # correlates by uid
    emit(NODE, "NodeQuarantined", "cordoned", "Warning")  # no namespace: default
    return rec, returned


def test_aggregation_and_fields_as_jax():
    jc, tc = JClient(JStore()), PodClient()
    jrec, jret = _script(JRecorder, jc)
    trec, tret = _script(TRecorder, tc)
    assert tret == jret
    jev = jc.list("v1", "Event", "default") + jc.list("v1", "Event", "team")
    tev = tc.list("v1", "Event", "default") + tc.list("v1", "Event", "team")
    assert _view(tev) == _view(jev)
    assert trec.stats() == jrec.stats()
    backoff = next(e for e in tev if e["reason"] == "Backoff" and e["type"] == "Warning"
                   and e["source"] == {"component": "c"})
    assert backoff["count"] == 3 and backoff["message"] == "attempt 2"
    assert backoff["firstTimestamp"] <= backoff["lastTimestamp"]
    assert _counters(T_METRICS) == _counters(J_METRICS)


def test_spam_bucket_drops_as_jax():
    jc, tc = JClient(JStore()), PodClient()
    out = []
    for cls, client in ((JRecorder, jc), (TRecorder, tc)):
        rec = cls(client, burst=3, refill_per_second=1e-9)
        got = [rec.emit(_pod("x"), "R", "m", component="c") for _ in range(5)]
        other = rec.emit(_pod("y"), "R", "m", component="c")  # its own bucket
        out.append(([None if e is None else e["count"] for e in got],
                    other is not None))
    assert out[1] == out[0] == ([1, 2, 3, None, None], True)
    assert T_METRICS.value("events_discarded_total", component="c") == 2.0


def test_retention_gc_deletes_the_oldest_as_jax():
    jc, tc = JClient(JStore()), PodClient()
    out = []
    for cls, client, reg in ((JRecorder, jc, J_METRICS), (TRecorder, tc, T_METRICS)):
        rec = cls(client, max_events=2)
        for name in ("p0", "p1", "p2", "p3"):
            rec.emit(_pod(name), "R", "m")
        left = sorted(e["involvedObject"]["name"] for e in client.list("v1", "Event"))
        again = rec.emit(_pod("p0"), "R", "m")  # its entry was GC'd: a fresh Event
        out.append((left, again["count"], rec.stats(),
                    reg.total("events_retention_deleted_total"),
                    reg.total("events_retention_saturated_total")))
    assert out[1] == out[0]
    assert out[0][0] == ["p2", "p3"] and out[0][1] == 1


def test_an_event_deleted_under_the_recorder_is_created_anew_as_jax():
    jc, tc = JClient(JStore()), PodClient()
    out = []
    for cls, client in ((JRecorder, jc), (TRecorder, tc)):
        rec = cls(client)
        first = rec.emit(_pod("z"), "R", "m")
        client.delete_opt("v1", "Event", first["metadata"]["name"], "default")
        again = rec.emit(_pod("z"), "R", "m2")
        out.append((again["count"], again["message"],
                    [e["count"] for e in client.list("v1", "Event", "default")]))
    assert out[1] == out[0] == (1, "m2", [1])


def test_pod_client_emit_event_goes_through_its_recorder():
    """The straggler detector's ``emit_event`` and the rule engine's
    ``client.events`` write the same aggregated objects, which the Event
    listing returns, as on JAX's Client."""
    tc, jc = PodClient(), JClient(JStore())
    for client in (tc, jc):
        for _ in range(2):
            client.emit_event(NODE, "NodeQuarantined", "m", type_="Warning",
                              component="straggler-detector")
        client.events.emit(_pod("w0"), "WorkerHung", "h", type_="Warning",
                           component="straggler-detector")
    assert isinstance(tc.events, TRecorder)
    assert _view(tc.list("v1", "Event", "default")) == _view(jc.list("v1", "Event", "default"))
    assert [e["count"] for e in tc.list("v1", "Event", "default")
            if e["reason"] == "NodeQuarantined"] == [2]
    assert tc.list("v1", "Event", "elsewhere") == []


def test_pod_client_generate_name():
    client = PodClient()
    a = client.create({"apiVersion": "v1", "kind": "Event",
                       "metadata": {"name": "", "generateName": "x.", "namespace": "n"}})
    b = client.create({"apiVersion": "v1", "kind": "Event",
                       "metadata": {"generateName": "x.", "namespace": "n"}})
    assert a["metadata"]["name"].startswith("x.") and len(a["metadata"]["name"]) == 8
    assert a["metadata"]["name"] != b["metadata"]["name"]
    assert client.get_opt("v1", "Event", a["metadata"]["name"], "n") == a
    with pytest.raises(ValueError):
        client.create(a)
