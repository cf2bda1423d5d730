"""kubeflow_tpu_torch/monitoring/traces.py (``TraceCollector``,
``critical_path``, ``traces_url``) against the JAX package's.

The same OTLP documents go into JAX's collector and the port's: the
assembled traces, the trace ids, the slowest-binds index, the critical
paths and what tail sampling keeps and drops are equal (``==``: the same
Python on both sides). Both also pull one port process's ``/debug/traces``
over HTTP, found through an annotated Pod, and assemble the same trace.
"""

from __future__ import annotations

import pytest

from kubeflow_tpu.apiserver.client import Client as JClient
from kubeflow_tpu.apiserver.store import Store as JStore
from kubeflow_tpu.monitoring import traces as jtraces
from kubeflow_tpu.runtime.metrics import METRICS as J_METRICS
from kubeflow_tpu_torch.e2e.elastic_cluster import PodClient
from kubeflow_tpu_torch.monitoring import scrape as tscrape
from kubeflow_tpu_torch.monitoring import traces as ttraces
from kubeflow_tpu_torch.runtime.metrics import METRICS as T_METRICS
from kubeflow_tpu_torch.runtime.obs import mount_observability
from kubeflow_tpu_torch.runtime.tracing import Tracer
from kubeflow_tpu_torch.web.http import App, Request


@pytest.fixture(autouse=True)
def _reset_port_metrics():
    T_METRICS.reset()
    yield


def _doc(service, instance, spans):
    return {"resourceSpans": [{
        "resource": {"attributes": [
            {"key": "service.name", "value": {"stringValue": service}},
            {"key": "service.instance.id", "value": {"stringValue": instance}},
        ]},
        "scopeSpans": [{"scope": {"name": "test"}, "spans": spans}],
    }]}


def _span(trace_id, span_id, name="op", status="OK", attrs=None, start_ns=1_000,
          end_ns=2_000, service=None):
    attributes = dict(attrs or {})
    if service is not None:
        attributes["service.name"] = service
    return {"traceId": trace_id, "spanId": span_id, "name": name,
            "startTimeUnixNano": start_ns, "endTimeUnixNano": end_ns,
            "status": {"code": status, "message": ""}, "attributes": attributes}


def _gang_docs(tid="1" * 32, latency=2.5, submitted=10.0):
    """A gang bind across three processes: the client's submit, the
    scheduler's lifecycle root and bind loop, a podlet's pod start."""
    s = int(1e9)
    return [
        _doc("loadgen", "h0:1", [_span(tid, "a" * 16, "gang.submit", start_ns=10 * s,
                                       end_ns=10 * s + 5_000_000)]),
        _doc("scheduler", "h1:2", [
            _span(tid, "b" * 16, "gang.lifecycle", start_ns=int(10.5 * s), end_ns=13 * s,
                  attrs={"gang": "default/g", "gang.bind_latency_s": latency,
                         "gang.bound": True, "gang.submitted_unix": submitted}),
            _span(tid, "c" * 16, "schedule.bind", start_ns=12 * s, end_ns=int(12.4 * s)),
        ]),
        _doc("podlet", "h2:3", [_span(tid, "d" * 16, "pod.start", start_ns=13 * s,
                                      end_ns=int(13.3 * s)),
                                _span(tid, "e" * 16, "pod.start", start_ns=13 * s,
                                      end_ns=int(13.2 * s), service="engine-0")]),
    ]


def _views(c, mod, tids):
    return ([c.trace(t) for t in tids], sorted(c.trace_ids()), c.slowest_binds(10),
            [mod.critical_path(c.trace(t)) if c.trace(t) else None for t in tids])


def test_assembly_dedup_and_critical_path_as_jax():
    out = []
    for mod in (jtraces, ttraces):
        c = mod.TraceCollector()
        added = [c.ingest(d) for d in _gang_docs()]
        added.append(c.ingest(_gang_docs()[1]))  # a repeated pull: idempotent
        added += [c.ingest(d) for d in _gang_docs("2" * 32, latency=4.0, submitted=9.0)]
        c.attach_verdict("1" * 32, {"worker": "w0", "kind": "hang"})
        out.append((added, _views(c, mod, ["1" * 32, "2" * 32, "9" * 32])))
    assert out[1] == out[0]
    added, (traces, _ids, slowest, paths) = out[1]
    assert added == [1, 2, 2, 0, 1, 2, 2]
    assert traces[0]["services"] == ["engine-0", "loadgen", "podlet", "scheduler"]
    assert traces[0]["verdicts"] == [{"worker": "w0", "kind": "hang"}]
    assert [r["bindLatencySeconds"] for r in slowest] == [4.0, 2.5]
    assert [s["name"] for s in paths[0]["segments"]] == ["queue", "cycle", "bind"]
    assert paths[0]["totalSeconds"] == pytest.approx(2.4)
    assert paths[0]["postBindPodStart"] == {"pods": 2, "seconds": 0.3}


CRITICAL_PATH_EDGES = {
    "no_root": {"spans": [_span("1" * 32, "a" * 16)]},
    "no_anchor": {"spans": [_span("1" * 32, "a" * 16, name="gang.lifecycle")]},
    "unbound": {"spans": [_span("1" * 32, "a" * 16, name="gang.lifecycle",
                                attrs={"gang.submitted_unix": 0.0},
                                start_ns=int(2e9), end_ns=int(3e9))]},
    "empty": {},
}


@pytest.mark.parametrize("name", sorted(CRITICAL_PATH_EDGES))
def test_critical_path_edges_as_jax(name):
    doc = CRITICAL_PATH_EDGES[name]
    assert ttraces.critical_path(doc) == jtraces.critical_path(doc)


def test_tail_sampling_as_jax():
    """A 2x burst over the span budget: every error trace and the slowest
    decile of binds survive, the rest go oldest first, counted alike."""
    budget = 100
    spans = []
    for i in range(2 * budget):
        tid = f"{i:032x}"
        if i % 20 == 0:
            spans.append(_span(tid, f"{i:016x}", status="ERROR"))
        elif i % 20 == 1:
            spans.append(_span(tid, f"{i:016x}", name="gang.lifecycle",
                               attrs={"gang.bind_latency_s": float(i), "gang": "g"}))
        else:
            spans.append(_span(tid, f"{i:016x}"))
    out = []
    for mod, reg in ((jtraces, J_METRICS), (ttraces, T_METRICS)):
        c = mod.TraceCollector(max_spans=budget)
        c.ingest(_doc("s", "h:1", spans))
        dropped = c._enforce_bound()
        out.append((dropped, sorted(c.trace_ids()),
                    reg.value("tracing_collector_traces_dropped_total", protected="false"),
                    reg.value("tracing_collector_spans")))
    assert out[1] == out[0]
    kept = set(out[1][1])
    assert len(kept) <= budget
    assert all(f"{i:032x}" in kept for i in range(0, 2 * budget, 20))
    assert f"{181:032x}" in kept  # the slowest bind


def test_bound_beats_protection_as_jax():
    spans = [_span(f"{i:032x}", f"{i:016x}", status="ERROR") for i in range(8)]
    out = []
    for mod in (jtraces, ttraces):
        c = mod.TraceCollector(max_spans=3)
        c.ingest(_doc("s", "h:1", spans))
        out.append((c._enforce_bound(), sorted(c.trace_ids())))
    assert out[1] == out[0] and len(out[0][1]) <= 3
    assert ttraces.MAX_FEDERATED_SPANS == jtraces.MAX_FEDERATED_SPANS


@pytest.mark.parametrize("url", ["http://10.0.0.1:8080/metrics", "http://h/x?y=1",
                                 "https://a.b:9/m#f"])
def test_traces_url_as_jax(url):
    assert ttraces.traces_url(url) == jtraces.traces_url(url)


def test_collects_a_port_process_over_http_as_jax():
    """Both collectors discover one port process through an annotated Pod
    (its scrape URL rewritten to ``/debug/traces``) and pull its OTLP ring:
    the same assembled trace."""
    tracer = Tracer(service="engine")
    with tracer.span("serving.request", replica="r-0") as root:
        with tracer.span("prefill"):
            pass
    app = mount_observability(App("engine"), tracer=tracer)
    srv = app.serve(0)
    url = f"http://127.0.0.1:{srv.port}/metrics"
    pod = {"apiVersion": "v1", "kind": "Pod", "metadata": {
        "name": "engine-0", "namespace": "default", "annotations": {
            tscrape.SCRAPE_ANNOTATION: "true", tscrape.SCRAPE_URL_ANNOTATION: url}}}
    try:
        out = []
        for mod, client in ((jtraces, JClient(JStore())), (ttraces, PodClient())):
            client.create(pod)
            c = mod.TraceCollector(client=client)
            (target,) = c.discover()
            result = c.collect_once()
            out.append(((target.job, target.url), list(result.values()),
                        c.trace(root.trace_id)))
    finally:
        srv.close()
    assert out[1] == out[0]
    (job, turl), ok, assembled = out[1]
    assert job == "engine-0" and turl.endswith("/debug/traces?limit=4096") and ok == [True]
    assert assembled["spanCount"] == 2 and assembled["services"] == ["engine"]
    assert T_METRICS.value("tracing_collector_fetches_total", result="ok") == 1.0


def test_mounted_routes():
    c = ttraces.TraceCollector()
    for d in _gang_docs():
        c.ingest(d)
    app = mount_observability(App("monitor"))
    c.mount(app)
    c.mount(app)  # idempotent

    def call(path, **query):
        return app.dispatch(Request(method="GET", path=path,
                                    query={k: [v] for k, v in query.items()},
                                    headers={}, body=b""))

    ok = call(f"/debug/trace/{'1' * 32}")
    assert ok.status == 200 and ok.body["spanCount"] == 5
    assert [s["name"] for s in ok.body["criticalPath"]["segments"]] == ["queue", "cycle", "bind"]
    assert call(f"/debug/trace/{'0' * 32}").status == 404
    binds = call("/debug/slowest-binds", n="5")
    assert binds.status == 200 and binds.body["binds"][0]["bindLatencySeconds"] == 2.5
