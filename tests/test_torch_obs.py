"""The port's observability surface (kubeflow_tpu_torch/runtime/obs.py) held
to the mount cases of tests/test_observability.py, on the CPU: /metrics as
OpenMetrics with exemplars and ``# EOF``, /debug/traces filters and limit,
/debug/vars, registered debug sources, /debug/stacks, the ModelServer
mount, and the registry's quantiles equal to the JAX package's."""

import json
import urllib.error
import urllib.request
from urllib.parse import parse_qs, urlparse

import numpy as np
import pytest
import torch

from kubeflow_tpu.runtime import metrics as jax_metrics
from kubeflow_tpu_torch.runtime import obs
from kubeflow_tpu_torch.runtime.metrics import (METRICS, MetricsRegistry,
                                                install_process_collector,
                                                quantile_from_counts)
from kubeflow_tpu_torch.runtime.obs import (EXPOSITION_CONTENT_TYPE, mount_observability,
                                            otlp_traces, register_debug_source)
from kubeflow_tpu_torch.runtime.tracing import TRACER
from kubeflow_tpu_torch.web.http import App, Request
from tests.test_observability import assert_valid_exposition

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean():
    TRACER.reset()
    METRICS.reset()
    yield
    TRACER.reset()


def call(app: App, path: str, method: str = "GET", body=None):
    parsed = urlparse(path)
    return app.dispatch(Request(method=method, path=parsed.path, query=parse_qs(parsed.query),
                                headers={}, body=json.dumps(body).encode() if body else b""))


def _app() -> App:
    return mount_observability(App("dbg"))


def _spans(resp):
    return resp.body["resourceSpans"][0]["scopeSpans"][0]["spans"]


def test_metrics_scrape_is_openmetrics_over_http():
    METRICS.histogram("serving_ttft_seconds", buckets=(0.1, 1.0)).observe(0.05)
    httpd = _app().serve(0)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{httpd.port}/metrics",
                                    timeout=30) as resp:
            assert resp.headers["Content-Type"] == EXPOSITION_CONTENT_TYPE
            text = resp.read().decode()
        with urllib.request.urlopen(f"http://127.0.0.1:{httpd.port}/debug/vars",
                                    timeout=30) as resp:
            assert resp.headers["Content-Type"] == "application/json"
            assert json.loads(resp.read())["app"] == "dbg"
    finally:
        httpd.close()
    assert_valid_exposition(text)
    assert text.endswith("# EOF\n")
    assert "# TYPE serving_ttft_seconds histogram" in text
    assert "process_resident_memory_bytes" in text  # the process collector


def test_exemplar_on_a_bucket_line():
    with TRACER.span("scoped") as s:
        METRICS.histogram("h", buckets=(1.0,)).observe(0.5)
    text = call(_app(), "/metrics").body
    line = next(ln for ln in text.splitlines() if ln.startswith('h_bucket{le="1.0"}'))
    assert line.endswith(f' # {{trace_id="{s.trace_id}"}} 0.5 ' + line.split()[-1])
    assert_valid_exposition(text)


def test_traces_filter_by_name_trace_id_and_service():
    app = _app()
    with TRACER.span("alpha") as a:
        pass
    with TRACER.span("beta"):
        pass
    assert [s["name"] for s in _spans(call(app, "/debug/traces?name=alpha"))] == ["alpha"]
    by_id = _spans(call(app, f"/debug/traces?trace_id={a.trace_id}"))
    assert {s["traceId"] for s in by_id} == {a.trace_id}
    assert len(_spans(call(app, f"/debug/traces?service={TRACER.service}"))) >= 2
    assert _spans(call(app, "/debug/traces?service=nobody")) == []
    doc = otlp_traces(TRACER)
    attrs = doc["resourceSpans"][0]["resource"]["attributes"]
    assert {"key": "service.name", "value": {"stringValue": TRACER.service}} in attrs
    assert {"key": "service.instance.id",
            "value": {"stringValue": TRACER.instance}} in attrs


def test_traces_limit_and_bad_limit():
    app = _app()
    for i in range(5):
        with TRACER.span(f"s{i}"):
            pass
    # most recent last, tail-limited (this GET's own dispatch span is still
    # open, so only the s* spans are in the ring)
    assert [s["name"] for s in _spans(call(app, "/debug/traces?limit=2"))] == ["s3", "s4"]
    assert call(app, "/debug/traces?limit=nope").status == 400


def test_debug_vars_fields():
    v = call(_app(), "/debug/vars").body
    assert v["threads"] >= 1 and v["pid"] > 0 and v["app"] == "dbg"
    for key in ("argv", "python_version", "uptime_seconds", "resident_memory_bytes", "gc",
                "trace_buffer_spans", "metric_families", "debug_sources"):
        assert key in v, key
    assert "stacks" in v["debug_sources"]


def test_debug_sources_before_and_after_mount_and_unknown_404():
    register_debug_source("early", lambda req: {"when": "before"})
    app = _app()
    register_debug_source("late", lambda req: {"when": "after", "q": req.query1("q")})
    try:
        assert call(app, "/debug/early").body == {"when": "before"}
        assert call(app, "/debug/late?q=7").body == {"when": "after", "q": "7"}
        r = call(app, "/debug/nothing-here")
        assert r.status == 404
        assert "'early'" in r.body["error"] and "'late'" in r.body["error"]
        assert "'stacks'" in r.body["error"]
    finally:
        obs._DEBUG_SOURCES.pop("early")
        obs._DEBUG_SOURCES.pop("late")


def test_mount_is_idempotent():
    app = App("x")
    mount_observability(app)
    n = len(list(app.iter_routes()))
    mount_observability(app)
    assert len(list(app.iter_routes())) == n


def test_model_server_mounts_it_and_stacks_name_the_engine_thread():
    from kubeflow_tpu_torch.serving.server import ModelServer, ServedModel, gpt_served_model

    server = ModelServer()
    server.add(ServedModel(name="m", apply_fn=lambda p, x: x * p, params=2.0, device="cpu"))
    gpt = gpt_served_model(name="gpt", tiny=True, max_new_tokens=2, device="cpu")
    server.add(gpt)
    try:
        r = call(server.app, "/v1/models/m:predict", "POST", {"instances": [[1.0, 2.0]]})
        assert r.status == 200 and r.body == {"predictions": [[2.0, 4.0]]}
        r = call(server.app, "/v1/models/gpt:predict", "POST", {"instances": [[1, 2, 3]]})
        assert r.status == 200
        text = call(server.app, "/metrics").body
        assert_valid_exposition(text)
        assert 'serving_predict_total{model="m",result="success"} 1.0' in text
        assert "# TYPE serving_ttft_seconds histogram" in text
        stacks = call(server.app, "/debug/stacks?history=0").body
        names = {t["threadName"] for t in stacks["live"]["threads"]}
        assert "continuous-batcher" in names and stacks["history"] == []
        spans = _spans(call(server.app, "/debug/traces?name=serving.request"))
        assert [e["name"] for e in spans[0]["events"]][-1] == "retired"
    finally:
        server.close()


@pytest.mark.parametrize("seed", range(4))
def test_quantile_from_counts_equals_jax(seed):
    rng = np.random.default_rng(seed)
    buckets = tuple(np.cumsum(rng.uniform(0.001, 0.5, 6)).tolist())
    counts = rng.integers(0, 9, len(buckets) + 1).tolist()
    total = int(sum(counts))
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert quantile_from_counts(buckets, counts, total, q) == \
            jax_metrics.quantile_from_counts(buckets, counts, total, q)
    assert quantile_from_counts(buckets, [0] * len(counts), 0, 0.5) is None


def test_registry_quantile_and_collector_survive_reset():
    reg, jreg = MetricsRegistry(), jax_metrics.MetricsRegistry()
    for r in (reg, jreg):
        h = r.histogram("lat", buckets=(0.1, 0.2, 0.4), model="a")
        for v in (0.05, 0.15, 0.15, 0.3):
            h.observe(v)
        r.histogram("lat", buckets=(0.1, 0.2, 0.4), model="b").observe(99.0)
    for q in (0.0, 0.5, 0.99):
        assert reg.quantile("lat", q) == jreg.quantile("lat", q)
    assert reg.quantile("missing", 0.5) is None
    with pytest.raises(ValueError):
        reg.quantile("lat", 1.5)
    install_process_collector(reg)
    reg.register_collector("broken", lambda: 1 / 0)  # skipped, not fatal
    assert "process_threads" in reg.render()
    reg.reset()
    assert "process_threads" in reg.render(), "collectors must survive reset()"


def test_http_error_bodies_and_json_stay_json():
    app = _app()
    httpd = app.serve(0)
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"http://127.0.0.1:{httpd.port}/debug/nothing", timeout=30)
        assert err.value.code == 404
        assert err.value.headers["Content-Type"] == "application/json"
        assert "registered" in json.loads(err.value.read())["error"]
    finally:
        httpd.close()
