"""kubeflow_tpu_torch/monitoring/{scrape,tsdb,rules,plane}.py, the
autoscaler's ``FederatedWindowSource`` and the fleet's ``metrics_url``,
against the JAX package's.

The same scripted inputs go through both packages and the results are
compared with ``==`` (the arithmetic is the same Python on both sides, so
the tolerance is none): the parse result, re-rendered text and
``ParseError`` line of each exposition text (JAX's malformed cases
included); ``latest``, ``increase``, staleness and ``histogram_quantile``
of the same ingests; the status dicts of ``SLOBurnRateAlert`` over the same
series and clock; the Events ``RuleEngine`` emits (``count``, ``type``,
``reason``); the windows, stale holds and scale calls of
``FederatedWindowSource`` (JAX's no-flap regression and counter reset);
``federate_text`` of equal stores; and a byte-level cross check — each
side's parser accepts the other's ``/metrics`` and ``/federate``.
"""

from __future__ import annotations

import re
import threading
import time
import urllib.request

import pytest

from kubeflow_tpu.apiserver.client import Client as JClient
from kubeflow_tpu.apiserver.store import Store as JStore
from kubeflow_tpu.monitoring import plane as jplane
from kubeflow_tpu.monitoring import rules as jrules
from kubeflow_tpu.monitoring import scrape as jscrape
from kubeflow_tpu.monitoring import tsdb as jtsdb
from kubeflow_tpu.runtime.metrics import METRICS as J_METRICS
from kubeflow_tpu.runtime.metrics import MetricsRegistry as JRegistry
from kubeflow_tpu.runtime.obs import mount_observability as j_mount
from kubeflow_tpu.runtime.tracing import TRACER as J_TRACER
from kubeflow_tpu.serving import autoscaler as jasc
from kubeflow_tpu.web.http import App as JApp
from kubeflow_tpu_torch.e2e.elastic_cluster import PodClient
from kubeflow_tpu_torch.monitoring import plane as tplane
from kubeflow_tpu_torch.monitoring import rules as trules
from kubeflow_tpu_torch.monitoring import scrape as tscrape
from kubeflow_tpu_torch.monitoring import tsdb as ttsdb
from kubeflow_tpu_torch.runtime.metrics import METRICS as T_METRICS
from kubeflow_tpu_torch.runtime.metrics import MetricsRegistry as TRegistry
from kubeflow_tpu_torch.runtime.obs import EXPOSITION_CONTENT_TYPE, mount_observability
from kubeflow_tpu_torch.runtime.tracing import TRACER as T_TRACER
from kubeflow_tpu_torch.serving import autoscaler as tasc
from kubeflow_tpu_torch.web.http import App, Request


@pytest.fixture(autouse=True)
def _reset_port_metrics():
    T_METRICS.reset()
    yield


def _families(fams):
    return [(f.name, f.kind, [(s.name, s.labels, s.value, s.raw_labels, s.raw_value,
                               s.raw_exemplar) for s in f.samples]) for f in fams]


def _registry_text(reg, tracer) -> str:
    reg.counter("req_total", code="200", path="/x").inc(3)
    reg.gauge("depth").set(2.5)
    with tracer.span("obs"):
        reg.histogram("lat_seconds", buckets=(0.1, 0.5), model="m").observe(0.05)
    reg.histogram("lat_seconds", buckets=(0.1, 0.5), model="n").observe(0.7)
    return reg.render()


VALID = [
    "# TYPE a counter\na 1\n# EOF\n",
    "# TYPE h histogram\nh_bucket{le=\"+Inf\"} 2\nh_sum 0.4\nh_count 2\n# EOF\n",
    "# HELP a something\n# TYPE a gauge\na{msg=\"line\\nbreak \\\"q\\\"\"} 1\n# EOF\n",
    "# TYPE g gauge\ng{a=\"1\",b=\"x y\"} -2.5e-3\n\n# TYPE c counter\nc 7 # {trace_id=\"ab\"} 1 2.5\n# EOF\n",
    "# TYPE u untyped\nu 1\n",  # no EOF: only with require_eof=False
]

#: JAX's malformed cases, and a few more of each rule
MALFORMED = [
    "# TYPE a counter\na 1\n",                        # missing EOF
    "# TYPE a counter\na 1\n# EOF\na 2\n",            # content after EOF
    "# TYPE a counter\nb 1\n# EOF\n",                 # outside the family
    "a 1\n# EOF\n",                                   # before any TYPE
    "# TYPE a counter\na{oops} 1\n# EOF\n",           # junk label set
    "# TYPE a counter\na 1 2\n# EOF\n",               # extra token
    "# TYPE a counter\na nope\n# EOF\n",              # bad value
    "# TYPE a wat\na 1\n# EOF\n",                     # unknown kind
    "# weird comment\n# EOF\n",                       # not TYPE/HELP/EOF
    "# TYPE a counter\n# TYPE a counter\n# EOF\n",    # duplicate TYPE
    '# TYPE a counter\na{x="unterminated} 1\n# EOF\n',
    "# TYPE a counter\na 1\n# EOF",                   # no final newline
    "# TYPE a gauge\na 1 # {t=\"x\"} 1 2\n# EOF\n",   # exemplar on a gauge
    "# TYPE a counter\na 1 # junk\n# EOF\n",          # malformed exemplar
    "# TYPE a counter\na{x=\"1\" y=\"2\"} 1\n# EOF\n",  # stray tokens between pairs
    "# TYPE a counter\n9a 1\n# EOF\n",                # bad metric name
    "# TYPE a counter\na{x=\"1\"}1\n# EOF\n",          # no space before the value
]


@pytest.mark.parametrize("i", range(len(VALID)))
def test_parse_and_render_as_jax(i):
    text = VALID[i]
    eof = text.rstrip("\n").endswith("# EOF")
    j = jscrape.parse_exposition(text, require_eof=eof)
    t = tscrape.parse_exposition(text, require_eof=eof)
    assert _families(t) == _families(j)
    assert tscrape.render_exposition(t) == jscrape.render_exposition(j)


@pytest.mark.parametrize("i", range(len(MALFORMED)))
def test_malformed_text_raises_the_jax_parse_error(i):
    text = MALFORMED[i]
    with pytest.raises(jscrape.ParseError) as je:
        jscrape.parse_exposition(text)
    with pytest.raises(tscrape.ParseError) as te:
        tscrape.parse_exposition(text)
    assert (te.value.lineno, str(te.value)) == (je.value.lineno, str(je.value))


def test_metrics_cross_parse_byte_for_byte():
    """Each side's parser takes the other's registry render and re-renders
    it byte for byte; the two parses agree."""
    jtext = _registry_text(JRegistry(), J_TRACER)
    ttext = _registry_text(TRegistry(), T_TRACER)
    assert "trace_id=" in ttext and ttext.endswith("# EOF\n")
    for text in (jtext, ttext):
        j = jscrape.parse_exposition(text)
        t = tscrape.parse_exposition(text)
        assert _families(t) == _families(j)
        assert tscrape.render_exposition(t) == text == jscrape.render_exposition(j)


# -- tsdb -----------------------------------------------------------------------


def _script_tsdb(mod):
    """One scripted history through a module's TSDB; every read it makes."""
    out = []
    db = mod.TSDB(max_points=4, max_series=6)
    for i in range(10):
        db.add_sample("m", {"x": "1"}, float(i), float(i))
    out.append([list(s.points) for s in db.series("m")])
    for ts, v in ((1, 10.0), (2, 15.0), (3, 2.0), (4, 5.0)):
        db.add_sample("c", {"k": "a"}, float(ts), v)
    out.append((db.increase("c", 10.0, 5.0), db.rate("c", 10.0, 5.0),
                db.increase("c", 1.5, 4.0)))
    db.add_sample("up", {"instance": "a:1", "job": "x"}, 1.0, 1.0)
    db.add_sample("up", {"instance": "b:2", "job": "y"}, 1.0, 0.0)
    out.append(sorted(str(r) for r in db.latest("up", {"instance": re.compile(r"[ab]:\d")})))
    out.append((db.latest("up", {"job": "z"}), db.latest("up", {"missing": "v"})))
    out.append(db.mark_stale(instance="a:1"))
    out.append((db.latest("up"), sorted(str(r) for r in db.latest("up", include_stale=True)),
                db.newest_ts("up"), db.stats()))
    db.add_sample("up", {"instance": "a:1", "job": "x"}, 2.0, 1.0)
    out.append((len(db.latest("up")), db.stats()))
    db.add_sample("new", {"i": "1"}, 99.0, 1.0)  # evicts the oldest-written series
    out.append((db.names(), db.stats()))
    db2 = mod.TSDB()
    for inst, slow in (("a:1", 0), ("b:2", 10)):
        lab = {"instance": inst}
        for le, v0, v1 in (("0.1", 10, 10), ("0.5", 10, 10), ("+Inf", 10, 10 + slow)):
            db2.add_sample("lat_bucket", {**lab, "le": le}, 1.0, float(v0))
            db2.add_sample("lat_bucket", {**lab, "le": le}, 2.0, float(v1))
    out.append((db2.histogram_quantile("lat", 0.5, 1.5, 2.0),
                db2.histogram_quantile("lat", 0.5, 0.5, 0.9),
                db2.histogram_quantile("missing", 0.5, 10.0, 2.0),
                db2.windowed_bucket_counts("lat", 1.5, 2.0),
                db2.windowed_bucket_counts("lat", 1.5, 2.0, {"instance": "a:1"})))
    db2.set_kind("lat", "histogram", ("lat_bucket", "lat_sum", "lat_count"))
    out.append((db2.kind("lat"), db2.family_of("lat_bucket"), db2.family_of("zzz")))
    return out


def test_tsdb_reads_as_jax():
    assert _script_tsdb(ttsdb) == _script_tsdb(jtsdb)


# -- rules ----------------------------------------------------------------------


def _write_histogram(db, metric, now, fast, slow, instance="a:1"):
    """One scrape's cumulative buckets: ``fast`` observations <= 0.1 s and
    ``slow`` ones in the 2.5 bucket (JAX's test helper)."""
    lab = {"instance": instance, "job": "serving"}
    db.set_kind(metric, "histogram", (f"{metric}_bucket", f"{metric}_sum", f"{metric}_count"))
    for le, cum in (("0.1", fast), ("0.5", fast), ("2.5", fast + slow), ("+Inf", fast + slow)):
        db.add_sample(f"{metric}_bucket", {**lab, "le": le}, now, float(cum))
    db.add_sample(f"{metric}_count", lab, now, float(fast + slow))
    db.add_sample(f"{metric}_sum", lab, now, 0.05 * fast + 1.0 * slow)


def _lifecycle(rules, tsdb, client, registry, for_s=2.0):
    """JAX's pending → firing → resolved script, then a scrape gap: the
    status dicts of every evaluation and the Events (reason, type, count)
    after each."""
    db = tsdb.TSDB()
    engine = rules.RuleEngine(db, client=client, repeat_s=1.0, registry=registry)
    engine.add(rules.SLOBurnRateAlert(
        name="TtftBurn", metric="lat", threshold_s=0.1, objective=0.9,
        windows=(rules.BurnRateWindow(short_s=10.0, long_s=30.0, factor=2.0,
                                      severity="page"),), for_s=for_s))
    engine.add(rules.RecordingRule(
        record="job:up:count", fn=lambda t, now: [({}, float(len(t.latest("lat_count"))))]))
    trace = []

    def step(t, fast, slow):
        _write_histogram(db, "lat", t, fast=fast, slow=slow)
        statuses = engine.evaluate(now=t)
        events = sorted((e["reason"], e["type"], e["count"])
                        for e in client.list("v1", "Event", "kubeflow-system"))
        firing = registry.value("alerts_firing", alertname="TtftBurn", severity="page")
        trace.append((statuses, events, firing))

    step(0.0, 10, 0)
    step(1.0, 20, 0)
    slow = 0
    for t in (2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 7.5, 8.0):
        slow += 50
        step(t, 20, slow)
    fast = 20
    for t in (40.0, 41.0, 42.0):
        fast += 500
        step(t, fast, slow)
    trace.append((engine.evaluate(now=500.0), engine.snapshot(),
                  db.latest("job:up:count")))
    return trace


def test_burn_rate_lifecycle_and_events_as_jax():
    j = _lifecycle(jrules, jtsdb, JClient(JStore()), J_METRICS)
    t = _lifecycle(trules, ttsdb, PodClient(), T_METRICS)
    assert t == j
    states = [s[0][0]["state"] for s in j[:-1]]
    assert states[:4] == ["inactive", "inactive", "pending", "pending"]
    assert "firing" in states and states[-1] == "resolved"
    warnings = [e for e in t[-2][1] if e[0] == "TtftBurn"]
    assert warnings[0][1] == "Warning" and warnings[0][2] >= 3
    assert ("TtftBurnResolved", "Normal", 1) in t[-2][1]


def test_scrape_gap_holds_a_firing_alert_as_jax():
    def run(rules, tsdb):
        db = tsdb.TSDB(max_points=16)
        engine = rules.RuleEngine(db)
        engine.add(rules.SLOBurnRateAlert(
            name="X", metric="lat", threshold_s=0.1, objective=0.9,
            windows=(rules.BurnRateWindow(10.0, 30.0, 2.0, "page"),)))
        _write_histogram(db, "lat", 0.0, fast=5, slow=0)
        _write_histogram(db, "lat", 1.0, fast=5, slow=100)
        return engine.evaluate(now=1.0), engine.evaluate(now=500.0)

    j, t = run(jrules, jtsdb), run(trules, ttsdb)
    assert t == j and t[1][0]["state"] == "firing" and t[1][0]["burn_short"] is None


def test_broken_recording_rule_and_bad_objective_as_jax():
    for rules, tsdb, reg in ((jrules, jtsdb, J_METRICS), (trules, ttsdb, T_METRICS)):
        engine = rules.RuleEngine(tsdb.TSDB(), registry=reg)
        engine.add(rules.RecordingRule(record="boom", fn=lambda t, n: 1 / 0))
        engine.evaluate(now=1.0)
        assert reg.value("monitoring_rule_failures_total", record="boom") == 1.0
        with pytest.raises(ValueError):
            rules.SLOBurnRateAlert("X", "m", 0.1, objective=1.5)
        with pytest.raises(TypeError):
            engine.add(object())


# -- the federated autoscaler source ----------------------------------------------


class FakeScalableFleet:
    """Counts scale decisions (JAX's tests/test_fleet.py fake)."""

    def __init__(self, n=2, lo=1, hi=4):
        self.n, self.min_replicas, self.max_replicas = n, lo, hi
        self.calls = []

    @property
    def desired_replicas(self):
        return self.n

    def scale_to(self, n, reason=""):
        self.calls.append((n, reason))
        self.n = n


def _feed_serving(db, now, fast, slow):
    _write_histogram(db, "serving_ttft_seconds", now, fast, slow)
    _write_histogram(db, "serving_queue_wait_seconds", now, fast, 0)


def _federated(asc_mod, tsdb_mod, script, **kw):
    cfg = dict(ttft_slo=0.5, queue_wait_slo=0.25, quantile=0.99, scale_down_margin=0.5,
               breach_ticks=2, idle_ticks=2, cooldown_ticks=0)
    cfg.update(kw)
    db = tsdb_mod.TSDB()
    fleet = FakeScalableFleet(n=2)
    asc = asc_mod.SLOAutoscaler(fleet, asc_mod.AutoscalerConfig(**cfg),
                                source=asc_mod.FederatedWindowSource(db))
    lasts = []
    for feed in script:
        if feed == "gap":
            pass
        elif feed == "stale":
            db.mark_stale(instance="a:1")
        else:
            _feed_serving(db, *feed)
        lasts.append((asc.tick(), dict(asc.last)))
    return fleet.calls, lasts


SCRIPTS = {
    "breach": ([(0.0, 10, 0), (1.0, 10, 50), (2.0, 10, 100)], {}),
    # the no-flap regression: an idle streak of 2 of 4 when the scrapes stop
    "gap": ([(0.0, 10, 0), (1.0, 20, 0), (2.0, 30, 0)] + ["gap"] * 6 + ["stale"] * 3,
            {"idle_ticks": 4}),
    "quiet": ([(float(t), 10, 0) for t in range(6)], {}),
    "reset": ([(0.0, 100, 0), (1.0, 200, 0), (2.0, 5, 0)], {}),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_federated_window_source_as_jax(name):
    script, kw = SCRIPTS[name]
    j = _federated(jasc, jtsdb, script, **kw)
    t = _federated(tasc, ttsdb, script, **kw)
    assert t == j
    calls, lasts = t
    if name == "breach":
        assert calls == [(3, "slo_breach")] and lasts[-1][1]["source"] == "federated"
    elif name == "gap":
        assert calls == [] and all(last["stale"] for _d, last in lasts[3:])
    elif name == "quiet":
        assert (1, "idle") in calls
    else:
        assert calls == [] and lasts[-1][1]["stale"] is True


# -- scrape, federation, the plane ------------------------------------------------


@pytest.fixture()
def metrics_server():
    """A port HTTP server exposing a private registry at /metrics."""
    reg = TRegistry()
    app = App("scrape-target")
    mount_observability(app, registry=reg)
    srv = app.serve(0)
    try:
        yield reg, f"http://127.0.0.1:{srv.port}/metrics"
    finally:
        srv.close()


def _without(text: str, *families: str) -> str:
    return "".join(line + "\n" for line in text.splitlines()
                   if not any(f in line for f in families))


def test_scrape_ingest_and_federate_as_jax(metrics_server):
    """Both scrapers read one port server: the same series, labels and
    kinds land in each TSDB, and the two planes federate the same text
    (but for each scrape's own duration and the target's process series,
    read at two moments); each side parses both."""
    reg, url = metrics_server
    reg.counter("widget_total", kind="a").inc(4)
    reg.gauge("g", instance="impostor").set(1.0)
    reg.histogram("lat_seconds", buckets=(0.1, 0.5)).observe(0.3)
    jp = jplane.MonitoringPlane(targets=[jscrape.Target(job="ops", url=url)])
    tp = tplane.MonitoringPlane(targets=[tscrape.Target(job="ops", url=url)])
    assert tp.tick(now=100.0) == jp.tick(now=100.0) == []
    for name in ("widget_total", "g", "lat_seconds_bucket", "up"):
        assert tp.tsdb.latest(name) == jp.tsdb.latest(name)
    assert tp.tsdb.kind("lat_seconds") == jp.tsdb.kind("lat_seconds") == "histogram"
    (labels, _ts, _v) = tp.tsdb.latest("g")[0]
    assert labels["exported_instance"] == "impostor" and labels["job"] == "ops"
    assert T_METRICS.value("monitoring_scrapes_total", result="ok") == 1.0
    assert T_METRICS.value("monitoring_scrape_targets") == 1.0
    jtext, ttext = jp.federate_text(), tp.federate_text()
    assert (_without(ttext, "scrape_duration", "process_")
            == _without(jtext, "scrape_duration", "process_"))
    for text in (jtext, ttext):
        assert _families(tscrape.parse_exposition(text)) == _families(
            jscrape.parse_exposition(text))


def test_federate_text_of_equal_stores_as_jax():
    def plane(tsdb, plane_mod):
        db = tsdb.TSDB()
        db.set_kind("up", "gauge")
        db.add_sample("up", {"instance": "a:1", "job": "x"}, 1.0, 1.0)
        db.add_sample("up", {"instance": "b:2", "job": "x"}, 1.0, 1.0)
        _write_histogram(db, "lat", 1.0, fast=3, slow=2)
        db.add_sample("plain", {}, 1.0, 0.5)
        db.mark_stale(instance="b:2")
        return plane_mod.MonitoringPlane(tsdb=db).federate_text()

    j, t = plane(jtsdb, jplane), plane(ttsdb, tplane)
    assert t == j
    assert 'instance="a:1"' in t and 'instance="b:2"' not in t
    assert "# TYPE plain untyped" in t


def test_dead_target_goes_stale_as_jax():
    def run(plane_mod, scrape_mod, tsdb_mod):
        reg = TRegistry()
        reg.counter("widget_total").inc()
        app = App("mortal")
        mount_observability(app, registry=reg)
        srv = app.serve(0)
        url = f"http://127.0.0.1:{srv.port}/metrics"
        db = tsdb_mod.TSDB()
        sc = scrape_mod.Scraper(db, targets=[scrape_mod.Target(job="ops", url=url)],
                                stale_after=2, timeout_s=0.5)
        reads = [sc.scrape_once(now=1.0)]
        srv.close()
        reads.append((sc.scrape_once(now=2.0), db.latest("up")[0][2],
                      len(db.latest("widget_total"))))
        reads.append((sc.scrape_once(now=3.0), db.latest("widget_total"),
                      len(db.latest("widget_total", include_stale=True)),
                      db.latest("up")[0][2]))
        # the instance is each run's own port: compare the up flags
        return [tuple(list(x.values()) if isinstance(x, dict) else x for x in r)
                if isinstance(r, tuple) else list(r.values()) for r in reads]

    assert run(tplane, tscrape, ttsdb) == run(jplane, jscrape, jtsdb)
    assert T_METRICS.value("monitoring_scrapes_total", result="error") == 2.0


def test_port_metrics_and_federate_cross_parse_over_http(metrics_server):
    """JAX's parser takes the port's served /metrics and /federate; the
    port's parser takes a JAX app's /metrics and the JAX plane's federation."""
    reg, url = metrics_server
    with T_TRACER.span("x"):
        reg.histogram("lat_seconds", buckets=(0.1, 0.5)).observe(0.05)
    tp = tplane.MonitoringPlane(targets=[tscrape.Target(job="ops", url=url)])
    tp.tick(now=1.0)
    app = App("monitor")
    mount_observability(app)
    tp.mount(app)
    srv = app.serve(0)
    japp = JApp("jax-target")
    j_mount(japp, registry=JRegistry())
    jsrv = japp.serve(0)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/federate") as resp:
            assert resp.headers["Content-Type"] == EXPOSITION_CONTENT_TYPE
            federated = resp.read().decode()
        with urllib.request.urlopen(url) as resp:
            served = resp.read().decode()
        with urllib.request.urlopen(f"http://127.0.0.1:{jsrv.port}/metrics") as resp:
            jserved = resp.read().decode()
    finally:
        srv.close()
        jsrv.close()
    assert "trace_id=" in served
    for text in (federated, served, jserved):
        assert jscrape.render_exposition(jscrape.parse_exposition(text)) == text
        assert tscrape.render_exposition(tscrape.parse_exposition(text)) == text


def test_plane_mounts_federate_and_debug_alerts():
    db = ttsdb.TSDB()
    db.set_kind("up", "gauge")
    db.add_sample("up", {"instance": "a:1"}, 1.0, 1.0)
    tp = tplane.MonitoringPlane(tsdb=db)
    tp.rules.add(trules.SLOBurnRateAlert(
        name="X", metric="widget", threshold_s=0.1, objective=0.9,
        windows=(trules.BurnRateWindow(10.0, 30.0, 2.0, "page"),)))
    tp.tick(now=1.0)
    app = mount_observability(App("monitor"))
    tp.mount(app)
    tp.mount(app)  # idempotent

    def call(path):
        return app.dispatch(Request(method="GET", path=path, query={}, headers={}, body=b""))

    resp = call("/federate")
    assert resp.status == 200 and resp.headers["Content-Type"] == EXPOSITION_CONTENT_TYPE
    assert [f.name for f in tscrape.parse_exposition(resp.body)] == ["up"]
    alerts = call("/debug/alerts").body
    assert alerts["evaluations"] == 1 and alerts["alerts"][0]["alertname"] == "X"


def test_plane_background_loop_runs_and_stops(metrics_server):
    reg, url = metrics_server
    reg.gauge("g").set(1.0)
    tp = tplane.MonitoringPlane(targets=[tscrape.Target(job="j", url=url)])
    tp.start(interval_s=0.02)
    try:
        deadline = time.monotonic() + 5.0
        while not tp.tsdb.latest("g") and time.monotonic() < deadline:
            time.sleep(0.02)
        assert tp.tsdb.latest("g"), "background tick never scraped"
    finally:
        tp.stop()
    assert tp.rules.evaluations >= 1


def test_discovery_from_annotated_pods_dedups_by_instance(metrics_server):
    _reg, url = metrics_server
    clients = (JClient(JStore()), PodClient())
    for client in clients:
        for name in ("rep-0", "rep-1"):
            client.create({"apiVersion": "v1", "kind": "Pod",
                           "metadata": {"name": name, "namespace": "default", "annotations": {
                               tscrape.SCRAPE_ANNOTATION: "true",
                               tscrape.SCRAPE_URL_ANNOTATION: url,
                               tscrape.SCRAPE_JOB_ANNOTATION: "fleet"}}})
        client.create({"apiVersion": "v1", "kind": "Pod",
                       "metadata": {"name": "plain", "namespace": "default"}})
    static = "http://127.0.0.1:9/m"
    j = jscrape.Scraper(jtsdb.TSDB(), targets=[jscrape.Target("static", static)],
                        client=clients[0]).discover()
    t = tscrape.Scraper(ttsdb.TSDB(), targets=[tscrape.Target("static", static)],
                        client=clients[1]).discover()
    assert [(x.job, x.url, x.instance) for x in t] == [(x.job, x.url, x.instance) for x in j]
    assert {x.job for x in t} == {"static", "fleet"}
    assert (tscrape.SCRAPE_ANNOTATION, tscrape.SCRAPE_URL_ANNOTATION,
            tscrape.SCRAPE_JOB_ANNOTATION) == (jscrape.SCRAPE_ANNOTATION,
                                               jscrape.SCRAPE_URL_ANNOTATION,
                                               jscrape.SCRAPE_JOB_ANNOTATION)


class _Eng:
    def __init__(self, engine_id):
        self.engine_id = engine_id

    def drain(self):
        return []

    def close(self):
        pass


def test_fleet_pods_carry_the_jax_scrape_annotations():
    from kubeflow_tpu.serving.fleet import EngineFleet as JFleet
    from kubeflow_tpu_torch.serving.fleet import EngineFleet as TFleet

    url = "http://10.0.0.5:8080/metrics"
    jc, tc = JClient(JStore()), PodClient()
    jf = JFleet(replicas=2, name="mon", engine_factory=_Eng, client=jc, register_debug=False,
                metrics_url=url)
    tf = TFleet(replicas=2, name="mon", engine_factory=_Eng, client=tc, register_debug=False,
                metrics_url=url, device="cpu")
    try:
        jpods, tpods = jc.list("v1", "Pod"), tc.list("v1", "Pod")
        assert len(tpods) == 2
        for jp, tp in zip(jpods, tpods):
            assert tp["metadata"]["annotations"] == jp["metadata"]["annotations"]
            assert tp["metadata"]["annotations"][tscrape.SCRAPE_JOB_ANNOTATION] == "mon"
        assert len({x.instance for x in tscrape.Scraper(ttsdb.TSDB(), client=tc).discover()}) == 1
    finally:
        jf.close()
        tf.close()
    plain = TFleet(replicas=1, name="p", engine_factory=_Eng, client=PodClient(),
                   register_debug=False, device="cpu")
    try:
        pod = plain._client.list("v1", "Pod")[0]
        assert tscrape.SCRAPE_ANNOTATION not in pod["metadata"]["annotations"]
    finally:
        plain.close()


def test_cluster_collector_counts_gpus_as_jax_counts_tpus():
    jc, tc = JClient(JStore()), PodClient()
    for client, resource in ((jc, "google.com/tpu"), (tc, "nvidia.com/gpu")):
        client.create({"apiVersion": "v1", "kind": "Node",
                       "metadata": {"name": "node-a"}, "status": {"capacity": {resource: "4"}}})
        for name, chips, phase in (("w", 2, "Running"), ("done", 1, "Succeeded")):
            client.create({"apiVersion": "v1", "kind": "Pod",
                           "metadata": {"name": name, "namespace": "default"},
                           "spec": {"nodeName": "node-a", "containers": [
                               {"name": "c", "resources": {"limits": {resource: str(chips)}}}]},
                           "status": {"phase": phase}})
    jreg, treg = JRegistry(), TRegistry()
    jplane.install_cluster_collector(jc, registry=jreg)
    tplane.install_cluster_collector(tc, registry=treg)
    jtext, ttext = jreg.render(), treg.render()
    assert 'node_tpu_capacity_chips{node="node-a"} 4' in jtext
    assert ttext == jtext.replace("node_tpu_", "node_gpu_")


def test_concurrent_scrapes_and_reads_stay_consistent(metrics_server):
    """The TSDB under a scraping thread and readers: no exception, every
    read a well-formed point."""
    reg, url = metrics_server
    reg.counter("c_total").inc()
    tp = tplane.MonitoringPlane(targets=[tscrape.Target(job="j", url=url)])
    errors = []

    def read():
        for _ in range(200):
            try:
                for labels, ts, v in tp.tsdb.latest("c_total"):
                    assert labels["job"] == "j" and v == 1.0
                tp.federate_text()
            except Exception as e:  # surfaced below
                errors.append(e)

    t = threading.Thread(target=read)
    t.start()
    for i in range(20):
        tp.tick(now=float(i))
    t.join()
    assert errors == []
