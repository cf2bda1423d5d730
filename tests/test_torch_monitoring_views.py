"""The monitoring plane's rule bundles and views in the port against the
JAX package's: ``goodput_recording_rules``, ``TenantChipMeter``,
``straggler_rules`` and the dashboard's platform overview
(``services/dashboard.py``).

The same series go into a JAX and a port TSDB, the same rules evaluate on
both, and the recorded series, alert statuses, counters and overview
documents are equal (``==``: the same Python arithmetic; only the
overview's ``lastScrapeAgoSeconds``, read off each side's wall clock, is
left out).
"""

from __future__ import annotations

import time

import pytest

from kubeflow_tpu.apiserver.client import Client as JClient
from kubeflow_tpu.apiserver.store import Store as JStore
from kubeflow_tpu.monitoring import goodput as jgoodput
from kubeflow_tpu.monitoring import plane as jplane
from kubeflow_tpu.monitoring import rules as jrules
from kubeflow_tpu.monitoring import stragglers as jstrag
from kubeflow_tpu.monitoring import traces as jtraces
from kubeflow_tpu.monitoring import tsdb as jtsdb
from kubeflow_tpu.runtime.metrics import METRICS as J_METRICS
from kubeflow_tpu.runtime.metrics import MetricsRegistry as JRegistry
from kubeflow_tpu_torch.monitoring import goodput as tgoodput
from kubeflow_tpu_torch.monitoring import plane as tplane
from kubeflow_tpu_torch.monitoring import rules as trules
from kubeflow_tpu_torch.monitoring import stragglers as tstrag
from kubeflow_tpu_torch.monitoring import traces as ttraces
from kubeflow_tpu_torch.monitoring import tsdb as ttsdb
from kubeflow_tpu_torch.runtime.metrics import METRICS as T_METRICS
from kubeflow_tpu_torch.runtime.metrics import MetricsRegistry as TRegistry
from kubeflow_tpu_torch.services.dashboard import PlatformViews
from kubeflow_tpu_torch.web.http import HttpError


@pytest.fixture(autouse=True)
def _reset_port_metrics():
    T_METRICS.reset()
    yield


class FakeClock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def _rules_run(rules, tsdb, bundle, feed, times):
    db = tsdb.TSDB()
    engine = rules.RuleEngine(db, registry=JRegistry() if rules is jrules else TRegistry())
    for rule in bundle:
        engine.add(rule)
    out = []
    for t in times:
        feed(db, t)
        statuses = engine.evaluate(now=t)
        out.append((statuses, {r.record: db.latest(r.record)
                               for r in engine.recording_rules}))
    return out


def _goodput_feed(db, t):
    i = int(t)
    for w, good in (("a", 3.0), ("b", 1.5)):
        db.add_sample("training_goodput_seconds_total", {"instance": w}, t, good * i)
    for bucket, secs in (("compile", 0.5), ("data_wait", 0.25)):
        db.add_sample("training_badput_seconds_total", {"bucket": bucket, "instance": "a"},
                      t, secs * i)


def test_goodput_recording_rule_as_jax():
    times = [0.0, 1.0, 2.0, 3.0]
    j = _rules_run(jrules, jtsdb, jgoodput.goodput_recording_rules(), _goodput_feed, times)
    t = _rules_run(trules, ttsdb, tgoodput.goodput_recording_rules(), _goodput_feed, times)
    assert t == j
    assert t[0][1] == {"platform:training_goodput_fraction": []}  # no seconds yet
    assert t[-1][1]["platform:training_goodput_fraction"][0][2] == pytest.approx(4.5 / 5.25)


def _straggler_feed(db, t):
    i = int(t)
    for w, wall in (("w0", 0.1), ("w1", 0.1), ("w2", 0.1 if i < 3 else 0.9)):
        lab = {"worker": w, "instance": "h:1"}
        db.add_sample("training_worker_step_wall_seconds", lab, t, wall)
        # the step-latency histogram: 10 steps a scrape, the slow worker's
        # above the 1 s SLO from scrape 3 on
        slow = 10 * max(0, i - 2) if w == "w2" else 0
        fast = 10 * (i + 1) - slow
        for le, cum in (("0.5", fast), ("1.0", fast), ("2.5", fast + slow),
                        ("+Inf", fast + slow)):
            db.add_sample("training_worker_step_seconds_bucket", {**lab, "le": le}, t,
                          float(cum))


def test_straggler_rules_as_jax():
    times = [float(t) for t in range(8)]
    j = _rules_run(jrules, jtsdb, jstrag.straggler_rules(step_slo_s=1.0, objective=0.99),
                   _straggler_feed, times)
    t = _rules_run(trules, ttsdb, tstrag.straggler_rules(step_slo_s=1.0, objective=0.99),
                   _straggler_feed, times)
    assert t == j
    skews = [r[1]["platform:training_worker_step_skew"][0][2] for r in t]
    assert skews[0] == pytest.approx(1.0) and skews[-1] == pytest.approx(9.0)
    states = [r[0][0]["state"] for r in t]
    assert states[0] == "inactive" and "firing" in states


def _meter_script(meter, clk):
    meter.on_bind("p0", "team-a", 4)
    clk.now += 2.0
    meter.on_bind("p0", "team-a", 4)   # an informer echo: same interval
    meter.on_bind("p1", None, 2)
    clk.now += 1.0
    meter.flush()
    opened = meter.open_intervals()
    meter.on_bind("p0", "team-b", 4)   # moved: settle, then a new interval
    clk.now += 0.5
    meter.on_unbind("p0")
    meter.on_unbind("missing")
    clk.now += 3.0
    meter.flush()
    return opened, meter.open_intervals()


def test_tenant_chip_meter_as_jax():
    out = []
    for mod, reg in ((jgoodput, JRegistry()), (tgoodput, TRegistry())):
        clk = FakeClock()
        meter = mod.TenantChipMeter(registry=reg, clock=clk, collector_key="meter")
        opened, left = _meter_script(meter, clk)
        out.append((opened, left, {ns: reg.value("tenant_chip_seconds_total", namespace=ns)
                                   for ns in ("team-a", "team-b", "default")},
                    reg.render()))
    assert out[1] == out[0]
    assert out[1][2] == {"team-a": 12.0, "team-b": 2.0, "default": 9.0}
    assert isinstance(tgoodput.TENANT_METER, tgoodput.TenantChipMeter)


def _fill(db, now):
    lab = {"instance": "a:1", "job": "ops"}
    db.set_kind("up", "gauge")
    db.add_sample("up", lab, now, 1.0)
    db.add_sample("up", {"instance": "b:2", "job": "serving"}, now, 0.0)
    db.set_kind("scrape_duration_seconds", "gauge")
    db.add_sample("scrape_duration_seconds", lab, now, 0.01)
    for t, fast, slow in ((now - 10.0, 5, 0), (now - 1.0, 20, 4)):
        for metric in ("serving_ttft_seconds", "serving_queue_wait_seconds",
                       "scheduler_bind_latency_seconds"):
            for le, cum in (("0.1", fast), ("0.5", fast), ("2.5", fast + slow),
                            ("+Inf", fast + slow)):
                db.add_sample(f"{metric}_bucket", {**lab, "le": le}, t, float(cum))
    db.add_sample("scheduler_cycles_per_sec", lab, now, 12.5)
    db.add_sample("workqueue_saturation", {**lab, "queue": "gangs"}, now, 0.25)
    db.add_sample("training_goodput_fraction", {**lab, "workload": "elastic"}, now, 0.8)
    db.add_sample("training_badput_seconds_total", {**lab, "bucket": "compile"}, now, 1.5)
    db.add_sample("training_goodput_seconds_total", lab, now, 6.0)
    db.add_sample("serving_tokens_out_total", lab, now, 90.0)
    db.add_sample("serving_discarded_tail_tokens_total", lab, now, 10.0)
    db.add_sample("tenant_chip_seconds_total", {**lab, "namespace": "team-a"}, now, 40.0)
    db.add_sample("tenant_tokens_total", {**lab, "namespace": "team-a", "direction": "in"},
                  now, 7.0)
    db.add_sample("training_straggler_score", {**lab, "worker": "w2"}, now, 0.8)
    db.add_sample("training_hangs_detected_total", {**lab, "worker": "w1"}, now, 1.0)


class _Detector:
    def snapshot(self):
        return {"quarantined": ["node-a"], "lastHangVerdict": {"worker": "w1"}}


def _overview(plane_mod, tsdb_mod, rules_mod, traces_mod, now, app=None):
    db = tsdb_mod.TSDB()
    _fill(db, now)
    collector = traces_mod.TraceCollector()
    collector.ingest({"resourceSpans": [{"resource": {"attributes": []}, "scopeSpans": [{
        "spans": [{"traceId": "1" * 32, "spanId": "a" * 16, "name": "gang.lifecycle",
                   "startTimeUnixNano": int(2e9), "endTimeUnixNano": int(3e9),
                   "attributes": {"gang": "g", "gang.bind_latency_s": 2.0,
                                  "gang.submitted_unix": 0.0}}]}]}]})
    plane = plane_mod.MonitoringPlane(tsdb=db, traces=collector, stragglers=_Detector())
    plane.rules.add(rules_mod.SLOBurnRateAlert(
        "TtftBurn", "serving_ttft_seconds", 0.5, objective=0.9,
        windows=(rules_mod.BurnRateWindow(5.0, 20.0, 2.0, "page"),)))
    plane.rules.evaluate(now=now)
    if app is None:
        doc = PlatformViews(plane).platform_overview(window_s=30.0)
    else:
        doc = app(plane).call("GET", "/api/metrics/platform?window=30", None,
                              {"kubeflow-userid": "ops@example.com"}).body
    for target in doc["targets"]:
        target.pop("lastScrapeAgoSeconds")
    return doc


def test_platform_overview_as_jax():
    from kubeflow_tpu.services.dashboard import make_dashboard_app
    from kubeflow_tpu.web.auth import AuthConfig

    def japp(plane):
        return make_dashboard_app(JClient(JStore()), auth=AuthConfig(disable_auth=True),
                                  monitoring=plane)

    now = time.time()
    j = _overview(jplane, jtsdb, jrules, jtraces, now, app=japp)
    t = _overview(tplane, ttsdb, trules, ttraces, now)
    assert t == j
    assert [x["up"] for x in t["targets"]] == [1.0, 0.0]
    assert t["serving"]["ttftP99"] is not None
    assert t["goodput"]["servingTokenGoodputFraction"] == pytest.approx(0.9)
    assert t["tenants"][0]["chipSeconds"] == 40.0
    assert t["stragglers"]["activeQuarantines"] == ["node-a"]
    assert t["tracing"]["slowestBinds"][0]["criticalPath"]["segments"][0]["name"] == "queue"
    assert t["alerts"][0]["alertname"] == "TtftBurn"


def test_platform_overview_without_data_as_jax():
    from kubeflow_tpu.services.dashboard import TpuMetricsService

    jdoc = TpuMetricsService(JClient(JStore()), monitoring=jtsdb.TSDB()).platform_overview()
    tdoc = PlatformViews(ttsdb.TSDB()).platform_overview()
    assert tdoc == jdoc
    assert tdoc["serving"]["ttftP99"] is None and tdoc["stragglers"] is None
    assert tdoc["tracing"] is None and tdoc["alerts"] == []
    with pytest.raises(HttpError) as e:
        PlatformViews().platform_overview()
    assert e.value.status == 503


def test_goodput_rule_reads_a_scraped_ledger():
    """The port's ledger, served and scraped by the port's plane: the rule's
    measured fraction over the federated counters."""
    from kubeflow_tpu_torch.monitoring.scrape import Target
    from kubeflow_tpu_torch.runtime.obs import mount_observability
    from kubeflow_tpu_torch.web.http import App

    reg = TRegistry()
    clk = FakeClock()
    led = tgoodput.GoodputLedger("scraped", registry=reg, clock=clk)
    led.start()
    led.note("compile", 1.0)
    led.step(0, 3.0)
    app = mount_observability(App("trainer"), registry=reg)
    srv = app.serve(0)
    try:
        plane = tplane.MonitoringPlane(
            targets=[Target(job="trainer", url=f"http://127.0.0.1:{srv.port}/metrics")])
        for rule in tgoodput.goodput_recording_rules():
            plane.rules.add(rule)
        plane.tick(now=1.0)
    finally:
        srv.close()
    (labels, _ts, value) = plane.tsdb.latest("platform:training_goodput_fraction")[0]
    assert labels == {} and value == pytest.approx(0.75)
    assert J_METRICS.value("monitoring_rule_failures_total",
                           record="platform:training_goodput_fraction") == 0.0
