"""Monitoring-plane e2e over real HTTP: the port of ``e2e/monitoring_driver.py``.

Boots THREE processes that each expose ``/metrics`` — a ``ModelServer``
serving a GPT ``GenerativeModel`` (seeded weights, paged arena) whose engine
is a 2-replica ``EngineFleet`` on the Pod path (this process), and two
subprocess "ops" servers of the port's own ``runtime.metrics``/``obs`` —
and drives one ``MonitoringPlane`` against them on the drivers' cluster
(``elastic_cluster.cluster``: the port's store, gang scheduler and podlet
on one GPU node of 8 cards), whose scheduler binds the replica Pods:

1. **Federation** — the fleet's replica Pods carry ``metrics_url``'s scrape
   annotations and the ops servers are annotated Pods; the scraper
   discovers all three targets (the replicas dedup to one instance),
   ``up == 1`` for each, and ``/federate`` (served over HTTP) re-exposes
   every process's series with instance/job labels in a dialect the
   port's parser accepts.
2. **Burn-rate lifecycle** — a slow-replica fault (``step_delay_s``, the
   knob the chaos monkey's ``slow_replica`` turns) pushes every TTFT past
   the threshold (2.5 s, a ``TTFT_BUCKETS`` bound: JAX's 0.25 s sits below
   the port's fast TTFTs, ``DECODE_CHUNK``); the multi-window burn-rate alert goes pending →
   firing and emits exactly ONE deduplicated Warning Event (count >= 2);
   removing the fault and pushing fast traffic resolves it
   (``alerts_firing`` back to 0, one Normal ``TtftBurnResolved`` Event).
3. **Scrape-backed autoscaling** — an ``SLOAutoscaler`` reading a
   ``FederatedWindowSource`` (the TSDB, not the in-process registry)
   scales the fleet 2 → 3 on the scraped breach; the scheduler binds the
   new replica's Pod.
4. **Dashboard** — the platform overview (``services/dashboard.py``
   ``PlatformViews``, called directly) reports the three targets up and a
   federated serving p99.

Both replicas are prewarmed before the first scrape. ``run(device=...,
tiny=True)`` returns the report: JAX's keys, plus the
alert's fire and resolve ticks and seconds, the scale-up's cold start and
the fast and slowed TTFT p50 (from the ``serving.request`` spans). ``tiny``
is JAX's GPT-tiny, ``tiny=False`` GPT-small; ``params`` serves weights the
caller built (``init_params`` of that config). ``model`` is a GPT servable
named ``gpt`` the caller built, with no engine yet: the driver serves it
through the fleet above and leaves it open, its replicas warmed
(``chip_smoke.py`` serves the trace-federation driver's predict through
it next). ``main`` prints the report
as one JSON line and exits 0, or prints ``{"ok": false, "error": ...}``
and exits 1. On the card: ``python -m kubeflow_tpu_torch.e2e.monitoring_driver``
(GPT-small; ``--tiny`` and ``--device cpu`` for a CPU check);
``--ttft-table`` prints the fast and slowed TTFTs at ``DECODE_CHUNK`` and
the engine's default chunk (``ttft_table``), which the threshold is
chosen from.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from ..device import DeviceLike
from ._http import get, post

OPS_PROCS = 2
MAX_NEW_TOKENS = 4
#: the replicas' decode chunk: the requests' budget. The port's engine reads
#: a request's first token once it has dispatched ``pipeline + 1`` decode
#: chunks, one host-dispatched step a token; at the engine's default of 16
#: that puts GPT-small's TTFT on an H100 in seconds (``ttft_table``), where
#: JAX's compiled chunk takes milliseconds
DECODE_CHUNK = MAX_NEW_TOKENS
#: the alert's and the autoscaler's TTFT bound (JAX: 0.25 s): a
#: TTFT_BUCKETS bound above the fast TTFTs, which at GPT-small on an H100
#: read 0.47-0.73 s (p10-p90) alone and up to ~1.6 s p50 while the plane
#: scrapes and the scaled-up replica serves its first requests
TTFT_THRESHOLD_S = 2.5
#: the slow-replica fault, seconds an engine iteration (JAX: 0.45 s): it
#: puts the slowed TTFTs at 4.5-5.2 s there (0.45 s: 2.6-2.9 s)
STEP_DELAY_S = 0.9
TICK_S = 0.15
#: concurrent request loops while the alert is driven
TRAFFIC_THREADS = 2
#: the autoscaler's cadence (JAX: 2.5 s): each window must hold a slowed
#: request's first token, and the loops' slowed requests land together,
#: a wave every ~6.5 s at the delay above
AUTOSCALE_EVERY_S = 10.0
REPLICAS = 2
MAX_REPLICAS = 3
#: the fleet's name: the scrape job of its replica Pods
FLEET_JOB = "serving"

#: an ops server of the port's own metrics, observability and HTTP app; it
#: serves until its stdin closes (the driver's teardown, or its death)
_OPS_SCRIPT = """
import sys
from kubeflow_tpu_torch.runtime.metrics import METRICS
from kubeflow_tpu_torch.runtime.obs import mount_observability
from kubeflow_tpu_torch.web.http import App

METRICS.gauge("workqueue_depth", queue="default").set(3)
METRICS.counter("workqueue_adds_total", queue="default").inc(7)
app = App("ops")
mount_observability(app)
srv = app.serve(0)
print(srv.port, flush=True)
sys.stdin.read()
srv.close()
"""


class _Traffic:
    """Background request loops so the tick loop never blocks on a slow
    (fault-injected) completion."""

    def __init__(self, url: str, prompt: list) -> None:
        self.url = url
        self.prompt = prompt
        self.sent = 0
        self.errors: list = []
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._run, daemon=True)
                         for _ in range(TRAFFIC_THREADS)]

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                status, _h, body = post(self.url, {"instances": [self.prompt]})
                if status != 200:
                    raise IOError(f"HTTP {status}: {body}")
                self.sent += 1
            except Exception as e:  # recorded, asserted by the driver
                self.errors.append(str(e))
                if len(self.errors) > 10:
                    return

    def __enter__(self) -> "_Traffic":
        for t in self._threads:
            t.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=120)


class _AutoscalerCadence:
    """Tick the autoscaler on its own slow cadence (``AUTOSCALE_EVERY_S``):
    evaluation windows must be long enough to hold traffic (an
    empty-but-fresh window legitimately reads as idle)."""

    def __init__(self, autoscaler) -> None:
        self.autoscaler = autoscaler
        self.every_s = AUTOSCALE_EVERY_S
        self._last = 0.0

    def maybe_tick(self) -> None:
        now = time.monotonic()
        if now - self._last >= self.every_s:
            self._last = now
            self.autoscaler.tick()


def _tick_until(plane, predicate, timeout: float, desc: str, cadence=None) -> list:
    """Drive ``plane.tick()`` (then the autoscaler cadence, where given) on
    real time until ``predicate(statuses)`` holds."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        statuses = plane.tick()
        if cadence is not None:
            cadence.maybe_tick()
        if predicate(statuses):
            return statuses
        time.sleep(TICK_S)
    raise AssertionError(f"timed out after {timeout}s waiting for {desc}")


def _events(client, reason: str) -> list:
    return [e for e in client.list("v1", "Event", "kubeflow-system")
            if e.get("reason") == reason]


def _ttfts(since_ns: int, until_ns: int) -> List[float]:
    """Sorted seconds from submit to first token of the ``serving.request``
    spans started in ``[since_ns, until_ns)``."""
    from ..runtime.tracing import TRACER

    out: List[float] = []
    for span in TRACER.finished_spans("serving.request"):
        if not since_ns <= span.start_ns < until_ns:
            continue
        ev = {e["name"]: e["timeUnixNano"] for e in span.events}
        if "first_token" in ev:
            out.append((ev["first_token"] - span.start_ns) / 1e9)
    return sorted(out)


def _quantile(values: List[float], q: float) -> Optional[float]:
    """Linear-interpolated quantile of sorted ``values`` (numpy's default)."""
    if not values:
        return None
    pos = q * (len(values) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(values) - 1)
    return values[lo] + (values[hi] - values[lo]) * (pos - lo)


def _ttft_p50(since_ns: int, until_ns: int) -> Optional[float]:
    return _quantile(_ttfts(since_ns, until_ns), 0.5)


def ttft_table(device: DeviceLike = "cuda", tiny: bool = True, params=None,
               chunks=(DECODE_CHUNK, 16), delays=(0.0, STEP_DELAY_S),
               seconds: float = 8.0) -> List[Dict[str, Any]]:
    """The TTFTs the threshold is chosen from: for each decode chunk, the
    driver's 2-replica fleet (prewarmed) serves one request alone, then
    the driver's two traffic loops for ``seconds`` at each slow-replica
    delay; a row each with the TTFT p10, p50 and p90 (``serving.request``
    spans)."""
    from ..serving.fleet import EngineFleet
    from ..serving.server import ModelServer, gpt_served_model

    rows: List[Dict[str, Any]] = []
    prompt = list(range(1, 9))
    for chunk in chunks:
        model = gpt_served_model(name="gpt", tiny=tiny, max_new_tokens=MAX_NEW_TOKENS,
                                 device=device, params=params)
        params = model.params
        fleet = EngineFleet(model.cfg, model.params, replicas=REPLICAS,
                            max_replicas=MAX_REPLICAS, slots=model.slots, chunk=chunk,
                            name=FLEET_JOB, register_debug=False, device=device)
        model._engine = fleet
        server = ModelServer()
        server.add(model)
        httpd = server.serve(0)
        try:
            predict = f"http://127.0.0.1:{httpd.port}/v1/models/gpt:predict"
            for h in fleet.live_handles():
                h.engine.prewarm(len(prompt), timeout=600)
            t0 = time.time_ns()
            status, _h, out = post(predict, {"instances": [prompt]})
            assert status == 200, f"predict got {status}: {out}"
            alone = _ttfts(t0, time.time_ns())
            for delay in delays:
                for h in fleet.live_handles():
                    h.engine.step_delay_s = delay
                t0 = time.time_ns()
                with _Traffic(predict, prompt) as traffic:
                    time.sleep(seconds)
                assert traffic.errors == [], traffic.errors
                got = _ttfts(t0, time.time_ns())
                rows.append({"chunk": chunk, "delay_s": delay, "alone_s": alone[0],
                             "n": len(got), "p10_s": _quantile(got, 0.1),
                             "p50_s": _quantile(got, 0.5), "p90_s": _quantile(got, 0.9)})
        finally:
            httpd.close()
            server.close()
            model.close()
    return rows


def _ops_env() -> Dict[str, str]:
    """The ops servers import the port from this checkout, not an install."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    return env


def run(device: DeviceLike = "cuda", tiny: bool = True, params=None,
        model=None) -> Dict[str, Any]:
    from ..monitoring.plane import MonitoringPlane
    from ..monitoring.rules import BurnRateWindow, SLOBurnRateAlert
    from ..monitoring.scrape import (SCRAPE_ANNOTATION, SCRAPE_JOB_ANNOTATION,
                                     SCRAPE_URL_ANNOTATION, parse_exposition)
    from ..runtime.metrics import METRICS
    from ..runtime.obs import mount_observability
    from ..serving.autoscaler import AutoscalerConfig, FederatedWindowSource, SLOAutoscaler
    from ..serving.fleet import EngineFleet
    from ..serving.server import ModelServer, gpt_served_model
    from ..services.dashboard import PlatformViews
    from ..web.http import App
    from .elastic_cluster import NAMESPACE, cluster

    report: Dict[str, Any] = {"ok": True}
    procs: list = []
    closers: list = []
    t_run = time.monotonic()
    try:
        # -- three distinct processes exposing /metrics ----------------------
        for _ in range(OPS_PROCS):  # started first: they boot while we build
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _OPS_SCRIPT], stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, text=True, env=_ops_env()))
        owned = model is None
        if owned:
            model = gpt_served_model(name="gpt", tiny=tiny, max_new_tokens=MAX_NEW_TOKENS,
                                     device=device, params=params)
        else:
            assert model.name == "gpt" and model._engine is None, \
                "a caller's servable must be named gpt and have no engine yet"
        server = ModelServer()
        server.add(model)
        httpd = server.serve(0)
        # ModelServer.close closes its models: a caller's model stays open
        closers += [httpd.close, server.close, model.close] if owned else [httpd.close]
        base = f"http://127.0.0.1:{httpd.port}"

        # -- the fleet's replica Pods advertise the server's /metrics --------
        mgr, client, _sched = cluster([("gpu-node-0", 8)])
        closers.append(mgr.stop)  # after the model: a closing fleet deletes its Pods
        fleet = EngineFleet(model.cfg, model.params, replicas=REPLICAS,
                            max_replicas=MAX_REPLICAS, slots=model.slots,
                            chunk=DECODE_CHUNK, name=FLEET_JOB,
                            client=client, poll_interval=0.05,
                            metrics_url=f"{base}/metrics", device=device)
        model._engine = fleet  # the servable serves through this fleet
        assert fleet.wait_ready(REPLICAS, timeout=120), "the bound replicas never became ready"
        prompt = list(range(1, 9))
        for h in fleet.live_handles():
            # the engines' first device use stays out of the SLO windows, as
            # JAX's engines compile before them
            h.engine.prewarm(len(prompt), timeout=600)

        for i, proc in enumerate(procs):
            line = proc.stdout.readline().strip()
            assert line, f"ops process {i} exited before serving (rc {proc.poll()})"
            client.create({"apiVersion": "v1", "kind": "Pod",
                           "metadata": {"name": f"ops-{i}", "namespace": NAMESPACE,
                                        "annotations": {
                                            SCRAPE_ANNOTATION: "true",
                                            SCRAPE_URL_ANNOTATION:
                                                f"http://127.0.0.1:{int(line)}/metrics",
                                            SCRAPE_JOB_ANNOTATION: "ops"}}})

        plane = MonitoringPlane(client=client, stale_after=3, timeout_s=5.0)
        plane.rules.repeat_s = 1.0  # fast repeat: the dedup assertion needs >=2 emissions
        plane.rules.add(SLOBurnRateAlert(
            name="TtftBurn",
            metric="serving_ttft_seconds",
            threshold_s=TTFT_THRESHOLD_S,
            objective=0.9,
            windows=(BurnRateWindow(short_s=1.5, long_s=4.0, factor=2.0,
                                    severity="page"),),
            for_s=0.2,
        ))

        # -- (1) federation of three processes -------------------------------
        up = plane.scraper.scrape_once()
        assert len(up) == 3 and all(up.values()), f"all targets up: {up}"
        monitor_app = App("monitor")
        mount_observability(monitor_app)
        plane.mount(monitor_app)
        monitor_httpd = monitor_app.serve(0)
        closers.append(monitor_httpd.close)
        fed_url = f"http://127.0.0.1:{monitor_httpd.port}/federate"

        predict = f"{base}/v1/models/gpt:predict"
        t_warm = time.time_ns()
        for _ in range(4):  # warm-up: fast traffic seeds both SLO histograms
            status, _h, out = post(predict, {"instances": [prompt]})
            assert status == 200, f"warm-up got {status}: {out}"
        plane.tick()
        families = parse_exposition(get(fed_url).decode())
        by_name = {f.name: f for f in families}
        assert "workqueue_depth" in by_name, "ops subprocess series federated"
        # this process's scheduler and podlet publish workqueue_depth too
        ops_instances = {s.labels["instance"] for s in by_name["workqueue_depth"].samples
                         if s.labels.get("job") == "ops"}
        assert len(ops_instances) == OPS_PROCS, ops_instances
        assert "serving_ttft_seconds" in by_name, "serving histogram federated"
        bucket = by_name["serving_ttft_seconds"].samples[0]
        assert bucket.labels["job"] == FLEET_JOB
        assert len({s.labels["instance"] for f in families
                    for s in f.samples if "instance" in s.labels}) == 3, \
            "three distinct processes must federate"
        report["setup_s"] = time.monotonic() - t_run
        report["federated_targets"] = sorted(
            lab["instance"] for lab, _t, v in plane.tsdb.latest("up"))
        report["federated_families"] = len(families)

        # -- (2)+(3) burn-rate firing + scrape-backed scale-up ---------------
        autoscaler = SLOAutoscaler(fleet, AutoscalerConfig(
            ttft_slo=TTFT_THRESHOLD_S, queue_wait_slo=10.0, quantile=0.9,
            breach_ticks=2, idle_ticks=10_000, cooldown_ticks=0),
            source=FederatedWindowSource(plane.tsdb))
        cadence = _AutoscalerCadence(autoscaler)
        statuses = plane.tick()
        assert statuses[0]["state"] == "inactive", statuses
        cold = METRICS.histogram("fleet_replica_cold_start_seconds")
        cold_before = (cold.total, cold.sum)
        for handle in fleet.live_handles():  # the chaos monkey's slow_replica knob
            handle.engine.step_delay_s = STEP_DELAY_S
        t_slow, t_slow_ns = time.monotonic(), time.time_ns()
        with _Traffic(predict, prompt) as slow_traffic:
            statuses = _tick_until(
                plane, lambda ss: ss[0]["state"] == "firing", 45.0,
                "burn-rate alert to fire", cadence=cadence)
            report["fired_after_s"] = time.monotonic() - t_slow
            report["fire_tick"] = plane.rules.evaluations
            report["burn_short_at_fire"] = statuses[0]["burn_short"]
            # keep ticking while firing: emissions must AGGREGATE
            _tick_until(plane,
                        lambda ss: _events(client, "TtftBurn")
                        and _events(client, "TtftBurn")[0]["count"] >= 2,
                        20.0, "deduplicated Event count to climb", cadence=cadence)
            _tick_until(plane, lambda ss: fleet.desired_replicas == 3, 60.0,
                        "scrape-backed scale-up 2 -> 3", cadence=cadence)
        t_fast_ns = time.time_ns()
        assert slow_traffic.errors == [], slow_traffic.errors
        firing_events = _events(client, "TtftBurn")
        assert len(firing_events) == 1, \
            f"firing must dedup to ONE Event, got {len(firing_events)}"
        assert firing_events[0]["count"] >= 2
        assert firing_events[0]["type"] == "Warning"
        assert autoscaler.last["source"] == "federated"
        fleet_doc = json.loads(get(f"{base}/debug/fleet"))
        assert fleet_doc["desired_replicas"] == 3, fleet_doc
        report["event_count"] = firing_events[0]["count"]
        report["autoscaled_to"] = fleet_doc["desired_replicas"]
        report["autoscaler_source"] = autoscaler.last["source"]
        report["slow_requests"] = slow_traffic.sent

        # -- (2b) recovery resolves the alert --------------------------------
        assert fleet.wait_ready(MAX_REPLICAS, timeout=120), "the new replica never became ready"
        report["scale_up_cold_start_s"] = (
            (cold.sum - cold_before[1]) if cold.total == cold_before[0] + 1 else None)
        for handle in fleet.live_handles():
            handle.engine.step_delay_s = 0.0
        t_fast = time.monotonic()
        with _Traffic(predict, prompt) as fast_traffic:
            statuses = _tick_until(
                plane, lambda ss: ss[0]["state"] == "resolved", 45.0,
                "burn-rate alert to resolve")
            report["resolved_after_s"] = time.monotonic() - t_fast
            report["resolve_tick"] = plane.rules.evaluations
        t_end_ns = time.time_ns()
        assert fast_traffic.errors == [], fast_traffic.errors
        assert METRICS.value("alerts_firing", alertname="TtftBurn",
                             severity="page") == 0.0
        resolved = _events(client, "TtftBurnResolved")
        assert len(resolved) == 1 and resolved[0]["type"] == "Normal"
        report["resolved"] = True
        report["fast_requests"] = fast_traffic.sent
        report["ttft_warm_p50_s"] = _ttft_p50(t_warm, t_slow_ns)
        report["ttft_slow_p50_s"] = _ttft_p50(t_slow_ns, t_fast_ns)
        report["ttft_fast_p50_s"] = _ttft_p50(t_fast_ns, t_end_ns)

        # -- (4) the platform overview speaks federated data -----------------
        doc = PlatformViews(plane).platform_overview(window_s=30.0)
        assert len(doc["targets"]) == 3, doc["targets"]
        assert all(t["up"] == 1.0 for t in doc["targets"]), doc["targets"]
        assert doc["serving"]["ttftP99"] is not None, \
            "platform p99 must come from federated data"
        report["platform_ttft_p99"] = doc["serving"]["ttftP99"]
        report["seconds"] = time.monotonic() - t_run
        return report
    finally:
        for proc in procs:
            try:
                proc.stdin.close()
            except OSError:
                pass
        for close in closers:
            try:
                close()
            except Exception:  # best-effort teardown
                pass
        for proc in procs:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--tiny", action="store_true", help="GPT-tiny (default GPT-small)")
    parser.add_argument("--ttft-table", action="store_true",
                        help="print ttft_table()'s rows (one JSON line each) instead")
    args = parser.parse_args(argv)
    if args.ttft_table:
        for row in ttft_table(device=args.device, tiny=args.tiny):
            print(json.dumps(row), flush=True)
        return 0
    try:
        report = run(device=args.device, tiny=args.tiny)
    except AssertionError as e:
        import traceback

        traceback.print_exc(file=sys.stderr)
        print(json.dumps({"ok": False, "error": str(e)}))
        return 1
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
