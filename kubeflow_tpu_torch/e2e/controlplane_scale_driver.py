"""Control-plane scale e2e: a seeded synthetic GPU topology driven over
REAL HTTP — the port of ``e2e/controlplane_scale_driver.py``.

Boots a ``Store`` and the apiserver app on a real listener with the gang
scheduler and the podlet reconciling in-process, then through
``scale.loadgen.LoadGenerator``:

1. registers a seeded ``scale.topology.synthesize(nodes)`` topology and
   submits two gang-arrival waves of ``WAVE_GANGS`` gangs, waiting for every
   pod to bind;
2. submits one DOOMED gang (cards a pod beyond any node) into the largest
   pool and asserts the flight recorder's verdict list is truncated: at
   most ``VERDICT_TOP_K`` exact rows plus aggregated ``...and N more
   nodes: reason`` summaries, never one row per node;
3. runs a watch storm (concurrent NDJSON streams and mass relists), pod
   churn and node kills (``LoadGenerator.kill_nodes``) between two scrapes;
4. scrapes ``/metrics`` directly (bind-latency histogram populated, watch
   fanout counter moved, cycles/sec gauge live) AND through
   ``monitoring.scrape.Scraper`` into a ``monitoring.tsdb.TSDB``,
   asserting the SLIs are queryable: ``scheduler_cycles_per_sec`` latest,
   a windowed ``histogram_quantile`` over
   ``scheduler_bind_latency_seconds`` and the storm's
   ``apiserver_request_seconds{verb="list"}``, and
   ``workqueue_saturation`` per queue.

JAX's defaults (500 nodes, 6 gangs a wave, top-k 8); the node count is
an argument (``--nodes``). It imports no torch.
``python -m kubeflow_tpu_torch.e2e.controlplane_scale_driver`` prints the
report as one JSON line and exits 0, or prints ``{"ok": false, "error":
...}`` and exits 1; CPU-only.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.request
from typing import Any, Dict, List, Optional

from .control_plane_driver import _metric_value, _poll

SEED = 11
SCALE_NODES = 500
WAVE_GANGS = 6
VERDICT_TOP_K = 8


def run(nodes: int = SCALE_NODES) -> Dict[str, Any]:
    from ..apiserver.server import make_apiserver_app
    from ..apiserver.store import Store
    from ..controllers.builtin import PodletReconciler
    from ..monitoring.scrape import Scraper, Target
    from ..monitoring.tsdb import TSDB
    from ..runtime.manager import Manager
    from ..scale.loadgen import LoadGenerator
    from ..scale.topology import GangShape, synth_gangs, synthesize
    from ..scheduler.core import SchedulerReconciler

    topo = synthesize(nodes, seed=SEED)
    store = Store()
    mgr = Manager(store)
    mgr.add(SchedulerReconciler(assembly_timeout=10.0, reservation_ttl=5.0, backoff_base=0.05,
                                backoff_cap=0.5, verdict_top_k=VERDICT_TOP_K))
    mgr.add(PodletReconciler())
    app = make_apiserver_app(store)
    httpd = app.serve(0)
    base = f"http://127.0.0.1:{httpd.port}"
    mgr.start()
    try:
        gen = LoadGenerator(base, topo, seed=SEED)
        t0 = time.monotonic()
        registered = gen.register_nodes()
        assert registered == topo.total_nodes, (registered, topo.total_nodes)
        register_s = time.monotonic() - t0

        tsdb = TSDB()
        scraper = Scraper(tsdb, targets=[Target(job="apiserver", url=f"{base}/metrics")])

        # -- wave 1: seeded gang arrivals, all must bind ----------------------
        t0 = time.monotonic()
        shapes = synth_gangs(topo, WAVE_GANGS, seed=SEED, prefix="wave1", max_size=6)
        gen.gang_wave(shapes)
        gen.wait_gangs_bound([s.name for s in shapes], timeout_s=90.0)
        wave1_s = time.monotonic() - t0

        up = scraper.scrape_once()  # baseline points: windowed increase needs two
        assert all(up.values()), f"monitoring scrape must reach the apiserver: {up}"

        # -- wave 2 + storm between the two scrapes ---------------------------
        t0 = time.monotonic()
        wave2 = synth_gangs(topo, WAVE_GANGS, seed=SEED + 1, prefix="wave2", max_size=6)
        gen.gang_wave(wave2)
        gen.wait_gangs_bound([s.name for s in wave2], timeout_s=90.0)
        wave2_s = time.monotonic() - t0

        storm = gen.watch_storm(streams=8, relists=24, duration_s=1.5)
        assert storm["lists"] >= 24 and storm["watch_events"] > 0, storm
        churned = gen.churn_pods(0.25)
        killed = gen.kill_nodes(max(1, topo.total_nodes // 100))

        # -- doomed gang: force verdict truncation over a big pool ------------
        big_pool = max(topo.pools, key=lambda p: p.nodes)
        assert big_pool.nodes > VERDICT_TOP_K, "need a pool larger than top_k"
        doomed = GangShape(name="doomed", size=2, chips_per_pod=big_pool.chips_per_node * 4,
                           selector=big_pool.selector())
        gen.submit_gang(doomed)

        def truncated_decision():
            doc = gen._get("/debug/scheduler?gang=default/doomed&limit=64")
            hits = [d for d in doc["decisions"] if d["outcome"] == "unschedulable"]
            return hits[-1] if hits else None

        decision = _poll(truncated_decision, timeout=30.0,
                         desc="unschedulable decision for default/doomed")
        verdicts = decision.get("nodes") or []
        summaries = [v for v in verdicts if v.get("truncated")]
        exact = [v for v in verdicts if not v.get("truncated")]
        assert summaries, f"verdicts must carry an aggregated tail: {verdicts[:3]}"
        assert len(exact) <= VERDICT_TOP_K, \
            f"flight recorder kept {len(exact)} exact verdicts (top_k={VERDICT_TOP_K})"
        truncated_total = sum(v["truncated"] for v in summaries)
        assert len(exact) + truncated_total >= big_pool.nodes - 1, \
            "summary counts must cover the whole candidate pool"
        # dominant reason and message were derived from the FULL verdict
        # list before truncation: they stay exact
        assert decision.get("reason") and decision.get("message"), decision

        # -- /metrics direct: the SLIs exist at the source --------------------
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as resp:
            text = resp.read().decode()
        bind_count = _metric_value(text, "scheduler_bind_latency_seconds_count")
        assert bind_count >= WAVE_GANGS * 2, \
            f"bind-latency histogram must cover both waves (count={bind_count})"
        cycles = _metric_value(text, "scheduler_cycles_per_sec")
        assert cycles > 0, "cycles/sec gauge must be live while reconciling"
        assert _metric_value(text, "apiserver_watch_events_sent_total") > 0
        assert _metric_value(text, "workqueue_saturation", queue="SchedulerReconciler") >= 0
        assert _metric_value(text, "apiserver_request_seconds_count", verb="list",
                             resource="pods") > 0

        # -- the scraped TSDB: the SLIs are queryable after federation --------
        up = scraper.scrape_once()
        assert all(up.values()), f"second scrape must succeed: {up}"
        now = time.time()
        assert tsdb.latest("scheduler_cycles_per_sec"), "TSDB must hold the cycles/sec gauge"
        bind_p99 = tsdb.histogram_quantile("scheduler_bind_latency_seconds", 0.99, 600.0, now)
        assert bind_p99 is not None and bind_p99 >= 0.0, bind_p99
        list_p99 = tsdb.histogram_quantile("apiserver_request_seconds", 0.99, 600.0, now,
                                           matchers={"verb": "list"})
        assert list_p99 is not None and list_p99 >= 0.0, \
            "storm list latency must be queryable from the TSDB"
        saturation = tsdb.latest("workqueue_saturation")
        assert any(lbl.get("queue") == "SchedulerReconciler" for lbl, _ts, _v in saturation), \
            saturation

        return {
            "ok": True,
            "nodes": topo.total_nodes,
            "pools": len(topo.pools),
            "gangs_bound": len(shapes) + len(wave2),
            "storm": storm,
            "churned": churned,
            "killed": len(killed),
            "verdicts_exact": len(exact),
            "verdicts_truncated": truncated_total,
            "bind_count": bind_count,
            "cycles_per_sec": cycles,
            "bind_p99_s": round(bind_p99, 4),
            "list_p99_s": round(list_p99, 6),
            "seconds": {"register": register_s, "wave1": wave1_s, "wave2": wave2_s},
        }
    finally:
        httpd.close()
        mgr.stop()


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--nodes", type=int, default=SCALE_NODES)
    args = parser.parse_args(argv)
    try:
        report = run(nodes=args.nodes)
    except AssertionError as e:
        print(json.dumps({"ok": False, "error": str(e)}))
        return 1
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
