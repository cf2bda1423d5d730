"""Serving-fleet e2e over real HTTP: the port of ``e2e/fleet_driver.py``.

Serves a GPT ``GenerativeModel`` (seeded weights, paged arena) whose engine
is an ``EngineFleet`` of ``REPLICAS`` replicas of ``SLOTS`` slots behind
``ModelServer`` on port 0, then:

1. **Prefix affinity** — the same prompt POSTed repeatedly returns the same
   greedy completion; ``fleet_prefix_hits_total`` > 0 on ``/metrics``,
   ``/debug/fleet`` shows exactly one replica holding the warm prefix, and
   the engine gauges carry ``replica`` labels.
2. **SLO autoscaling** — a synthetic TTFT breach in the SLO histogram and
   a ticked ``SLOAutoscaler`` scale the fleet 3 → 4 (seen over HTTP in
   ``/debug/fleet``), and idle ticks scale it back down
   (``fleet_autoscale_total`` up/slo_breach and down/idle).
3. **Drain** — a burst of same-prefix requests from threads piles up on one
   replica, which is drained mid-burst: every response is 200 with the
   reference completion, ``fleet_requeued_total`` counts at least the
   re-queued requests, and ``fleet_drain_seconds`` has a sample.

``run(device=..., tiny=True)`` returns the report (JAX's keys); ``tiny``
is JAX's GPT-tiny, ``tiny=False`` GPT-small. ``main`` prints the report as
one JSON line and exits 0, or prints ``{"ok": false, "error": ...}`` and
exits 1. On the card: ``python -m kubeflow_tpu_torch.e2e.fleet_driver``.
"""

from __future__ import annotations

import json
import sys
import threading
from typing import Any, Dict

from ..device import DeviceLike
from ._http import get, metric_value, poll, post

REPLICAS = 3
MAX_REPLICAS = 4
SLOTS = 2
BURST = 8
BUDGET = 24


def _predict(url: str, prompt: list) -> list:
    status, _h, out = post(url, {"instances": [prompt]})
    assert status == 200, f"predict got {status}: {out}"
    return out["predictions"][0]


def run(device: DeviceLike = "cuda", tiny: bool = True) -> Dict[str, Any]:
    from ..runtime.metrics import METRICS
    from ..serving.autoscaler import AutoscalerConfig, SLOAutoscaler
    from ..serving.continuous import TTFT_BUCKETS
    from ..serving.server import ModelServer, gpt_served_model

    model = gpt_served_model(name="gpt", tiny=tiny, max_new_tokens=BUDGET,
                             replicas=REPLICAS, device=device)
    model.max_replicas = MAX_REPLICAS
    model.slots = SLOTS
    server = ModelServer()
    server.add(model)
    fleet = model.engine()
    httpd = server.serve(0)
    base = f"http://127.0.0.1:{httpd.port}"
    report: Dict[str, Any] = {"ok": True}
    try:
        prompt = list(range(1, 9))
        url = f"{base}/v1/models/gpt:predict"

        # -- (a) prefix affinity over HTTP -----------------------------------
        reference = None
        for _ in range(6):
            out = _predict(url, prompt)
            if reference is None:
                reference = out
            assert out == reference, "greedy decode must be deterministic"
        text = get(f"{base}/metrics").decode()
        hits = metric_value(text, "fleet_prefix_hits_total")
        assert hits > 0, f"fleet_prefix_hits_total={hits}"
        assert 'serving_queue_depth{replica="' in text, \
            "engine gauges must carry the replica label"
        fleet_doc = json.loads(get(f"{base}/debug/fleet"))
        assert fleet_doc["desired_replicas"] == REPLICAS, fleet_doc
        warm = [r for r in fleet_doc["replicas"] if r["warm_prefixes"] > 0]
        assert len(warm) == 1, f"one replica must own the warm prefix, got {len(warm)}"
        report["prefix_hits"] = hits
        report["warm_replica"] = warm[0]["id"]

        # -- (b) SLO breach scales up; idle scales down ----------------------
        autoscaler = SLOAutoscaler(fleet, AutoscalerConfig(
            ttft_slo=0.5, queue_wait_slo=10.0, quantile=0.99,
            breach_ticks=2, idle_ticks=2, cooldown_ticks=1))
        autoscaler.tick()  # baseline snapshot
        ttft = METRICS.histogram("serving_ttft_seconds", buckets=TTFT_BUCKETS)
        decisions = []
        for _ in range(3):  # synthetic breach: p99 far past the 0.5 s SLO
            ttft.observe(3.0, count=20)
            decisions.append(autoscaler.tick())
        assert "up" in decisions, f"breach must scale up: {decisions}"
        fleet_doc = json.loads(get(f"{base}/debug/fleet"))
        assert fleet_doc["desired_replicas"] == REPLICAS + 1, \
            f"expected scale-up to {REPLICAS + 1}: {fleet_doc['desired_replicas']}"
        for _ in range(4):  # no traffic: the windows go idle
            decisions.append(autoscaler.tick())
        assert "down" in decisions, f"idle must scale down: {decisions}"
        fleet_doc = json.loads(get(f"{base}/debug/fleet"))
        assert fleet_doc["desired_replicas"] <= REPLICAS, fleet_doc
        text = get(f"{base}/metrics").decode()
        assert metric_value(text, "fleet_autoscale_total",
                            direction="up", reason="slo_breach") >= 1
        assert metric_value(text, "fleet_autoscale_total",
                            direction="down", reason="idle") >= 1
        report["autoscale_decisions"] = [d for d in decisions if d]

        # -- (c) drain mid-burst: zero dropped requests ----------------------
        results: list = [None] * BURST
        errors: list = [None] * BURST

        def fire(i: int) -> None:
            try:
                results[i] = _predict(url, prompt)
            except Exception as e:  # recorded, asserted below
                errors[i] = str(e)

        threads = [threading.Thread(target=fire, args=(i,)) for i in range(BURST)]
        for t in threads:
            t.start()

        def loaded_replica():
            for h in fleet.live_handles():
                if METRICS.value("serving_queue_depth", replica=h.gauge_id) >= 2:
                    return h
            return None

        victim = poll(loaded_replica, timeout=30.0, interval=0.01,
                      desc="a replica with queued pendings")
        requeued = fleet.drain_replica(victim.id, reason="e2e_drain")
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads), "burst clients hung"
        assert all(e is None for e in errors), f"failed requests: {errors}"
        assert all(r == reference for r in results), \
            "every drained/re-queued request must return the exact greedy completion"
        text = get(f"{base}/metrics").decode()
        assert requeued > 0, "the drain must have handed off pending requests"
        assert metric_value(text, "fleet_requeued_total") >= requeued
        assert metric_value(text, "fleet_drain_seconds_count") >= 1
        report["drained_replica"] = victim.gauge_id
        report["requeued"] = requeued
        report["burst_ok"] = len(results)
        return report
    finally:
        httpd.close()
        server.close()
        model.close()


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
