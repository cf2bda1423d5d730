"""Serving overload protection over real HTTP: the port of
``e2e/overload_driver.py``.

Serves a GPT ``GenerativeModel`` (seeded weights, paged arena) whose engine
is an ``EngineFleet`` of ``REPLICAS`` replicas (``SLOTS`` slots each,
bounded admission queues) behind ``ModelServer`` on port 0, and drives it
past saturation and through faults fired by the port's ``ChaosMonkey``:

1. **Determinism baseline** — the same prompt POSTed repeatedly returns the
   same greedy completion.
2. **Deadline fast-fail** — an already-expired ``X-Request-Deadline-Ms``
   comes back 504 in under 5 s; nothing occupies a slot.
3. **Priority shedding under flood** — ``FLOOD`` concurrent
   ``priority=batch`` POSTs (2.22x the batch-admissible capacity) beside
   interactive clients: batch sheds with 503 + ``Retry-After`` >= 1 while
   every interactive request returns 200
   (``serving_shed_total{priority="interactive"}`` stays 0).
4. **Client abandonment** — ``client_abandon`` cancels a burst mid-decode
   on slowed replicas; ``serving_cancelled_total`` counts it.
5. **Breaker cycle** — ``slow_replica`` on one replica and 700 ms
   deadlines drive consecutive expiries until its breaker OPENS
   (``fleet_breaker_state`` 1); the survivors keep serving, and once the
   fault lifts a probe re-CLOSES the breaker (gauge 0).
6. **Crash survival** — ``crash_replica_mid_decode`` poisons a replica,
   which closes; a burst of 8 still returns all 200.
7. **Reclamation** — every live replica's queue and slots drain to 0, and
   ``serving_deadline_expired_total`` >= 1.

Every replica is prewarmed before step 1 (the engines' first device use
is outside the timed steps, as JAX's engines compile before them).
``run(device=..., tiny=True)`` returns the report (JAX's keys); ``tiny`` is
JAX's GPT-tiny, ``tiny=False`` GPT-small; ``params`` serves weights the
caller built (``init_params`` of that config). ``main`` prints the report as
one JSON line and exits 0, or prints ``{"ok": false, "error": ...}`` and
exits 1. On the card: ``python -m kubeflow_tpu_torch.e2e.overload_driver``.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from typing import Any, Dict

from ..device import DeviceLike
from ._http import get, metric_value, poll, post

REPLICAS = 3
SLOTS = 2
BUDGET = 24
#: engine-side admission cap (per replica) and interactive reserve
MAX_PENDING = 8
ENGINE_RESERVE = 0.5
#: router-side queue-depth cap and interactive reserve: batch saturates
#: at depth 2, interactive at 8
ROUTER_DEPTH = 8
ROUTER_RESERVE = 0.75
#: batch-admissible concurrency = slots + engine batch cap, per replica
BATCH_CAPACITY = REPLICAS * (SLOTS + int(MAX_PENDING * (1 - ENGINE_RESERVE)))
#: flood at ~2.2x that capacity
FLOOD = 40
INTERACTIVE_CLIENTS = 4


def run(device: DeviceLike = "cuda", tiny: bool = True, params=None) -> Dict[str, Any]:
    from ..runtime.chaos import ChaosMonkey, ChaosSchedule, Fault
    from ..serving.continuous import ContinuousBatcher
    from ..serving.fleet import EngineFleet, ReplicaBreaker
    from ..serving.router import PrefixRouter
    from ..serving.server import ModelServer, gpt_served_model

    model = gpt_served_model(name="gpt", tiny=tiny, max_new_tokens=BUDGET, device=device,
                             params=params)

    def engine_factory(engine_id: str):
        return ContinuousBatcher(model.cfg, model.params, slots=SLOTS, chunk=8, pipeline=2,
                                 engine_id=engine_id, max_pending=MAX_PENDING,
                                 interactive_reserve=ENGINE_RESERVE, device=device)

    fleet = EngineFleet(
        replicas=REPLICAS, max_replicas=REPLICAS, name="gpt",
        engine_factory=engine_factory,
        router=PrefixRouter(max_queue_depth=ROUTER_DEPTH, interactive_reserve=ROUTER_RESERVE),
        breaker_factory=lambda: ReplicaBreaker(failure_threshold=2, open_s=2.0),
        device=device)
    model._engine = fleet  # the servable serves through this fleet
    server = ModelServer()
    server.add(model)
    httpd = server.serve(0)
    base = f"http://127.0.0.1:{httpd.port}"
    url = f"{base}/v1/models/gpt:predict"
    monkey = ChaosMonkey(None, ChaosSchedule([]), fleet=fleet)
    report: Dict[str, Any] = {"ok": True,
                              "saturation_factor": round(FLOOD / BATCH_CAPACITY, 2)}
    try:
        warm = list(range(1, 9))
        for h in fleet.live_handles():
            h.engine.prewarm(len(warm), timeout=600)

        # -- (1) determinism baseline ---------------------------------------
        reference = None
        for _ in range(4):
            status, _h, out = post(url, {"instances": [warm]})
            assert status == 200, f"warmup got {status}: {out}"
            if reference is None:
                reference = out["predictions"][0]
            assert out["predictions"][0] == reference, "greedy decode must be deterministic"

        # -- (2) an already-expired deadline 504s fast ----------------------
        t0 = time.monotonic()
        status, _h, out = post(url, {"instances": [warm]},
                               headers={"X-Request-Deadline-Ms": "0"})
        elapsed = time.monotonic() - t0
        assert status == 504, f"expired deadline got {status}: {out}"
        assert elapsed < 5.0, f"DOA deadline took {elapsed:.1f}s to fail"
        report["doa_504_s"] = round(elapsed, 3)

        # -- (3) mixed-priority flood at ~2.2x batch capacity ---------------
        results: list = [None] * (FLOOD + INTERACTIVE_CLIENTS * 2)

        def batch_client(i: int) -> None:
            body = {"instances": [[10 + i] * 8], "priority": "batch", "timeout_ms": 60000}
            results[i] = post(url, body)

        def interactive_client(j: int) -> None:
            for k in range(2):
                body = {"instances": [[200 + j] * 8], "priority": "interactive",
                        "timeout_ms": 120000}
                results[FLOOD + j * 2 + k] = post(url, body)

        threads = [threading.Thread(target=batch_client, args=(i,)) for i in range(FLOOD)]
        for j in range(INTERACTIVE_CLIENTS):
            threads.append(threading.Thread(target=interactive_client, args=(j,)))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        hung = [t.name for t in threads if t.is_alive()]
        assert not hung, f"hung client threads: {hung}"
        assert all(r is not None for r in results), "a client died mid-POST"
        batch_statuses = [r[0] for r in results[:FLOOD]]
        inter_statuses = [r[0] for r in results[FLOOD:]]
        shed = [r for r in results[:FLOOD] if r[0] == 503]
        assert shed, f"flood at 2x capacity must shed batch: {batch_statuses}"
        for _s, hdrs, _b in shed:
            retry_after = hdrs.get("Retry-After")
            assert retry_after is not None and int(retry_after) >= 1, \
                f"503 must carry Retry-After, got headers {hdrs}"
        assert all(s == 200 for s in inter_statuses), \
            f"interactive must never shed while batch does: {inter_statuses}"
        text = get(f"{base}/metrics").decode()
        assert metric_value(text, "serving_shed_total", priority="batch") > 0
        assert metric_value(text, "serving_shed_total", priority="interactive") == 0
        report["flood"] = {"batch_200": batch_statuses.count(200),
                           "batch_503": batch_statuses.count(503),
                           "interactive_200": inter_statuses.count(200)}

        # -- (4) client abandonment frees slots -----------------------------
        for h in fleet.live_handles():  # slow every replica so the burst is
            monkey.inject(Fault(at=0.0, kind="slow_replica",  # still in flight
                                target=h.gauge_id, param=0.5, duration=4.0))
        aband: list = [None] * 4

        def abandoned_client(i: int) -> None:
            aband[i] = post(url, {"instances": [[60 + i] * 8], "priority": "batch",
                                  "timeout_ms": 60000})

        ats = [threading.Thread(target=abandoned_client, args=(i,)) for i in range(len(aband))]
        for t in ats:
            t.start()
        time.sleep(0.4)  # let them admit and start decoding
        monkey.inject(Fault(at=0.0, kind="client_abandon", param=len(aband)))
        for t in ats:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ats), "abandoned clients hung"
        poll(lambda: all(h.engine.step_delay_s == 0.0 for h in fleet.live_handles()),
             timeout=15.0, desc="slow_replica faults to expire")
        text = get(f"{base}/metrics").decode()
        cancelled = metric_value(text, "serving_cancelled_total")
        assert cancelled >= 1, f"serving_cancelled_total={cancelled}"
        report["abandoned"] = {"cancelled": cancelled, "statuses": [a[0] for a in aband]}

        # -- (5) the breaker opens on a slowed replica, then re-closes ------
        victim = fleet.live_handles()[0].gauge_id
        monkey.inject(Fault(at=0.0, kind="slow_replica", target=victim,
                            param=1.0, duration=8.0))
        pd = [77] * 8  # a fresh prompt: ties route it to the victim first,
        opened = False  # then prefix affinity keeps it there
        deadline_statuses = []
        for _ in range(6):
            status, _h, _b = post(url, {"instances": [pd]},
                                  headers={"X-Request-Deadline-Ms": "700"})
            deadline_statuses.append(status)
            state = metric_value(get(f"{base}/metrics").decode(),
                                 "fleet_breaker_state", replica=victim)
            if state == 1.0:
                opened = True
                break
        assert opened, f"breaker never opened; deadline statuses={deadline_statuses}"
        # while open: the fleet routes around the victim
        status, _h, out = post(url, {"instances": [[88] * 8]})
        assert status == 200, f"survivors must serve during open: {out}"
        fleet_doc = json.loads(get(f"{base}/debug/fleet"))
        assert any(r["id"] == victim and r["breaker"] == "open"
                   for r in fleet_doc["replicas"]), fleet_doc["replicas"]
        # the fault lifts: probe traffic half-opens, then re-closes the breaker
        poll(lambda: all(h.engine.step_delay_s == 0.0 for h in fleet.live_handles()),
             timeout=15.0, desc="victim replica to recover")
        probe_token = [0]

        def breaker_closed():
            probe_token[0] += 1
            post(url, {"instances": [[100 + probe_token[0]] * 8]})
            return metric_value(get(f"{base}/metrics").decode(),
                                "fleet_breaker_state", replica=victim) == 0.0

        poll(breaker_closed, timeout=30.0, interval=0.4,
             desc="breaker to re-close after recovery")
        report["breaker"] = {"victim": victim, "opened": True, "reclosed": True,
                             "deadline_statuses": deadline_statuses}

        # -- (6) crash survival ---------------------------------------------
        crashed = fleet.live_handles()[-1]
        crash_target = crashed.gauge_id
        monkey.inject(Fault(at=0.0, kind="crash_replica_mid_decode", target=crash_target))
        # the fault fired: the target refuses work before the burst, so the
        # fleet must route around it
        poll(lambda: crashed.engine.closed, timeout=15.0, desc="the crashed replica to close")
        crash_burst: list = [None] * 8

        def crash_client(i: int) -> None:
            crash_burst[i] = post(url, {"instances": [[150 + i] * 8], "timeout_ms": 120000})

        cts = [threading.Thread(target=crash_client, args=(i,))
               for i in range(len(crash_burst))]
        for t in cts:
            t.start()
        for t in cts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in cts), "crash-burst clients hung"
        crash_statuses = [c[0] for c in crash_burst]
        assert all(s == 200 for s in crash_statuses), \
            f"fleet must serve through a replica crash: {crash_statuses}"
        report["crash"] = {"target": crash_target, "burst_200": len(cts)}

        # -- (7) every slot and queue reclaimed, counters coherent ----------
        def drained():
            doc = json.loads(get(f"{base}/debug/fleet"))
            live = [r for r in doc["replicas"] if r["state"] in ("pending", "ready")]
            return all(r["queue_depth"] == 0 and r["active_slots"] == 0 for r in live)

        poll(drained, timeout=30.0, desc="all queues and slots to drain")
        text = get(f"{base}/metrics").decode()
        expired = metric_value(text, "serving_deadline_expired_total")
        assert expired >= 1, f"serving_deadline_expired_total={expired}"
        assert metric_value(text, "serving_shed_total", priority="interactive") == 0
        assert metric_value(text, "fleet_breaker_state", replica=victim) == 0.0
        report["deadline_expired_total"] = expired
        return report
    finally:
        monkey.stop()
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
