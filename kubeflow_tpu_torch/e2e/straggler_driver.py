"""Straggler-plane e2e: detect, forensically dump, quarantine, reshard.

The port of ``e2e/straggler_driver.py``. The composed-4D GPT
(``CompositeConfig(n_layers=8, vocab_size=64)``) trains through
``ElasticTrainer`` in a world of 8 ranks (gloo processes on the CPU,
standing for JAX's 8 virtual devices; one rank a card with ``--device
cuda``) as a gang of 4 pods x 2 cards on three nodes of 4 cards. Rank 0
holds the cluster (``elastic_cluster.cluster``: the port's store, gang
scheduler and podlet) and the monitoring plane:

1. an uninterrupted REFERENCE run on the same seeds records the loss curve;
2. in the chaos run, rank 0 publishes a :class:`WorkerBeacon` from inside
   its step (the gang's pacing, ``STEP_PACING`` a step, under the step's
   ``collective_wait`` phase) and three sibling threads heartbeat beside
   it: a gang of four beacons, federated through a real HTTP scrape of
   rank 0's ``/metrics`` (an annotated Pod) into a ``MonitoringPlane``'s
   TSDB, with the straggler rules (the skew recording rule and the
   step-latency burn-rate alert), a ``TraceCollector`` and a
   ``StragglerDetector`` ticking every ``TICK_S``;
3. a sibling slowed x5 (the beacon's ``slow_factor``, what JAX's
   ``slow_worker`` sets) must be flagged within the k-of-n window budget;
   then another wedged (``wedge()``, JAX's ``wedge_worker``): the detector
   mints a hang verdict, the ``/debug/stacks`` ring holds an all-thread
   dump naming the wedged frame (``_wedge_wait``), the verdict attaches to
   the gang's federated bind trace, the hosting node is quarantined (the
   scheduler's ledger cordons it) and the gang drained;
4. ``ElasticTrainer`` acks, saves and takes a new gang, which the
   scheduler's quarantine predicate keeps off the node, and finishes with
   loss parity against the reference; a 4-card probe, which then fits only
   on the quarantined node, is flight-recorded ``quarantined``.

Both detection times run from the moment the fault took effect: the
slowed sibling's first step at the stretched pacing, and the wedged
sibling's last step before it parked. ``straggler_detect_seconds`` /
``hang_detect_seconds`` are printed as metric lines, as JAX's.

``python -m kubeflow_tpu_torch.e2e.straggler_driver [--device cuda|cpu]
[--ranks N]`` (one rank a card by default, 8 on the CPU) prints the
metric lines and the summary, and exits 0, or prints ``{"ok": false,
"error": ...}`` and exits 1.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
import urllib.request
from typing import Any, Dict, Optional

from .elastic_cluster import (NAMESPACE, cluster, driver_main, gang_pod, poll, run_in_world,
                              running)

TOTAL_STEPS = 32
CKPT_EVERY = 8
GRACE_SECONDS = 20.0
#: the gang: 4 single-worker pods x 2 cards over 3 nodes x 4 cards, so
#: quarantining any one node still leaves exactly enough for a reshard
PODS = 4
#: per-step pacing every beacon applies (the simulated collective): the
#: skew baseline chaos stretches
STEP_PACING = 0.4
SKEW_FACTOR = 3.0
SLOW_FACTOR = 5.0
K, N = 3, 5
TICK_S = 0.25
HANG_DEADLINE = 4.0
#: detection budgets: k-of-n windows at the tick cadence (+ publish +
#: federation slack) for skew; the deadline itself + slack for hangs
STRAGGLER_BUDGET_S = N * TICK_S + 5.0
HANG_BUDGET_S = HANG_DEADLINE + 5.0
LOSS_PARITY_TOL = 1e-3
RANKS = 8


class SliceRequester:
    """Rank 0's gang acquisition against the scheduler; a re-request
    releases the previous (drained) gang first, recording the acks its
    pods carry, the way a job controller recreates its pod group."""

    def __init__(self, client, ranks: int):
        self.client = client
        self.ranks = ranks
        self.gen = 0
        self.current_pods: list = []
        self.acks: list = []

    def __call__(self, attempt: int):
        from ..scheduler.gang import DRAIN_ACK_ANNOTATION, annotations_of
        from ..training.elastic import SliceOffer

        acks = []
        for n in self.current_pods:
            pod = self.client.get_opt("v1", "Pod", n, NAMESPACE)
            ack = annotations_of(pod).get(DRAIN_ACK_ANNOTATION) if pod else None
            if ack is not None:
                acks.append(ack)
            self.client.delete_opt("v1", "Pod", n, NAMESPACE)
        self.acks.append(acks)
        self.gen += 1
        gang = f"train-g{self.gen}"
        names = [f"{gang}-{i}" for i in range(PODS)]
        for n in names:
            self.client.create(gang_pod(n, gang, PODS, self.ranks // PODS, "trial",
                                        grace=GRACE_SECONDS))
        poll(lambda: running(self.client, names), timeout=60.0, desc=f"gang {gang} running")
        self.current_pods = names
        return SliceOffer(devices=list(range(self.ranks)), pp=4, pods=names,
                          namespace=NAMESPACE)

    def binding(self) -> Dict[str, Optional[str]]:
        return {n: ((self.client.get_opt("v1", "Pod", n, NAMESPACE) or {}).get("spec") or {})
                .get("nodeName") for n in self.current_pods}


class _Sibling:
    """One simulated gang member: throttle (pacing + chaos interposition)
    then publish, until stopped. It notes when a fault took effect: the
    start of its first step at a stretched pacing, and the end of its last
    step before it parked."""

    def __init__(self, beacon, stop: threading.Event) -> None:
        self.beacon = beacon
        self.stop = stop
        self.slowed_at: Optional[float] = None
        self.last_step_at: Optional[float] = None

    def run(self) -> None:
        step = 0
        while not self.stop.is_set():
            t0 = time.perf_counter()
            if self.slowed_at is None and self.beacon.slow_factor > 1.0:
                self.slowed_at = time.time()
            wait = self.beacon.throttle()
            self.beacon.publish({"total": time.perf_counter() - t0, "collective_wait": wait},
                                step)
            if not self.beacon.wedged:
                self.last_step_at = time.time()
            step += 1


def _http_json(port: int, path: str) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5.0) as resp:
        return json.loads(resp.read().decode("utf-8"))


def _rank_main(rank: int, world: int, workdir: str) -> Optional[Dict[str, Any]]:
    from ..api.meta import new_object
    from ..gpu.profiling import StepClock
    from ..monitoring.plane import MonitoringPlane
    from ..monitoring.scrape import (SCRAPE_ANNOTATION, SCRAPE_JOB_ANNOTATION,
                                     SCRAPE_URL_ANNOTATION)
    from ..monitoring.stragglers import StragglerDetector, straggler_rules
    from ..monitoring.traces import TraceCollector
    from ..monitoring.tsdb import TSDB
    from ..parallel.composite import CompositeConfig
    from ..runtime.obs import mount_observability
    from ..runtime.tracing import BIND_TRACEPARENT_ANNOTATION
    from ..scheduler.gang import DRAIN_DEADLINE_ANNOTATION, annotations_of
    from ..services.dashboard import PlatformViews
    from ..training.checkpoint import Checkpointer
    from ..training.elastic import (CompositeWorkload, ElasticTrainer, PreemptionHandler,
                                    SliceOffer)
    from ..training.heartbeat import WorkerBeacon, clear_beacons
    from ..web.http import App

    with open(os.path.join(workdir, "args.json")) as f:
        device = json.load(f)["device"]
    cfg = CompositeConfig(n_layers=8, vocab_size=64)

    # -- phase A: the uninterrupted parity baseline ---------------------------
    ref_workload = CompositeWorkload(cfg=cfg, num_micro=4, microbatch=4, device=device)
    state = ref_workload.init(SliceOffer(devices=list(range(world)), pp=4))
    ref_losses = {}
    t0 = time.perf_counter()
    for s in range(TOTAL_STEPS):
        state, ref_losses[s] = ref_workload.run_step(state, s)
    seconds = {"reference": time.perf_counter() - t0}

    # -- phase B: the cluster and the monitoring plane, on rank 0 -------------
    mgr = client = sched = requester = plane = httpd = None
    beacon = None
    chaos: Dict[str, Any] = {}
    sibling_stop = threading.Event()
    threads = []
    if rank == 0:
        clear_beacons()
        mgr, client, sched = cluster([(f"gpu-node-{i}", 2 * (world // PODS))
                                      for i in range(3)])
        requester = SliceRequester(client, world)
        app = mount_observability(App("trainer"))
        tsdb = TSDB()
        traces = TraceCollector(client=client)
        detector = StragglerDetector(
            tsdb, client=client, namespace=NAMESPACE, skew_factor=SKEW_FACTOR, k=K, n=N,
            hang_deadline_s=HANG_DEADLINE, default_grace_s=GRACE_SECONDS, traces=traces)
        plane = MonitoringPlane(client=client, tsdb=tsdb, stale_after=40, timeout_s=5.0,
                                traces=traces, stragglers=detector)
        for rule in straggler_rules(step_slo_s=1.0):
            plane.rules.add(rule)
        plane.mount(app)
        httpd = app.serve(0)
        client.create(new_object(
            "v1", "Pod", "straggler-target", NAMESPACE,
            annotations={SCRAPE_ANNOTATION: "true",
                         SCRAPE_URL_ANNOTATION: f"http://127.0.0.1:{httpd.port}/metrics",
                         SCRAPE_JOB_ANNOTATION: "training"}))
        # the real trainer's beacon is worker 0 of the first gang; siblings
        # heartbeat as workers 1..3, where chaos lands
        beacon = WorkerBeacon("train-g1-0", step_delay_s=STEP_PACING)

        def orchestrate() -> None:
            siblings: Dict[str, _Sibling] = {}
            try:
                poll(lambda: requester.gen == 1 and requester.current_pods, timeout=120.0,
                     desc="first gang bound")
                pods = list(requester.current_pods)
                slow_w, wedge_w = pods[1], pods[2]
                siblings.update({n: _Sibling(WorkerBeacon(n, step_delay_s=STEP_PACING),
                                             sibling_stop) for n in pods[1:]})
                for n, sib in siblings.items():
                    t = threading.Thread(target=sib.run, name=f"sibling-{n}", daemon=True)
                    t.start()
                    threads.append(t)
                # every gang member federated AND the trainer stepping first
                poll(lambda: (set(detector.snapshot()["workers"]) >= set(pods)
                              and (detector.snapshot()["workers"][pods[0]]["stepIndex"]
                                   or 0) >= 3),
                     timeout=240.0, interval=0.1, desc="gang of 4 beacons stepping")

                siblings[slow_w].beacon.slow_factor = SLOW_FACTOR
                poll(lambda: detector.snapshot()["workers"][slow_w]["flagged"], timeout=30.0,
                     desc="slow worker flagged")
                flagged_at = time.time()
                chaos["straggler_detect_seconds"] = flagged_at - siblings[slow_w].slowed_at
                chaos["slow_worker"] = slow_w
                # the score while the slow fault is still applied (the
                # contract's moment), in the detector, federated into the
                # TSDB by the next scrape, and in the platform view: the
                # trainer's own step time moves the gang median, and with
                # it later windows
                chaos["straggler_score"] = detector.snapshot()["workers"][slow_w]["score"]

                def since_slowed(name: str, worker: Optional[str] = None) -> float:
                    """The largest sample of ``name`` scraped since the fault."""
                    return max((v for series in tsdb.series(name)
                                if worker is None or series.labels.get("worker") == worker
                                for ts, v in series.points
                                if ts >= siblings[slow_w].slowed_at), default=0.0)

                poll(lambda: since_slowed("training_straggler_score", slow_w) >= K / N,
                     timeout=10.0, desc="straggler score federated")
                chaos["federated_score"] = since_slowed("training_straggler_score", slow_w)
                chaos["platform_scores"] = poll(lambda: (lambda scores: scores if (
                    scores or {}).get(slow_w, 0.0) >= K / N else None)(
                        PlatformViews(plane).platform_overview(window_s=120.0)["stragglers"]
                        ["workerScores"]), timeout=10.0, desc="platform straggler score")
                # the recording rule evaluates after the detector in the same
                # tick: the gang's max/median as the worker was flagged
                poll(lambda: since_slowed("platform:training_worker_step_skew") >= SKEW_FACTOR,
                     timeout=10.0, desc="skew recording rule")
                chaos["skew"] = since_slowed("platform:training_worker_step_skew")

                wpod = client.get_opt("v1", "Pod", wedge_w, NAMESPACE)
                chaos["wedge_traceparent"] = annotations_of(wpod).get(
                    BIND_TRACEPARENT_ANNOTATION)
                siblings[wedge_w].beacon.wedge()
                verdict = poll(
                    lambda: (lambda v: v if v and v["worker"] == wedge_w else None)(
                        detector.snapshot()["lastHangVerdict"]),
                    timeout=30.0, desc="hang verdict")
                chaos["hang_detect_seconds"] = (verdict["detectedAt"]
                                                - siblings[wedge_w].last_step_at)
                chaos["verdict"] = dict(verdict)
                chaos["wedge_worker"] = wedge_w
                node = poll(lambda: (detector.snapshot()["quarantined"] or [None])[0],
                            timeout=15.0, desc="node quarantined")
                chaos["quarantined_node"] = node
                poll(lambda: node in sched.ledger.snapshot()["cordoned"], timeout=15.0,
                     desc="ledger cordon")
                poll(lambda: all(
                    (p := client.get_opt("v1", "Pod", n, NAMESPACE)) is None
                    or DRAIN_DEADLINE_ANNOTATION in annotations_of(p) for n in pods),
                    timeout=15.0, desc="gang drain stamped")
                # one more scrape must land the hang counter in the TSDB (the
                # tick that minted the verdict scraped BEFORE detecting)
                poll(lambda: any(lab.get("worker") == wedge_w for lab, _t, _v in
                                 tsdb.latest("training_hangs_detected_total")),
                     timeout=10.0, desc="hang counter federated")
                chaos["alerts"] = [r["alertname"] for r in plane.rules.snapshot()["alerts"]]
            except Exception:
                chaos["error"] = traceback.format_exc()
            finally:
                # detection is proven: stop the plane so the next
                # incarnation's restore gap is never read as a hang, and
                # release the chaos
                plane.stop()
                for sib in siblings.values():
                    sib.beacon.slow_factor = 1.0
                    sib.beacon.release()
                sibling_stop.set()

        plane.start(TICK_S)
        threads.append(threading.Thread(target=orchestrate, name="chaos-orchestrator",
                                        daemon=True))
        threads[-1].start()

    workload = CompositeWorkload(cfg=cfg, num_micro=4, microbatch=4, clock=StepClock(),
                                 beacon=beacon, device=device)
    trainer = ElasticTrainer(
        workload, Checkpointer(os.path.join(workdir, "ckpt"), max_to_keep=2), requester,
        TOTAL_STEPS, checkpoint_every=CKPT_EVERY,
        handler_factory=lambda offer: PreemptionHandler(client, NAMESPACE, offer.pods,
                                                        poll_interval=0.0))
    t0 = time.perf_counter()
    try:
        report = trainer.run()
        seconds["chaos_run"] = time.perf_counter() - t0
    finally:
        sibling_stop.set()
        if beacon is not None:
            beacon.release()
    if rank != 0:
        return None
    try:
        for t in threads:
            t.join(timeout=60.0)
        return dict(_check(report, ref_losses, chaos, requester, client, sched, plane,
                           traces, httpd), seconds=seconds)
    finally:
        plane.stop()
        mgr.stop()
        httpd.close()
        clear_beacons()


def _check(report, ref_losses, chaos, requester, client, sched, plane, traces,
           httpd) -> Dict[str, Any]:
    from ..runtime.tracing import parse_traceparent
    from ..services.dashboard import PlatformViews

    assert "error" not in chaos, f"chaos orchestration failed:\n{chaos['error']}"
    assert report.completed, f"training never finished: {report.incarnations}"

    # -- detection within the window budgets ----------------------------------
    assert chaos["straggler_detect_seconds"] <= STRAGGLER_BUDGET_S, chaos
    assert chaos["hang_detect_seconds"] <= HANG_BUDGET_S, chaos
    assert chaos["verdict"]["kind"] == "hang"
    assert chaos["verdict"]["worker"] == chaos["wedge_worker"]

    # -- forensics: the stack ring names the wedged frame ---------------------
    assert "_wedge_wait" in chaos["verdict"]["stackThreads"], chaos["verdict"]
    stacks = _http_json(httpd.port, "/debug/stacks?capture=0")
    hang_dumps = [d for d in stacks["history"]
                  if d["reason"] == f"hang:{chaos['wedge_worker']}"]
    assert hang_dumps, [d["reason"] for d in stacks["history"]]
    assert any(f["function"] == "_wedge_wait" for t in hang_dumps[-1]["threads"]
               for f in t["frames"]), "stack dump does not name the wedged frame"

    # -- the verdict rode the gang's federated bind trace ---------------------
    tp = parse_traceparent(chaos["wedge_traceparent"] or "")
    assert tp is not None, "scheduler never stamped a bind traceparent"
    federated = traces.trace(tp[0])
    assert federated is not None, "bind trace never federated"
    assert any(v["kind"] == "hang" for v in federated.get("verdicts", [])), \
        federated.get("verdicts")

    # -- quarantine → drain → ack → reshard around the loss -------------------
    bad_node = chaos["quarantined_node"]
    assert report.preemptions_survived >= 1, report.incarnations
    assert len(report.incarnations) == 2, report.incarnations
    assert report.incarnations[0]["outcome"] == "preempted"
    drained_at = report.incarnations[0]["endStep"]
    assert requester.acks[1] == [str(drained_at)] * PODS, requester.acks
    placement = requester.binding()
    assert all(n and n != bad_node for n in placement.values()), (
        f"reshard landed on quarantined node {bad_node}: {placement}")
    verdict_reasons = {v["node"]: v["reason"] for v in sched.ledger.explain(
        (NAMESPACE, "probe"), [(4, {})], now=time.time())}
    assert verdict_reasons.get(bad_node) == "quarantined", verdict_reasons

    # the flight recorder explains a follow-up misfit as `quarantined`: with
    # the reshard holding 8 of the 12 cards, a 4-card probe only fits on the
    # cordoned node
    client.create(gang_pod("probe-0", "probe", 1, 4, "trial"))
    decision = poll(lambda: sched.flight.last_for(f"{NAMESPACE}/probe"), timeout=20.0,
                    desc="probe flight record")
    probe_reasons = {n.get("node"): n.get("reason") for n in decision.nodes}
    assert probe_reasons.get(bad_node) == "quarantined", probe_reasons
    client.delete_opt("v1", "Pod", "probe-0", NAMESPACE)

    # -- loss parity vs the uninterrupted reference ---------------------------
    final = TOTAL_STEPS - 1
    delta = abs(report.losses[final] - ref_losses[final])
    assert delta <= LOSS_PARITY_TOL * max(1.0, abs(ref_losses[final])), (
        f"loss parity broken: chaos {report.losses[final]:.6f} vs reference "
        f"{ref_losses[final]:.6f}")
    max_step_delta = max(abs(report.losses[s] - ref_losses[s]) for s in ref_losses)

    # -- events, scores, federation, the beacon and platform views ------------
    reasons = {e["reason"] for e in client.list("v1", "Event", NAMESPACE)}
    assert {"WorkerStraggling", "WorkerHung", "NodeQuarantined"} <= reasons, reasons
    assert chaos["straggler_score"] >= K / N, chaos
    federated_workers = {lab.get("worker") for lab, _t, _v in
                         plane.tsdb.latest("training_worker_step_wall_seconds")}
    assert len(federated_workers) >= PODS, federated_workers
    assert chaos["federated_score"] >= K / N, chaos
    assert chaos["skew"] >= SKEW_FACTOR, chaos
    assert "TrainingWorkerStepLatency" in chaos["alerts"], chaos["alerts"]
    beacon_view = _http_json(httpd.port, "/debug/beacon")
    assert chaos["slow_worker"] in beacon_view["workers"]
    assert chaos["platform_scores"].get(chaos["slow_worker"], 0.0) >= K / N, chaos
    sect = PlatformViews(plane).platform_overview(window_s=120.0)["stragglers"]
    assert sect is not None, "platform stragglers section missing"
    assert bad_node in sect["activeQuarantines"], sect
    assert sect["lastHangVerdict"]["worker"] == chaos["wedge_worker"]
    assert sect["hangsDetected"].get(chaos["wedge_worker"]) == 1, sect
    return {
        "ok": True,
        "straggler_detect_seconds": chaos["straggler_detect_seconds"],
        "hang_detect_seconds": chaos["hang_detect_seconds"],
        "quarantined_node": bad_node,
        "probe_verdict": probe_reasons[bad_node],
        "incarnations": [{k: v for k, v in i.items() if k not in ("offer", "goodput")}
                         for i in report.incarnations],
        "final_loss": report.losses[final],
        "reference_final_loss": ref_losses[final],
        "max_step_loss_delta": max_step_delta,
        "stack_threads": chaos["verdict"]["stackThreads"],
        "trace_verdicts": len(federated["verdicts"]),
    }


def run(device: str = "cuda", ranks: int = RANKS, timeout: float = 300.0) -> Dict[str, Any]:
    if ranks % PODS:
        raise ValueError(f"ranks must divide into {PODS} pods (and pp 4), got {ranks}")
    return run_in_world(f"{__package__}.straggler_driver", device, ranks, timeout)


def main(argv=None) -> int:
    def run_and_report(device, ranks, timeout):
        summary = run(device, ranks, timeout)
        for metric in ("straggler_detect_seconds", "hang_detect_seconds"):
            print(json.dumps({"metric": metric, "value": round(summary[metric], 3)}))
        return summary

    return driver_main(argv, __doc__, run_and_report, RANKS)


if __name__ == "__main__":
    sys.exit(main())
