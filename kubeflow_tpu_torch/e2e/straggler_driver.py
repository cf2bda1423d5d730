"""Straggler-plane e2e: detect, forensically dump, quarantine, reshard.

The port of ``e2e/straggler_driver.py``. The composed-4D GPT
(``CompositeConfig(n_layers=8, vocab_size=64)``) trains through
``ElasticTrainer`` in a world of 8 ranks (gloo processes on the CPU,
standing for JAX's 8 virtual devices; one rank a card with ``--device
cuda``) as a gang of 4 pods x 2 chips on three nodes of 4 chips, held by
the drivers' in-memory :class:`PodClient`:

1. an uninterrupted REFERENCE run on the same seeds records the loss curve;
2. in the chaos run, rank 0 publishes a :class:`WorkerBeacon` from inside
   its step (the gang's pacing, ``STEP_PACING`` a step, under the step's
   ``collective_wait`` phase) and three sibling threads heartbeat beside
   it: a gang of four beacons in rank 0's registry, which a
   ``StragglerDetector`` reads through ``RegistrySource`` every ``TICK_S``;
3. ``slow_worker`` (x5 pacing) on one sibling must be flagged within the
   k-of-n window budget; then ``wedge_worker`` on another: the detector
   mints a hang verdict, the ``/debug/stacks`` ring holds an all-thread
   dump naming the wedged frame (``_wedge_wait``), the hosting node is
   quarantined and the gang drained;
4. ``ElasticTrainer`` acks, saves and takes a new gang, placed only on
   nodes that are not quarantined, and finishes with loss parity against
   the reference.

``straggler_detect_seconds`` / ``hang_detect_seconds`` are printed as
metric lines, as JAX's. Cut, with the control plane: the verdict's
attachment to the gang's federated bind trace, the scheduler's flight
recorder (``quarantined`` misfits), the TSDB scrape with its recording
rule and burn-rate alert, and the dashboard.

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

from .elastic_cluster import (NAMESPACE, PodClient, add_nodes, driver_main, evict, place_gang,
                              poll, run_in_world)

TOTAL_STEPS = 32
CKPT_EVERY = 8
GRACE_SECONDS = 20.0
#: the gang: 4 single-worker pods x 2 chips over 3 nodes x 4 chips, so
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
#: detection budgets: k-of-n windows at the tick cadence (+ publish slack)
#: for skew; the deadline itself + slack for hangs
STRAGGLER_BUDGET_S = N * TICK_S + 5.0
HANG_BUDGET_S = HANG_DEADLINE + 5.0
LOSS_PARITY_TOL = 1e-3
RANKS = 8


class SliceRequester:
    """Rank 0's gang acquisition: release the previous (drained) gang, the
    way a job controller recreates its pod group, and bind a new one."""

    def __init__(self, client: PodClient, ranks: int):
        self.client = client
        self.ranks = ranks
        self.gen = 0
        self.current_pods: list = []
        self.acks: list = []

    def __call__(self, attempt: int):
        from ..training.elastic import SliceOffer

        self.acks.append(evict(self.client, self.current_pods))
        self.gen += 1
        names = place_gang(self.client, f"train-g{self.gen}", PODS, self.ranks // PODS,
                           grace=GRACE_SECONDS)
        assert names is not None, "no room for the gang"
        self.current_pods = names
        return SliceOffer(devices=list(range(self.ranks)), pp=4, pods=names,
                          namespace=NAMESPACE)

    def binding(self) -> Dict[str, Optional[str]]:
        return {n: ((self.client.get_opt("v1", "Pod", n, NAMESPACE) or {}).get("spec") or {})
                .get("nodeName") for n in self.current_pods}


def _sibling_loop(beacon, stop: threading.Event) -> None:
    """One simulated gang member: throttle (pacing + chaos interposition)
    then publish, until stopped."""
    step = 0
    while not stop.is_set():
        t0 = time.perf_counter()
        wait = beacon.throttle()
        beacon.publish({"total": time.perf_counter() - t0, "collective_wait": wait}, step)
        step += 1


def _http_json(port: int, path: str) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5.0) as resp:
        return json.loads(resp.read().decode("utf-8"))


def _rank_main(rank: int, world: int, workdir: str) -> Optional[Dict[str, Any]]:
    from ..gpu.profiling import StepClock
    from ..monitoring.stragglers import RegistrySource, StragglerDetector
    from ..parallel.composite import CompositeConfig
    from ..runtime.metrics import METRICS
    from ..runtime.obs import mount_observability
    from ..scheduler.gang import DRAIN_DEADLINE_ANNOTATION, annotations_of
    from ..training.checkpoint import Checkpointer
    from ..training.elastic import (CompositeWorkload, ElasticTrainer, PreemptionHandler,
                                    SliceOffer)
    from ..training.heartbeat import WorkerBeacon, beacons, clear_beacons
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

    # -- phase B: the detector, on rank 0 -------------------------------------
    client = requester = detector = httpd = None
    beacon = None
    chaos: Dict[str, Any] = {}
    stop_ticks, sibling_stop = threading.Event(), threading.Event()
    threads = []
    if rank == 0:
        clear_beacons()
        client = PodClient()
        add_nodes(client, [f"tpu-node-{i}" for i in range(3)], 2 * (world // PODS))
        requester = SliceRequester(client, world)
        detector = StragglerDetector(
            RegistrySource(METRICS), client=client, namespace=NAMESPACE,
            skew_factor=SKEW_FACTOR, k=K, n=N, hang_deadline_s=HANG_DEADLINE,
            default_grace_s=GRACE_SECONDS)
        httpd = mount_observability(App("trainer")).serve(0)
        # the real trainer's beacon is worker 0 of the first gang; siblings
        # heartbeat as workers 1..3, where chaos lands
        beacon = WorkerBeacon("train-g1-0", step_delay_s=STEP_PACING)

        def ticker() -> None:
            while not stop_ticks.wait(TICK_S):
                detector.tick()

        def orchestrate() -> None:
            try:
                poll(lambda: requester.gen == 1 and requester.current_pods, timeout=120.0,
                     desc="first gang bound")
                pods = list(requester.current_pods)
                slow_w, wedge_w = pods[1], pods[2]
                for name in pods[1:]:
                    t = threading.Thread(
                        target=_sibling_loop,
                        args=(WorkerBeacon(name, step_delay_s=STEP_PACING), sibling_stop),
                        name=f"sibling-{name}", daemon=True)
                    t.start()
                    threads.append(t)
                # every gang member seen AND the trainer stepping first
                poll(lambda: (set(detector.snapshot()["workers"]) >= set(pods)
                              and (detector.snapshot()["workers"][pods[0]]["stepIndex"]
                                   or 0) >= 3),
                     timeout=240.0, interval=0.1, desc="gang of 4 beacons stepping")
                siblings = {n: b for n, b in beacons().items() if n in pods[1:]}

                t_slow = time.time()
                siblings[slow_w].slow_factor = SLOW_FACTOR
                poll(lambda: detector.snapshot()["workers"][slow_w]["flagged"], timeout=30.0,
                     desc="slow worker flagged")
                chaos["straggler_detect_seconds"] = time.time() - t_slow
                chaos["slow_worker"] = slow_w
                # the score while the slow fault is still applied (the
                # contract's moment): the wedge and the drain after it move
                # the gang median, and with it later windows
                chaos["straggler_score"] = METRICS.value("training_straggler_score",
                                                         worker=slow_w)

                t_wedge = time.time()
                siblings[wedge_w].wedge()
                verdict = poll(
                    lambda: (lambda v: v if v and v["worker"] == wedge_w else None)(
                        detector.snapshot()["lastHangVerdict"]),
                    timeout=30.0, desc="hang verdict")
                chaos["hang_detect_seconds"] = verdict["detectedAt"] - t_wedge
                chaos["verdict"] = dict(verdict)
                chaos["wedge_worker"] = wedge_w
                chaos["quarantined_node"] = poll(
                    lambda: (detector.snapshot()["quarantined"] or [None])[0], timeout=15.0,
                    desc="node quarantined")
                poll(lambda: all(
                    (p := client.get_opt("v1", "Pod", n, NAMESPACE)) is None
                    or DRAIN_DEADLINE_ANNOTATION in annotations_of(p) for n in pods),
                    timeout=15.0, desc="gang drain stamped")
            except Exception:
                chaos["error"] = traceback.format_exc()
            finally:
                # detection is proven: stop ticking so the next incarnation's
                # restore gap is never read as a hang, and release the chaos
                stop_ticks.set()
                for b in beacons().values():
                    b.slow_factor = 1.0
                    b.release()
                sibling_stop.set()

        threads.append(threading.Thread(target=ticker, name="detector", daemon=True))
        threads.append(threading.Thread(target=orchestrate, name="chaos-orchestrator",
                                        daemon=True))
        for t in threads:
            t.start()

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
        stop_ticks.set()
        sibling_stop.set()
        for b in ([beacon] if beacon is not None else []):
            b.release()
    if rank != 0:
        return None
    try:
        for t in threads:
            t.join(timeout=60.0)
        return dict(_check(report, ref_losses, chaos, requester, client, httpd),
                    seconds=seconds)
    finally:
        httpd.close()
        clear_beacons()


def _check(report, ref_losses, chaos, requester, client, httpd) -> Dict[str, Any]:
    from ..monitoring.stragglers import RegistrySource
    from ..runtime.metrics import METRICS

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

    # -- loss parity vs the uninterrupted reference ---------------------------
    final = TOTAL_STEPS - 1
    delta = abs(report.losses[final] - ref_losses[final])
    assert delta <= LOSS_PARITY_TOL * max(1.0, abs(ref_losses[final])), (
        f"loss parity broken: chaos {report.losses[final]:.6f} vs reference "
        f"{ref_losses[final]:.6f}")
    max_step_delta = max(abs(report.losses[s] - ref_losses[s]) for s in ref_losses)

    # -- events, scores, the beacon view --------------------------------------
    reasons = {e["reason"] for e in client.list("v1", "Event", NAMESPACE)}
    assert {"WorkerStraggling", "WorkerHung", "NodeQuarantined"} <= reasons, reasons
    assert chaos["straggler_score"] >= K / N, chaos
    assert METRICS.value("training_hangs_detected_total", worker=chaos["wedge_worker"]) == 1
    walls = RegistrySource(METRICS).latest("training_worker_step_wall_seconds")
    assert len({labels["worker"] for labels, _ts, _v in walls}) >= PODS
    beacon_view = _http_json(httpd.port, "/debug/beacon")
    assert chaos["slow_worker"] in beacon_view["workers"]
    return {
        "ok": True,
        "straggler_detect_seconds": chaos["straggler_detect_seconds"],
        "hang_detect_seconds": chaos["hang_detect_seconds"],
        "quarantined_node": bad_node,
        "incarnations": [{k: v for k, v in i.items() if k not in ("offer", "goodput")}
                         for i in report.incarnations],
        "final_loss": report.losses[final],
        "reference_final_loss": ref_losses[final],
        "max_step_loss_delta": max_step_delta,
        "stack_threads": chaos["verdict"]["stackThreads"],
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
