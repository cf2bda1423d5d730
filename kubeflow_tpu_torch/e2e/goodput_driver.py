"""Goodput-ledger e2e: account every wallclock second of a chaotic run.

The port of ``e2e/goodput_driver.py``. An ``ElasticTrainer`` runs the
composed-4D GPT (``CompositeConfig(n_layers=8, vocab_size=64)``) in a world
of 8 ranks (gloo processes on the CPU, standing for JAX's 8 virtual
devices; one rank a card with ``--device cuda``) on one slice shape (2 pods:
all ranks, pp 4), while rank 0's ``GoodputLedger`` decomposes its
wallclock. Rank 0 holds the cluster (``elastic_cluster.cluster``: the
port's store, gang scheduler and podlet on JAX's three nodes as
``nvidia.com/gpu`` nodes of ``ranks // 2`` cards):

1. the gang is a drain-graced ``trial`` gang the scheduler binds; a
   ``StepClock`` on the workload separates the first-use work of each
   incarnation's process groups (the port's ``compile`` bucket) and the
   batch synthesis (``data_wait``) from compute inside every step;
2. chaos preempts the gang twice gracefully (``preempt_gang``: urgent
   checkpoint + ack, zero replay) and it is lost once HARD (its pods
   deleted without a drain, on a step ≡ 1 mod ``CKPT_EVERY``, so the next
   incarnation replays exactly the 2 steps past the last periodic
   checkpoint);
3. a gang of ``ranks // 2`` cards in namespace ``tenant-a`` is bound for
   the whole run, so ``tenant_chip_seconds_total`` can be checked against
   cards × bound duration;
4. after training, rank 0 serves ``/metrics`` and ``/debug/goodput`` over
   real HTTP (``runtime.obs.mount_observability``); a ``MonitoringPlane``
   scrapes it as an annotated Pod, evaluates the
   ``platform:training_goodput_fraction`` recording rule, and the
   dashboard's platform view (``services.dashboard.PlatformViews``) reports
   the goodput and tenants sections from the federated TSDB.

Asserts JAX's honesty contract: fractions sum to EXACTLY 1.0, the named
buckets reconstruct the ledger's wallclock within 5% and that wallclock
the driver's own within 5%, ``preemption_replay``, ``checkpoint_restore``,
``checkpoint_save``, ``compile`` and ``scheduling_wait`` strictly positive,
the replay exactly the steps past the surviving checkpoint, graceful
handovers with zero replay, ``scheduling_wait`` within 1.5 s a gang of the
scheduler's own ``scheduler_bind_latency_seconds`` (creation timestamps
have whole-second resolution), and the tenant meter within
``TENANT_TOL_CHIP_SECONDS`` of cards × bound duration. The dashboard app
itself (its routes and auth) is not ported: the view is called directly.

``python -m kubeflow_tpu_torch.e2e.goodput_driver [--device cuda|cpu]
[--ranks N]`` (one rank a card by default, 8 on the CPU) prints a metric
line and the summary, and exits 0, or prints ``{"ok": false, "error":
...}`` and exits 1.
"""

from __future__ import annotations

import json
import os
import re
import sys
import time
import urllib.request
from typing import Any, Dict, Optional

from .elastic_cluster import (NAMESPACE, cluster, driver_main, gang_pod, poll, run_in_world,
                              running)

TENANT_NS = "tenant-a"
TOTAL_STEPS = 24
CKPT_EVERY = 4
GRACE_SECONDS = 20.0
STEP_SLEEP = 0.03  # JAX's: a step of host work beside the model's
RECONSTRUCTION_TOL = 0.05
#: bind-latency timestamps have 1s resolution (creationTimestamp), so the
#: cross-check slack scales with the number of observed gangs
BIND_LATENCY_SLACK_PER_GANG = 1.5
#: tenant meter tolerance: cards × (bind-observe + unbind-settle delays)
TENANT_TOL_CHIP_SECONDS = 8.0
RANKS = 8


class SliceRequester:
    """Rank 0's gang acquisition against the scheduler, one fixed shape
    (both hosts: all ranks)."""

    def __init__(self, client, ranks: int):
        self.client = client
        self.ranks = ranks
        self.gen = 0
        self.current_gang: Optional[str] = None
        self.current_pods: list = []

    def __call__(self, attempt: int):
        from ..training.elastic import SliceOffer

        self.gen += 1
        gang = f"train-g{self.gen}"
        names = [f"{gang}-{i}" for i in range(2)]
        for n in names:
            self.client.create(gang_pod(n, gang, 2, self.ranks // 2, "trial",
                                        grace=GRACE_SECONDS))
        poll(lambda: running(self.client, names), timeout=30.0, desc=f"gang {gang} running")
        self.current_gang, self.current_pods = gang, names
        return SliceOffer(devices=list(range(self.ranks)), pp=4, pods=names,
                          namespace=NAMESPACE)


def _get(port: int, path: str) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10.0) as resp:
        return resp.read().decode("utf-8")


def _rank_main(rank: int, world: int, workdir: str) -> Optional[Dict[str, Any]]:
    from ..gpu.profiling import StepClock
    from ..monitoring.goodput import TENANT_METER
    from ..parallel.composite import CompositeConfig
    from ..runtime.chaos import ChaosMonkey, ChaosSchedule, Fault
    from ..training.checkpoint import Checkpointer
    from ..training.elastic import CompositeWorkload, ElasticTrainer, PreemptionHandler

    with open(os.path.join(workdir, "args.json")) as f:
        device = json.load(f)["device"]
    mgr = client = requester = monkey = None
    tenant_cards = world // 2
    if rank == 0:
        mgr, client, _sched = cluster([("gpu-node-0", world // 2), ("gpu-node-1", world // 2),
                                        ("gpu-spare", world // 2)])
        # the metered tenant: one gang bound for the whole run
        client.create(gang_pod("meter-0", "meter", 1, tenant_cards, "trial",
                               namespace=TENANT_NS))
        poll(lambda: running(client, ["meter-0"], TENANT_NS), desc="tenant gang running")
        tenant_bound_at = time.monotonic()
        requester = SliceRequester(client, world)
        monkey = ChaosMonkey(client, ChaosSchedule([]), store=mgr.store)
    fired = set()

    # gens 1 & 2: GRACEFUL chaos preemption (urgent save + ack → zero replay);
    # gen 3: HARD loss — pods deleted with no drain signal, on a step ≡ 1
    # (mod CKPT_EVERY) so the surviving checkpoint (saved at step ≡ 3)
    # makes the next incarnation replay exactly 2 steps
    def maybe_fire(gen: int, local: int, step: int) -> None:
        if gen in (1, 2) and local == 2 and gen not in fired:
            fired.add(gen)
            monkey.inject(Fault(0.0, "preempt_gang", f"{NAMESPACE}/{requester.current_gang}",
                                param=GRACE_SECONDS))
        elif gen == 3 and 3 not in fired and local >= 1 and step % CKPT_EVERY == 1:
            fired.add(3)
            for n in requester.current_pods:
                client.delete_opt("v1", "Pod", n, NAMESPACE)

    class DrivenWorkload(CompositeWorkload):
        def __init__(self, **kw):
            super().__init__(**kw)
            self._gen, self._local = None, 0

        def run_step(self, state, step):
            state, loss = super().run_step(state, step)
            if requester is not None:
                if requester.gen != self._gen:
                    self._gen, self._local = requester.gen, 0
                maybe_fire(self._gen, self._local, step)
                self._local += 1
            time.sleep(STEP_SLEEP)
            return state, loss

    trainer = ElasticTrainer(
        DrivenWorkload(cfg=CompositeConfig(n_layers=8, vocab_size=64), num_micro=4,
                       microbatch=4, clock=StepClock(), device=device),
        Checkpointer(os.path.join(workdir, "ckpt"), max_to_keep=3), requester, TOTAL_STEPS,
        checkpoint_every=CKPT_EVERY,
        handler_factory=lambda offer: PreemptionHandler(client, NAMESPACE, offer.pods,
                                                        poll_interval=0.0))
    try:
        t0 = time.perf_counter()
        report = trainer.run()
        elapsed = time.perf_counter() - t0
        if rank != 0:
            return None
        # settle the tenant interval before reading the meter
        client.delete_opt("v1", "Pod", "meter-0", TENANT_NS)
        poll(lambda: TENANT_NS not in TENANT_METER.open_intervals(),
             desc="tenant interval settled")
        tenant_unbound_at = time.monotonic()
        return _check(report, trainer.goodput.snapshot(), elapsed, fired, client, device,
                      world, tenant_cards * (tenant_unbound_at - tenant_bound_at))
    finally:
        for stoppable in (monkey, mgr):
            if stoppable is not None:
                stoppable.stop()


def _check(report, snap, elapsed, fired, client, device, world,
           expected_chip_s) -> Dict[str, Any]:
    from ..runtime.metrics import METRICS

    # -- survival -------------------------------------------------------------
    assert report.completed, f"training never finished: {report.incarnations}"
    assert report.preemptions_survived >= 2, report.incarnations
    assert fired == {1, 2, 3}, f"unfired chaos phases: {fired}"
    outcomes = [i["outcome"] for i in report.incarnations]
    assert "lost" in outcomes, f"hard loss never happened: {outcomes}"

    # -- the honesty contract -------------------------------------------------
    fraction_sum = sum(snap["fractions"].values())
    assert fraction_sum == 1.0, f"fractions must sum to exactly 1.0, got {fraction_sum!r}"
    assert snap["reconstructionError"] <= RECONSTRUCTION_TOL, (
        f"named buckets fail to reconstruct wallclock: {snap['reconstructionError']:.4f} > "
        f"{RECONSTRUCTION_TOL}; decomposition: {snap['badputSeconds']}")
    wall_delta = abs(snap["wallclockSeconds"] - elapsed) / elapsed
    assert wall_delta <= RECONSTRUCTION_TOL, (
        f"ledger wallclock {snap['wallclockSeconds']:.2f}s vs driver {elapsed:.2f}s "
        f"({wall_delta:.1%})")

    # -- attribution: chaos lands in named buckets, not `other` ---------------
    bad = snap["badputSeconds"]
    for bucket in ("preemption_replay", "checkpoint_restore", "checkpoint_save", "compile",
                   "scheduling_wait"):
        assert bad[bucket] > 0.0, (bucket, bad)
    replayed = sum(i["goodput"]["replaySteps"] for i in report.incarnations)
    assert replayed == 2, (f"hard loss on step ≡ 1 (mod {CKPT_EVERY}) must replay exactly "
                           f"2 steps, replayed {replayed}")
    for prev, cur in zip(report.incarnations, report.incarnations[1:]):
        if prev["outcome"] == "preempted":
            assert cur["startStep"] == prev["endStep"] + 1, (prev, cur)
            assert cur["goodput"]["replaySteps"] == 0, cur

    # -- scheduling_wait vs the scheduler's own bind-latency signal -----------
    bind = METRICS.histogram("scheduler_bind_latency_seconds")
    assert bind.total >= len(report.incarnations), bind.total
    slack = BIND_LATENCY_SLACK_PER_GANG * bind.total
    assert abs(bad["scheduling_wait"] - bind.sum) <= slack, (
        f"scheduling_wait {bad['scheduling_wait']:.2f}s vs scheduler bind latency "
        f"{bind.sum:.2f}s over {int(bind.total)} gangs")

    # -- satellite series -----------------------------------------------------
    assert METRICS.histogram("checkpoint_restore_seconds").total >= 3
    assert METRICS.total("training_badput_seconds_total") > 0.0
    assert METRICS.value("training_badput_seconds_total", bucket="preemption_replay") > 0.0
    gauge = METRICS.value("training_goodput_fraction", workload="training")
    assert gauge > 0.0 and abs(gauge - snap["goodputFraction"]) <= 1e-6, (
        gauge, snap["goodputFraction"])

    # -- tenant metering: cards × bound duration ------------------------------
    actual_chip_s = METRICS.value("tenant_chip_seconds_total", namespace=TENANT_NS)
    assert abs(actual_chip_s - expected_chip_s) <= TENANT_TOL_CHIP_SECONDS, (
        f"tenant_chip_seconds_total={actual_chip_s:.2f} vs "
        f"cards×duration={expected_chip_s:.2f}")

    # -- the surfaces, over real HTTP; scrape → TSDB → rule → platform view ---
    monitoring = monitoring_phase(client, snap)
    return {
        "ok": True,
        "device": device,
        "ranks": world,
        "elapsed_seconds": round(elapsed, 2),
        "preemptions_survived": report.preemptions_survived,
        "incarnations": [{k: v for k, v in i.items() if k != "offer"}
                         for i in report.incarnations],
        "goodput_fraction": snap["goodputFraction"],
        "reconstruction_error": snap["reconstructionError"],
        "badput_seconds": bad,
        "replayed_steps": replayed,
        "bind_latency_seconds": {"count": bind.total, "sum": bind.sum},
        "tenant_chip_seconds": actual_chip_s,
        "tenant_expected_chip_seconds": expected_chip_s,
        "scraped_goodput_fraction": monitoring["metrics_goodput_fraction"],
        "monitoring": monitoring,
    }


def monitoring_phase(client, snap) -> Dict[str, Any]:
    """Serve this process's ``/metrics`` and ``/debug/goodput``, read them
    back, then scrape them into a ``MonitoringPlane`` (an annotated Pod),
    evaluate the goodput recording rule and read the platform view's
    goodput and tenants sections from the federated TSDB."""
    from ..api.meta import new_object
    from ..monitoring.goodput import goodput_recording_rules
    from ..monitoring.plane import MonitoringPlane
    from ..monitoring.scrape import (SCRAPE_ANNOTATION, SCRAPE_JOB_ANNOTATION,
                                     SCRAPE_URL_ANNOTATION)
    from ..runtime.obs import mount_observability
    from ..services.dashboard import PlatformViews
    from ..web.http import App

    httpd = mount_observability(App("trainer")).serve(0)
    try:
        text = _get(httpd.port, "/metrics")
        m = re.search(r'^training_goodput_fraction\{workload="training"\} (\S+)$', text, re.M)
        assert m and abs(float(m.group(1)) - snap["goodputFraction"]) < 1e-3, m
        assert 'training_badput_seconds_total{bucket="preemption_replay"}' in text
        doc = json.loads(_get(httpd.port, "/debug/goodput"))
        served = doc["workloads"]["training"]
        assert sum(served["fractions"].values()) == 1.0
        assert served["badputSeconds"]["preemption_replay"] > 0.0

        client.create(new_object(
            "v1", "Pod", "goodput-target", NAMESPACE,
            annotations={SCRAPE_ANNOTATION: "true",
                         SCRAPE_URL_ANNOTATION: f"http://127.0.0.1:{httpd.port}/metrics",
                         SCRAPE_JOB_ANNOTATION: "training"}))
        plane = MonitoringPlane(client=client, stale_after=10, timeout_s=5.0)
        for rule in goodput_recording_rules():
            plane.rules.add(rule)
        up = plane.scraper.scrape_once()
        assert up and all(up.values()), f"scrape target not up: {up}"
        plane.tick()
        scraped = {lab.get("workload"): v
                   for lab, _t, v in plane.tsdb.latest("training_goodput_fraction")}
        assert scraped.get("training") is not None, scraped
        assert abs(scraped["training"] - snap["goodputFraction"]) < 1e-3, (
            scraped, snap["goodputFraction"])
        recorded = [v for _l, _t, v in plane.tsdb.latest("platform:training_goodput_fraction")]
        assert recorded and 0.0 < recorded[0] <= 1.0, f"recording rule produced {recorded}"
        assert list(plane.tsdb.latest("tenant_chip_seconds_total")), \
            "tenant chip meter not federated"

        view = PlatformViews(plane).platform_overview(window_s=60.0)
        gp = view["goodput"]
        assert gp["trainingGoodputFraction"], gp
        assert gp["trainingBadputSeconds"].get("preemption_replay", 0) > 0, gp
        tenants = {t["namespace"]: t for t in view["tenants"]}
        assert TENANT_NS in tenants and tenants[TENANT_NS]["chipSeconds"] > 0, view["tenants"]
        return {
            "metrics_goodput_fraction": float(m.group(1)),
            "scraped_goodput_fraction": scraped["training"],
            "recorded_measured_fraction": recorded[0],
            "dashboard_tenants": sorted(tenants),
        }
    finally:
        httpd.close()


def run(device: str = "cuda", ranks: int = RANKS, timeout: float = 300.0) -> Dict[str, Any]:
    if ranks % 4:
        raise ValueError(f"ranks must divide by 4 (pp 4), got {ranks}")
    return run_in_world(f"{__package__}.goodput_driver", device, ranks, timeout)


def main(argv=None) -> int:
    def run_and_report(device, ranks, timeout):
        summary = run(device, ranks, timeout)
        # the metric line of JAX's GOODPUT_r* family, then the summary
        print(json.dumps({"metric": "training_goodput_fraction",
                          "value": round(summary["goodput_fraction"], 4)}))
        return summary

    return driver_main(argv, __doc__, run_and_report, RANKS)


if __name__ == "__main__":
    sys.exit(main())
