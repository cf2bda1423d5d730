"""Goodput-ledger e2e: account every wallclock second of a chaotic run.

The port of ``e2e/goodput_driver.py``. An ``ElasticTrainer`` runs the
composed-4D GPT (``CompositeConfig(n_layers=8, vocab_size=64)``) in a world
of 8 ranks (gloo processes on the CPU, standing for JAX's 8 virtual
devices; one rank a card with ``--device cuda``) on one slice shape (2 pods:
all ranks, pp 4), scripted on the drivers' in-memory :class:`PodClient`,
while rank 0's ``GoodputLedger`` decomposes its wallclock:

1. a ``StepClock`` on the workload separates the first-use work of each
   incarnation's process groups (the port's ``compile`` bucket) and the
   batch synthesis (``data_wait``) from compute inside every step;
2. the gang is drained twice gracefully (urgent checkpoint + ack, zero
   replay) and lost once HARD (pods deleted without a drain, on a step ≡ 1
   mod ``CKPT_EVERY``, so the next incarnation replays exactly the 2 steps
   past the last periodic checkpoint);
3. after training, rank 0 serves ``/metrics`` and ``/debug/goodput`` over
   real HTTP (``runtime.obs.mount_observability``) and reads the goodput
   gauge and the decomposition back.

Asserts JAX's honesty contract: fractions sum to EXACTLY 1.0, the named
buckets reconstruct the ledger's wallclock within 5% and that wallclock
the driver's own within 5%, ``preemption_replay``, ``checkpoint_restore``,
``checkpoint_save``, ``compile`` and ``scheduling_wait`` strictly positive,
the replay exactly the steps past the surviving checkpoint, graceful
handovers with zero replay. Cut, with the control plane: the scheduler's
bind-latency cross-check, the tenant chip meter, the TSDB scrape and its
recording rule, and the dashboard.

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

from .elastic_cluster import (NAMESPACE, PodClient, add_nodes, driver_main, evict, place_gang,
                              preempt_gang, run_in_world)

TOTAL_STEPS = 24
CKPT_EVERY = 4
GRACE_SECONDS = 20.0
STEP_SLEEP = 0.03  # JAX's: a step of host work beside the model's
RECONSTRUCTION_TOL = 0.05
RANKS = 8


class SliceRequester:
    """Rank 0's gang acquisition, one fixed shape (both hosts: all ranks)."""

    def __init__(self, client: PodClient, ranks: int):
        self.client = client
        self.ranks = ranks
        self.gen = 0
        self.current_pods: list = []

    def __call__(self, attempt: int):
        from ..training.elastic import SliceOffer

        evict(self.client, self.current_pods)  # gone already after a hard loss
        self.gen += 1
        names = place_gang(self.client, f"train-g{self.gen}", 2, self.ranks // 2,
                           grace=GRACE_SECONDS)
        assert names is not None, "the slice shape did not fit"
        self.current_pods = names
        return SliceOffer(devices=list(range(self.ranks)), pp=4, pods=names,
                          namespace=NAMESPACE)


def _get(port: int, path: str) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10.0) as resp:
        return resp.read().decode("utf-8")


def _rank_main(rank: int, world: int, workdir: str) -> Optional[Dict[str, Any]]:
    from ..gpu.profiling import StepClock
    from ..parallel.composite import CompositeConfig
    from ..runtime.metrics import METRICS
    from ..runtime.obs import mount_observability
    from ..training.checkpoint import Checkpointer
    from ..training.elastic import CompositeWorkload, ElasticTrainer, PreemptionHandler
    from ..web.http import App

    with open(os.path.join(workdir, "args.json")) as f:
        device = json.load(f)["device"]
    client = PodClient() if rank == 0 else None
    if client is not None:
        add_nodes(client, ["tpu-node-0", "tpu-node-1", "tpu-spare"], world // 2)
    requester = SliceRequester(client, world) if rank == 0 else None
    fired = set()

    def maybe_fire(gen: int, local: int, step: int) -> None:
        if gen in (1, 2) and local == 2 and gen not in fired:
            fired.add(gen)
            preempt_gang(client, requester.current_pods, GRACE_SECONDS)
        elif gen == 3 and 3 not in fired and local >= 1 and step % CKPT_EVERY == 1:
            fired.add(3)
            evict(client, requester.current_pods)  # HARD: no drain signal

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
    t0 = time.perf_counter()
    report = trainer.run()
    elapsed = time.perf_counter() - t0
    if rank != 0:
        return None

    # -- survival -------------------------------------------------------------
    assert report.completed, f"training never finished: {report.incarnations}"
    assert report.preemptions_survived >= 2, report.incarnations
    assert fired == {1, 2, 3}, f"unfired chaos phases: {fired}"
    outcomes = [i["outcome"] for i in report.incarnations]
    assert "lost" in outcomes, f"hard loss never happened: {outcomes}"

    # -- the honesty contract -------------------------------------------------
    snap = trainer.goodput.snapshot()
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

    # -- satellite series -----------------------------------------------------
    assert METRICS.histogram("checkpoint_restore_seconds").total >= 3
    assert METRICS.total("training_badput_seconds_total") > 0.0
    assert METRICS.value("training_badput_seconds_total", bucket="preemption_replay") > 0.0
    gauge = METRICS.value("training_goodput_fraction", workload="training")
    assert gauge > 0.0 and abs(gauge - snap["goodputFraction"]) <= 1e-6, (
        gauge, snap["goodputFraction"])

    # -- the surfaces, over real HTTP -----------------------------------------
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
    finally:
        httpd.close()

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
        "scraped_goodput_fraction": float(m.group(1)),
    }


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
