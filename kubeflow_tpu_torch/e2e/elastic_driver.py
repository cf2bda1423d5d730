"""Elastic-training e2e: train under repeated preemption and prove survival.

The port of ``e2e/elastic_driver.py``. The composed-4D GPT
(``CompositeConfig(n_layers=8, vocab_size=64)``) trains through
``training.elastic.ElasticTrainer`` in a world of 8 ranks
(``parallel.launch.run_world``: gloo processes on the CPU, standing for
JAX's 8 virtual devices; one rank a card with ``--device cuda``). Rank 0
holds the cluster (``elastic_cluster.cluster``: the port's store, gang
scheduler and podlet on two hosts of 4 cards and a spare of 4, JAX's
topology on ``nvidia.com/gpu`` nodes) and decides for the gang:

1. the trainer asks for the preferred slice (2 pods x 4 cards: all 8
   ranks, pp 4, V 1) as a drain-graced ``trial``-priority gang
   (:class:`SliceRequester`: JAX's, 4 s for the gang to run, else
   withdraw and try the next shape);
2. preemption 1 is ORGANIC: a ``notebook`` gang arrives at the third step
   and the scheduler runs its two-phase drain: the ``PreemptionHandler``
   sees the deadline annotation between steps, urgent-checkpoints and
   acks, and the scheduler evicts the gang;
3. the re-request finds only the spare free (1 pod: ranks 0-3, pp 2, V 2)
   and RESHARDS the canonical checkpoint; ranks 4-7 wait;
4. preemptions 2-3 come from the chaos harness (``preempt_gang``), the
   notebook released before the first of them, so the trainer reshards
   back up to 8 ranks; a seeded benign-chaos schedule (Pod watch drops,
   0.2 s apiserver brown-outs) runs the whole time;
5. a kill -9 mid-save: the checkpointer skips the torn and the corrupt
   checkpoint and resumes from the previous complete one.

Asserts JAX's contract: >= 3 preemptions survived, >= 1 reshard (the
(pp 2, V 2) shape used), zero steps lost beyond the last checkpoint (each
incarnation resumes at endStep+1), the loss curve within 1e-3 of an
uninterrupted run, bounded restart latency, the
``training_preemptions_survived_total`` / ``training_restart_seconds`` /
``checkpoint_save_seconds`` series, and the scheduler's and the harness's
own counters (``scheduler_drains_requested_total``,
``scheduler_drains_completed_total{outcome="acked"}``,
``chaos_faults_injected_total{kind="preempt_gang"}``); and the port's
own: every drained gang's pods carried the drained step's ack when they
were deleted (read from the Pod informer's DELETED events).

``python -m kubeflow_tpu_torch.e2e.elastic_driver [--device cuda|cpu]
[--ranks N]`` (one rank a card by default, 8 on the CPU) prints the
summary as one JSON line and exits 0, or prints ``{"ok": false, "error":
...}`` and exits 1.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np

from .elastic_cluster import (NAMESPACE, cluster, driver_main, gang_pod, gone, poll,
                              run_in_world, running)

TOTAL_STEPS = 30
CKPT_EVERY = 5
GRACE_SECONDS = 20.0
CHAOS_SEED = 20260805
LOSS_TOL = 1e-3
RANKS = 8


def shapes(ranks: int) -> List[Dict[str, int]]:
    """Preferred → degraded slice shapes: both hosts (all ranks), then the
    spare alone (half of them)."""
    return [{"pods": 2, "chips": ranks // 2, "pp": 4, "virtual": 1},
            {"pods": 1, "chips": ranks // 2, "pp": 2, "virtual": 2}]


class SliceRequester:
    """Rank 0's gang acquisition, JAX's: ask the scheduler for the
    preferred slice shape, accept a degraded one if the cluster cannot
    place it (the reshard), give up on none."""

    def __init__(self, client, ranks: int, prefix: str = "train"):
        self.client = client
        self.ranks = ranks
        self.prefix = prefix
        self.gen = 0  # bumped per granted slice; triggers key off it
        self.current_gang: Optional[str] = None

    def __call__(self, attempt: int):
        from ..training.elastic import SliceOffer

        self.gen += 1
        for shape in shapes(self.ranks):
            gang = f"{self.prefix}-g{self.gen}-{shape['pods']}p"
            names = [f"{gang}-{i}" for i in range(shape["pods"])]
            for n in names:
                self.client.create(gang_pod(n, gang, shape["pods"], shape["chips"], "trial",
                                            grace=GRACE_SECONDS))
            try:
                poll(lambda: running(self.client, names), timeout=4.0,
                     desc=f"gang {gang} running")
            except AssertionError:
                # shape unplaceable right now: withdraw and try the next one
                for n in names:
                    self.client.delete_opt("v1", "Pod", n, NAMESPACE)
                poll(lambda: gone(self.client, names), desc="withdrawn gang gone")
                continue
            self.current_gang = gang
            return SliceOffer(devices=list(range(shape["pods"] * shape["chips"])),
                              pp=shape["pp"], virtual_stages=shape["virtual"],
                              pods=names, namespace=NAMESPACE)
        raise AssertionError("no slice shape was placeable")


def _rank_main(rank: int, world: int, workdir: str) -> Optional[Dict[str, Any]]:
    from ..parallel.composite import CompositeConfig
    from ..runtime.chaos import ChaosMonkey, ChaosSchedule, Fault
    from ..runtime.metrics import METRICS
    from ..scheduler.gang import DRAIN_ACK_ANNOTATION, annotations_of, name_of
    from ..training.checkpoint import Checkpointer
    from ..training.elastic import (CompositeWorkload, ElasticTrainer, PreemptionHandler,
                                    SliceOffer)

    with open(os.path.join(workdir, "args.json")) as f:
        device = json.load(f)["device"]
    cfg = CompositeConfig(n_layers=8, vocab_size=64)  # 8 layers: pp*V=4 both ways
    mgr = client = requester = monkey = benign = None
    #: pod name → the drain ack it carried when it was deleted
    deleted: Dict[str, Optional[str]] = {}
    if rank == 0:
        mgr, client, _sched = cluster([("gpu-node-0", world // 2), ("gpu-node-1", world // 2),
                                        ("gpu-spare", world // 2)])
        requester = SliceRequester(client, world)
        monkey = ChaosMonkey(client, ChaosSchedule([]), store=mgr.store)
        def note_deleted(kind: str, pod: Dict[str, Any]) -> None:
            if kind == "DELETED":
                deleted[name_of(pod)] = annotations_of(pod).get(DRAIN_ACK_ANNOTATION)

        # the Pod informer, started eagerly: the watch-drop fault's stream,
        # and the DELETED events that carry each evicted pod's last state
        pods = mgr.cache.informer_for("v1", "Pod")
        pods.add_event_handler(note_deleted)
        # benign chaos runs throughout, from a seeded (reproducible) schedule
        benign = ChaosMonkey(
            client,
            ChaosSchedule.seeded(CHAOS_SEED, 4, 20.0,
                                 targets={"drop_informer_watch": ["Pod"],
                                          "delay_apiserver": [""]},
                                 param={"delay_apiserver": 0.2}),
            store=mgr.store, informers=[pods]).start()
    aggressor = [f"aggr-{i}" for i in range(2)]

    def spawn_aggressor():  # a notebook gang arrives: the scheduler drains ours
        for n in aggressor:
            client.create(gang_pod(n, "aggr", 2, world // 2, "notebook"))

    def chaos_preempt():
        monkey.inject(Fault(0.0, "preempt_gang", f"{NAMESPACE}/{requester.current_gang}",
                            param=GRACE_SECONDS))

    def release_aggressor_and_preempt():
        for n in aggressor:
            client.delete_opt("v1", "Pod", n, NAMESPACE)
        chaos_preempt()

    # (incarnation, local step) -> trigger, fired by rank 0 after the step
    triggers = {(1, 2): spawn_aggressor, (2, 2): release_aggressor_and_preempt,
                (3, 2): chaos_preempt}

    class DrivenWorkload(CompositeWorkload):
        def __init__(self, **kw):
            super().__init__(**kw)
            self._gen, self._local = None, 0

        def run_step(self, state, step):
            state, loss = super().run_step(state, step)
            if requester is not None:
                if requester.gen != self._gen:
                    self._gen, self._local = requester.gen, 0
                fire = triggers.pop((self._gen, self._local), None)
                if fire is not None:
                    fire()
                self._local += 1
            return state, loss

    ckpt_dir = os.path.join(workdir, "ckpt")
    trainer = ElasticTrainer(
        DrivenWorkload(cfg=cfg, num_micro=4, microbatch=4, device=device),
        Checkpointer(ckpt_dir, max_to_keep=3), requester, TOTAL_STEPS,
        checkpoint_every=CKPT_EVERY,
        handler_factory=lambda offer: PreemptionHandler(client, NAMESPACE, offer.pods,
                                                        poll_interval=0.0))
    try:
        t0 = time.perf_counter()
        report = trainer.run()
        elapsed = time.perf_counter() - t0
        if rank == 0:
            # every drained gang is deleted once its pods ack
            drained = [p for i in report.incarnations if i["outcome"] == "preempted"
                       for p in i["offer"]["pods"]]
            poll(lambda: all(p in deleted for p in drained), desc="drained gangs deleted")
    finally:
        for stoppable in (benign, monkey, mgr):
            if stoppable is not None:
                stoppable.stop()

    # the uninterrupted reference, on every rank
    ref_workload = CompositeWorkload(cfg=cfg, num_micro=4, microbatch=4, device=device)
    state = ref_workload.init(SliceOffer(devices=list(range(world)), pp=4))
    ref = {}
    for s in range(TOTAL_STEPS):
        state, ref[s] = ref_workload.run_step(state, s)
    if rank != 0:
        return None

    # -- survival -------------------------------------------------------------
    assert report.completed, f"training never finished: {report.incarnations}"
    assert report.preemptions_survived >= 3, report.incarnations
    assert not triggers, f"untriggered phases left: {sorted(triggers)}"

    # -- at least one reshard -------------------------------------------------
    used = [(i["offer"]["pp"], i["offer"]["virtualStages"]) for i in report.incarnations]
    assert len(set(used)) >= 2, f"no reshard happened: {used}"
    assert (2, 2) in used, f"degraded (pp=2, V=2) slice never used: {used}"
    assert [i["offer"]["chips"] for i in report.incarnations][:2] == [world, world // 2]

    # -- zero lost steps beyond the last checkpoint; every drain acked ---------
    for prev, cur in zip(report.incarnations, report.incarnations[1:]):
        assert prev["outcome"] == "preempted", prev
        assert cur["startStep"] == prev["endStep"] + 1, (prev, cur)
    for inc in report.incarnations[:-1]:
        acks = [deleted[p] for p in inc["offer"]["pods"]]
        assert acks == [str(inc["endStep"])] * len(acks), (inc, acks)

    # -- loss continuity vs an uninterrupted run ------------------------------
    assert set(report.losses) == set(ref), "missing steps in elastic run"
    worst = max(abs(report.losses[s] - ref[s]) for s in ref)
    assert worst <= LOSS_TOL, f"loss curve diverged: max|d|={worst:.2e}"

    # -- bounded restart latency ----------------------------------------------
    restarts = METRICS.histogram("training_restart_seconds")
    assert restarts.total == report.restarts >= 3
    assert restarts.sum / restarts.total < 120.0, restarts.sum

    # -- telemetry ------------------------------------------------------------
    assert METRICS.total("training_preemptions_survived_total") >= 3
    assert METRICS.histogram("checkpoint_save_seconds").total >= 3
    assert METRICS.total("scheduler_drains_requested_total") >= 1
    assert METRICS.value("scheduler_drains_completed_total", outcome="acked") >= 1
    assert METRICS.value("chaos_faults_injected_total", kind="preempt_gang") >= 2

    return {
        "ok": True,
        "device": device,
        "ranks": world,
        "elapsed_seconds": round(elapsed, 1),
        "preemptions_survived": report.preemptions_survived,
        "restarts": report.restarts,
        "incarnations": [
            {k: v for k, v in i.items() if k not in ("offer", "goodput")}
            | {"shape": s, "chips": i["offer"]["chips"]}
            for i, s in zip(report.incarnations, used)],
        "max_loss_delta": float(worst),
        "restart_seconds_mean": restarts.sum / restarts.total,
        "drains_requested": METRICS.total("scheduler_drains_requested_total"),
        "drains_acked": METRICS.value("scheduler_drains_completed_total", outcome="acked"),
        "chaos_preemptions": METRICS.value("chaos_faults_injected_total", kind="preempt_gang"),
        "benign_chaos": sorted(f.kind for f in benign.fired),
        "kill9": kill9_scenario(),
    }


def kill9_scenario() -> dict:
    """A writer killed -9 mid-save leaves a torn temp dir; a bit-flipped
    leaf leaves a complete-looking but corrupt step. A restart must skip
    both and resume from the newest COMPLETE checkpoint."""
    from ..training.checkpoint import Checkpointer

    d = tempfile.mkdtemp(prefix="elastic-kill9-")
    try:
        ckpt = Checkpointer(d)
        ckpt.save(0, {"x": np.full(8, 10.0)}, meta={"step": 0})
        ckpt.save(1, {"x": np.full(8, 11.0)}, meta={"step": 1})
        torn = os.path.join(d, "_tmp.2.deadbeef")  # kill -9 during save(2)
        os.makedirs(torn)
        with open(os.path.join(torn, "leaf_00000.npy"), "wb") as f:
            f.write(b"partial write")
        leaf = os.path.join(d, "step_1", "leaf_00000.npy")  # silent media corruption
        with open(leaf, "r+b") as f:
            f.seek(-1, os.SEEK_END)
            last = f.read(1)
            f.seek(-1, os.SEEK_END)
            f.write(bytes([last[0] ^ 0xFF]))
        restarted = Checkpointer(d)  # the post-crash process
        assert not os.path.exists(torn), "torn temp dir not reclaimed"
        tree, meta = restarted.restore_numpy()
        assert meta["step"] == 0, f"did not fall back past corrupt step: {meta}"
        np.testing.assert_array_equal(tree["x"], np.full(8, 10.0))
        return {"resumed_step": meta["step"], "skipped": [1], "torn_cleaned": True}
    finally:
        shutil.rmtree(d, ignore_errors=True)


def run(device: str = "cuda", ranks: int = RANKS, timeout: float = 300.0) -> Dict[str, Any]:
    if ranks % 4:
        raise ValueError(f"ranks must divide by 4 (pp 4 and (pp 2, V 2) on half), got {ranks}")
    return run_in_world(f"{__package__}.elastic_driver", device, ranks, timeout)


def main(argv=None) -> int:
    return driver_main(argv, __doc__, run, RANKS)


if __name__ == "__main__":
    sys.exit(main())
