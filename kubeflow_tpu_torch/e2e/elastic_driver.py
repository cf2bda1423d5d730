"""Elastic-training e2e: train under repeated preemption and prove survival.

The port of ``e2e/elastic_driver.py``. The composed-4D GPT
(``CompositeConfig(n_layers=8, vocab_size=64)``) trains through
``training.elastic.ElasticTrainer`` in a world of 8 ranks
(``parallel.launch.run_world``: gloo processes on the CPU, standing for
JAX's 8 virtual devices; one rank a card with ``--device cuda``). The
cluster is the drivers' in-memory :class:`PodClient` (two hosts of 4
chips and a spare of 4), the preemptions scripted on it as JAX's
scheduler and chaos harness would make them:

1. the first gang (2 pods x 4 chips: all 8 ranks, pp 4, V 1) is drained at
   its third step, as a notebook gang arriving would: the handler sees
   the deadline, urgent-checkpoints and acks; the notebook takes both hosts;
2. the re-request finds only the spare (1 pod: ranks 0-3, pp 2, V 2) and
   RESHARDS the canonical checkpoint; ranks 4-7 wait;
3. the notebook leaves and the gang is drained again: back to 8 ranks;
4. a third drain, a third survival;
5. a kill -9 mid-save: the checkpointer skips the torn and the corrupt
   checkpoint and resumes from the previous complete one.

Asserts JAX's contract: >= 3 preemptions survived, >= 1 reshard (the
(pp 2, V 2) shape used), zero steps lost beyond the last checkpoint (each
incarnation resumes at endStep+1), every drained gang acked before its
eviction, the loss curve within 1e-3 of an uninterrupted run, bounded
restart latency, and the ``training_preemptions_survived_total`` /
``training_restart_seconds`` / ``checkpoint_save_seconds`` series. Cut,
with the control plane: the scheduler's own drain counters and the benign
chaos (watch drops, apiserver brown-outs).

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

from .elastic_cluster import (NAMESPACE, PodClient, add_nodes, driver_main, evict, place_gang,
                              preempt_gang, run_in_world)

TOTAL_STEPS = 30
CKPT_EVERY = 5
GRACE_SECONDS = 20.0
LOSS_TOL = 1e-3
RANKS = 8


def shapes(ranks: int) -> List[Dict[str, int]]:
    """Preferred → degraded slice shapes: both hosts (all ranks), then the
    spare alone (half of them)."""
    return [{"pods": 2, "chips": ranks // 2, "pp": 4, "virtual": 1},
            {"pods": 1, "chips": ranks // 2, "pp": 2, "virtual": 2}]


class SliceRequester:
    """Rank 0's gang acquisition: evict the previous (drained) gang,
    recording its acks, bind any gang waiting ahead of ours, then ask for
    the preferred shape and accept a degraded one (the reshard)."""

    def __init__(self, client: PodClient, ranks: int, prefix: str = "train"):
        self.client = client
        self.ranks = ranks
        self.prefix = prefix
        self.gen = 0  # bumped per granted slice; triggers key off it
        self.current_pods: List[str] = []
        self.ahead: List[Dict[str, Any]] = []  # higher-priority gangs to bind first
        self.evictions: List[Dict[str, Any]] = []

    def __call__(self, attempt: int):
        from ..training.elastic import SliceOffer

        if self.current_pods:
            self.evictions.append({"gen": self.gen, "pods": list(self.current_pods),
                                   "acks": evict(self.client, self.current_pods)})
            self.current_pods = []
        for g in list(self.ahead):
            if place_gang(self.client, g["gang"], g["pods"], g["chips"]) is not None:
                self.ahead.remove(g)
        self.gen += 1
        for shape in shapes(self.ranks):
            names = place_gang(self.client, f"{self.prefix}-g{self.gen}-{shape['pods']}p",
                               shape["pods"], shape["chips"], grace=GRACE_SECONDS)
            if names is not None:
                self.current_pods = names
                return SliceOffer(devices=list(range(shape["pods"] * shape["chips"])),
                                  pp=shape["pp"], virtual_stages=shape["virtual"],
                                  pods=names, namespace=NAMESPACE)
        raise AssertionError("no slice shape was placeable")


def cluster(ranks: int) -> PodClient:
    client = PodClient()
    add_nodes(client, ["tpu-node-0", "tpu-node-1", "tpu-spare"], ranks // 2)
    return client


def _rank_main(rank: int, world: int, workdir: str) -> Optional[Dict[str, Any]]:
    from ..parallel.composite import CompositeConfig
    from ..runtime.metrics import METRICS
    from ..training.checkpoint import Checkpointer
    from ..training.elastic import (CompositeWorkload, ElasticTrainer, PreemptionHandler,
                                    SliceOffer)

    with open(os.path.join(workdir, "args.json")) as f:
        device = json.load(f)["device"]
    cfg = CompositeConfig(n_layers=8, vocab_size=64)  # 8 layers: pp*V=4 both ways
    client = cluster(world) if rank == 0 else None
    requester = SliceRequester(client, world) if rank == 0 else None
    aggressor = {"gang": "aggr", "pods": 2, "chips": world // 2}

    def spawn_aggressor():  # a notebook gang arrives: the scheduler drains ours
        requester.ahead.append(aggressor)
        preempt_gang(client, requester.current_pods, GRACE_SECONDS)

    def release_aggressor_and_preempt():
        evict(client, [f"aggr-{i}" for i in range(aggressor["pods"])])
        preempt_gang(client, requester.current_pods, GRACE_SECONDS)

    def chaos_preempt():
        preempt_gang(client, requester.current_pods, GRACE_SECONDS)

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
    t0 = time.perf_counter()
    report = trainer.run()
    elapsed = time.perf_counter() - t0

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
    for ev, inc in zip(requester.evictions, report.incarnations):
        assert ev["acks"] == [str(inc["endStep"])] * len(ev["pods"]), (ev, inc)

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
