"""kubeflow_tpu_torch/training/elastic.py against kubeflow_tpu/training/elastic.py.

- JAX's scripted scenarios (a numpy ``ToyWorkload`` re-chunked over each
  offer, scripted drains and lost gangs, a corrupt newest checkpoint) run
  through JAX's and the port's ``ElasticTrainer``: the reports are equal
  (completion, start steps, outcomes, losses, restarts, each incarnation's
  replayed steps), as are the acks and the counters.
- The port's ``PreemptionHandler`` runs against the JAX package's
  in-process apiserver, and against its scheduler's two-phase drain
  protocol (a notebook gang preempting a drain-graced trial gang).
- ``CompositeWorkload`` in a world of 8 gloo ranks resumes a checkpoint
  that JAX's ``ElasticTrainer`` wrote at (pp 4, V 1) on 8 virtual devices,
  at (pp 2, V 2) on ranks 0-3 (4-7 wait), is drained by rank 0's handler,
  saves, and finishes at (pp 4, V 1) on all 8: the losses continue JAX's
  uninterrupted curve within 2e-4 relative (~1e-6 seen).

The JAX package is imported inside the tests: the gloo ranks import this
module for ``_rank_main`` and need none of it.
"""

from __future__ import annotations

import os
import pickle
import shutil
import time

import numpy as np
import pytest

from kubeflow_tpu_torch.parallel.launch import run_world
from kubeflow_tpu_torch.runtime.metrics import METRICS as T_METRICS
from kubeflow_tpu_torch.scheduler.gang import (DRAIN_ACK_ANNOTATION, DRAIN_DEADLINE_ANNOTATION,
                                               DRAIN_GRACE_ANNOTATION, POD_GROUP_LABEL,
                                               POD_GROUP_SIZE_ANNOTATION, annotations_of)
from kubeflow_tpu_torch.training import elastic as te
from kubeflow_tpu_torch.training.checkpoint import Checkpointer as TCheckpointer


@pytest.fixture(autouse=True)
def _reset_port_metrics():
    T_METRICS.reset()
    yield


class ToyWorkload:
    """JAX's test workload: a canonical vector chunked across the offer's
    devices, with a momentum term so snapshots cover optimizer state."""

    CANON = 8

    def init(self, offer):
        n = len(offer.devices)
        return {"x": np.zeros((n, self.CANON // n)), "m": np.zeros((n, self.CANON // n))}

    def restore(self, offer, snap, meta):
        n = len(offer.devices)
        return {"x": np.asarray(snap["x"]).reshape(n, self.CANON // n),
                "m": np.asarray(snap["m"]).reshape(n, self.CANON // n)}

    def snapshot(self, state):
        return {"x": state["x"].reshape(-1), "m": state["m"].reshape(-1)}, {"dataCursor": None}

    def run_step(self, state, step):
        g = 0.01 * (step + 1)
        state["m"] = 0.9 * state["m"] + g
        state["x"] = state["x"] - state["m"]
        return state, float(np.sum(state["x"]) * (step + 1))


class ScriptedHandler:
    """Drains after a given step, or vanishes at one, or never; records acks."""

    def __init__(self, module, trainer_steps, drain_at=None, lost_at=None):
        self.module, self.steps = module, trainer_steps
        self.drain_at, self.lost_at = drain_at, lost_at
        self.acked = []

    def check(self):
        step = self.steps[-1]
        if self.lost_at is not None and step >= self.lost_at:
            return self.module.DrainStatus("lost")
        if self.drain_at is not None and step >= self.drain_at:
            return self.module.DrainStatus("draining", time.time() + 5)
        return self.module.DrainStatus("ok")

    def ack(self, step):
        self.acked.append(step)


def _scripted(module, ckpt_cls, path, widths, drains, total=10, every=0, corrupt_at=None):
    steps = [0]
    handlers = []
    workload = ToyWorkload()
    real_step = workload.run_step

    def run_step(state, step):
        steps.append(step)
        return real_step(state, step)

    workload.run_step = run_step

    def provider(attempt):
        if corrupt_at is not None and attempt == 1:
            leaf = os.path.join(path, f"step_{corrupt_at}", "leaf_00000.npy")
            data = bytearray(open(leaf, "rb").read())
            data[-1] ^= 0xFF
            open(leaf, "wb").write(bytes(data))
        if attempt >= len(widths):
            return None
        return module.SliceOffer(devices=list(range(widths[attempt])),
                                 pods=[f"p{attempt}-{i}" for i in range(2)])

    def handler_factory(offer):
        spec = drains[len(handlers)] if len(handlers) < len(drains) else None
        h = (ScriptedHandler(module, steps, lost_at=spec[1]) if isinstance(spec, tuple)
             else ScriptedHandler(module, steps, drain_at=spec))
        handlers.append(h)
        return h

    trainer = module.ElasticTrainer(workload, ckpt_cls(path), provider, total,
                                    checkpoint_every=every, handler_factory=handler_factory)
    return trainer.run(), handlers


def _comparable(report):
    incs = [{k: v for k, v in inc.items() if k != "goodput"} for inc in report.incarnations]
    for inc, full in zip(incs, report.incarnations):
        inc["replaySteps"] = full["goodput"]["replaySteps"]
        inc["goodputOutcome"] = full["goodput"]["outcome"]
    return (report.completed, report.preemptions_survived, report.restarts, report.losses, incs)


SCENARIOS = {
    # name: widths, drains, checkpoint_every, corrupt the step_N saved before attempt 1
    "drains_reshard_smaller": ([8, 4, 2], [3, 4, None], 0, None),
    "lost_replays_periodic": ([8, 8], [("lost", 4), None], 2, None),
    "corrupt_newest_skipped": ([8, 8], [4, None], 2, 4),
    "drain_on_periodic_step": ([8, 8], [3, None], 4, None),
    "gives_up": ([8], [2], 0, None),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scripted_reports_equal_jax(tmp_path, name):
    from kubeflow_tpu.runtime.metrics import METRICS as J_METRICS
    from kubeflow_tpu.training import elastic as je
    from kubeflow_tpu.training.checkpoint import Checkpointer as JCheckpointer

    widths, drains, every, corrupt = SCENARIOS[name]
    jpath, tpath = str(tmp_path / "jax"), str(tmp_path / "port")
    jrep, jh = _scripted(je, JCheckpointer, jpath, widths, drains, every=every,
                         corrupt_at=corrupt)
    trep, th = _scripted(te, TCheckpointer, tpath, widths, drains, every=every,
                         corrupt_at=corrupt)
    assert _comparable(trep) == _comparable(jrep)
    assert [h.acked for h in th] == [h.acked for h in jh]
    assert sorted(os.listdir(tpath)) == sorted(os.listdir(jpath))
    assert T_METRICS.total("training_preemptions_survived_total") == \
        J_METRICS.total("training_preemptions_survived_total")
    for hist in ("training_restart_seconds", "checkpoint_save_seconds",
                 "checkpoint_restore_seconds"):
        assert T_METRICS.histogram(hist).total == J_METRICS.histogram(hist).total, hist
    assert trep.completed == (name != "gives_up")


def _pod(name, gang=None, size=1, chips=0, priority_class=None, grace=None):
    from kubeflow_tpu.api.meta import new_object

    spec = {"containers": [{"name": "c"}]}
    if chips:
        spec["containers"][0]["resources"] = {"limits": {"google.com/tpu": str(chips)}}
    if priority_class:
        spec["priorityClassName"] = priority_class
    annotations = {POD_GROUP_SIZE_ANNOTATION: str(size)} if gang else {}
    if grace is not None:
        annotations[DRAIN_GRACE_ANNOTATION] = str(grace)
    return new_object("v1", "Pod", name, "default",
                      labels={POD_GROUP_LABEL: gang} if gang else {},
                      annotations=annotations, spec=spec)


def test_handler_detects_drain_acks_and_sees_a_lost_gang(client):
    client.create(_pod("w-0"))
    client.create(_pod("w-1"))
    h = te.PreemptionHandler(client, "default", ["w-0", "w-1"], poll_interval=0.0)
    assert h.check().state == "ok"
    deadline = time.time() + 9.0
    client.patch("v1", "Pod", "w-0",
                 {"metadata": {"annotations": {DRAIN_DEADLINE_ANNOTATION: f"{deadline:.3f}"}}},
                 "default")
    status = h.check()
    assert status.state == "draining" and status.deadline == pytest.approx(deadline, abs=0.01)
    client.delete("v1", "Pod", "w-0", "default")
    assert h.check().state == "draining"  # sticky
    h.ack(17)
    assert annotations_of(client.get("v1", "Pod", "w-1", "default"))[
        DRAIN_ACK_ANNOTATION] == "17"
    lost = te.PreemptionHandler(client, "default", ["w-1"], poll_interval=0.0)
    assert lost.check().state == "ok"
    client.delete("v1", "Pod", "w-1", "default")
    assert lost.check().state == "lost"
    local = te.PreemptionHandler(client, "default", ["gone"], poll_interval=10.0)
    local.request_local_drain(grace=1.0)
    assert local.check().state == "draining"


def _wait(pred, timeout=15.0, desc="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    assert pred(), f"timed out waiting for {desc}"


def test_handler_speaks_the_scheduler_drain_protocol():
    """A notebook gang preempts a drain-graced trial gang: JAX's scheduler
    stamps the deadline, the port's handler sees it and acks, and the
    scheduler evicts at once (long before the 30 s grace) and counts an
    acked drain. It deletes the victims before it counts the drain
    (``kubeflow_tpu/scheduler/core.py:543-553``), so the count is awaited as
    a difference from the count before, not read at the deletion."""
    from kubeflow_tpu.controllers.builtin import PodletReconciler, make_tpu_node
    from kubeflow_tpu.runtime.manager import Manager
    from kubeflow_tpu.runtime.metrics import METRICS as J_METRICS
    from kubeflow_tpu.scheduler import SchedulerReconciler

    mgr = Manager()
    mgr.add(SchedulerReconciler(assembly_timeout=5.0, reservation_ttl=5.0, backoff_base=0.02,
                                backoff_cap=0.5)).add(PodletReconciler())
    client = mgr.client
    client.create(make_tpu_node("tpu-node-0", "v5e", "2x4", 4))
    client.create(make_tpu_node("tpu-node-1", "v5e", "2x4", 4))

    def acked_drains():
        return J_METRICS.value("scheduler_drains_completed_total", outcome="acked")

    acked_before = acked_drains()
    mgr.start()
    try:
        names = [f"trial-{i}" for i in range(2)]
        for n in names:
            client.create(_pod(n, "hpo", 2, 4, "trial", grace=30))
        _wait(lambda: all((client.get("v1", "Pod", n, "default").get("spec") or {})
                          .get("nodeName") for n in names), desc="trial gang bound")
        handler = te.PreemptionHandler(client, "default", names, poll_interval=0.0)
        assert handler.check().state == "ok"
        for i in range(2):
            client.create(_pod(f"nb-{i}", "nb", 2, 4, "notebook"))
        _wait(lambda: handler.check().state == "draining", desc="drain seen")
        assert handler.check().deadline > time.time() + 5
        t0 = time.monotonic()
        handler.ack(41)
        _wait(lambda: client.get_opt("v1", "Pod", "trial-0", "default") is None,
              desc="victims evicted after the ack")
        assert time.monotonic() - t0 < 15.0
        _wait(lambda: acked_drains() >= acked_before + 1, desc="the acked drain counted")
    finally:
        mgr.stop()


# -- CompositeWorkload across factorizations, in a world of 8 ranks ----------------

CFG = dict(vocab_size=64, d_model=32, n_heads=4, d_ff=64, n_layers=4, seq=16)
TOTAL, JAX_SAVED, DRAIN_AT = 6, 1, 3


@pytest.fixture(scope="module")
def jax_elastic(tmp_path_factory):
    from kubeflow_tpu.parallel.composite import CompositeConfig as JCfg
    from kubeflow_tpu.training import elastic as je
    from kubeflow_tpu.training.checkpoint import Checkpointer as JCheckpointer

    workdir = str(tmp_path_factory.mktemp("elastic_world"))
    cfg = JCfg(**CFG)
    import jax

    devices = jax.devices()
    # the uninterrupted curve
    ref = je.CompositeWorkload(cfg=cfg)
    state = ref.init(je.SliceOffer(devices=devices, pp=4))
    losses = {}
    for s in range(TOTAL):
        state, losses[s] = ref.run_step(state, s)
    # the elastic checkpoint: JAX's trainer drained after step JAX_SAVED
    steps = [0]

    class Drained(je.CompositeWorkload):
        def run_step(self, state, step):
            steps.append(step)
            return super().run_step(state, step)

    handler = ScriptedHandler(je, steps, drain_at=JAX_SAVED)
    trainer = je.ElasticTrainer(
        Drained(cfg=cfg), JCheckpointer(f"{workdir}/ckpt"),
        lambda a: je.SliceOffer(devices=devices, pp=4) if a == 0 else None, TOTAL,
        handler_factory=lambda offer: handler)
    report = trainer.run()
    assert not report.completed and handler.acked == [JAX_SAVED]
    assert JCheckpointer(f"{workdir}/ckpt").read_meta()["pp"] == 4
    return {"workdir": workdir, "losses": losses, "jax_report": report.losses}


def _rank_main(rank, world, workdir):
    from kubeflow_tpu_torch.parallel.composite import CompositeConfig
    from kubeflow_tpu_torch.training.checkpoint import Checkpointer

    steps = [0]
    handlers = []

    class Tracked(te.CompositeWorkload):
        def run_step(self, state, step):
            steps.append(step)
            return super().run_step(state, step)

    offers = [te.SliceOffer(devices=[0, 1, 2, 3], pp=2, virtual_stages=2),
              te.SliceOffer(devices=list(range(8)), pp=4)]

    def factory(offer):
        handlers.append(ScriptedHandler(te, steps, drain_at=DRAIN_AT if not handlers else None))
        return handlers[-1]

    trainer = te.ElasticTrainer(
        Tracked(cfg=CompositeConfig(**CFG), device="cpu"), Checkpointer(f"{workdir}/ckpt"),
        lambda a: offers[a] if a < len(offers) else None, TOTAL, handler_factory=factory)
    report = trainer.run()
    return {"report": report, "acked": [h.acked for h in handlers],
            "saved": Checkpointer(f"{workdir}/ckpt").all_steps() if rank == 0 else None}


@pytest.fixture(scope="module")
def world(jax_elastic):
    return run_world(f"{__name__}:_rank_main", 8, jax_elastic["workdir"], timeout=240,
                     device="cpu")


def test_composite_resumes_a_jax_checkpoint_at_another_factorization(world, jax_elastic):
    rep = world[0]["report"]
    assert rep.completed and rep.preemptions_survived == 1 and rep.restarts == 1
    assert [i["startStep"] for i in rep.incarnations] == [JAX_SAVED + 1, DRAIN_AT + 1]
    assert [i["outcome"] for i in rep.incarnations] == ["preempted", "completed"]
    assert [(i["offer"]["pp"], i["offer"]["virtualStages"], i["offer"]["chips"])
            for i in rep.incarnations] == [(2, 2, 4), (4, 1, 8)]
    assert world[0]["acked"] == [[DRAIN_AT], []]
    assert DRAIN_AT in world[0]["saved"]
    want = jax_elastic["losses"]
    assert sorted(rep.losses) == list(range(JAX_SAVED + 1, TOTAL))
    np.testing.assert_allclose([rep.losses[s] for s in sorted(rep.losses)],
                               [want[s] for s in sorted(rep.losses)], rtol=2e-4)
    # JAX's own run matched its uninterrupted curve on the steps it took
    for s, loss in jax_elastic["jax_report"].items():
        assert loss == pytest.approx(want[s], rel=1e-6)


def test_every_rank_ends_with_the_gang(world):
    """Ranks 4-7 sat out the first offer and waited at its end: every rank
    reports the same incarnations and outcomes; a gang rank the same
    losses as rank 0."""
    first = world[0]["report"]
    for rank, res in enumerate(world):
        rep = res["report"]
        assert rep.completed
        assert [(i["startStep"], i["outcome"], i["endStep"]) for i in rep.incarnations] == [
            (i["startStep"], i["outcome"], i["endStep"]) for i in first.incarnations]
        gang_steps = set(range(JAX_SAVED + 1, TOTAL)) if rank < 4 else set(
            range(DRAIN_AT + 1, TOTAL))
        assert set(rep.losses) == gang_steps, rank
        for s in gang_steps:
            assert rep.losses[s] == first.losses[s]
        assert res["acked"] == ([[DRAIN_AT], []] if rank == 0 else [])


def test_kill9_torn_save_is_skipped(tmp_path):
    """A save killed mid-write leaves ``_tmp.*``; a flipped byte leaves a
    complete-looking but corrupt step: the port's checkpointer reclaims the
    first and resumes past the second, as JAX's does."""
    from kubeflow_tpu.training.checkpoint import Checkpointer as JCheckpointer

    d = str(tmp_path)
    ckpt = TCheckpointer(d)
    ckpt.save(0, {"x": np.full(8, 10.0)}, meta={"step": 0})
    ckpt.save(1, {"x": np.full(8, 11.0)}, meta={"step": 1})
    torn = os.path.join(d, "_tmp.2.deadbeef")
    os.makedirs(torn)
    with open(os.path.join(torn, "leaf_00000.npy"), "wb") as f:
        f.write(b"partial write")
    with open(os.path.join(d, "step_1", "leaf_00000.npy"), "r+b") as f:
        f.seek(-1, os.SEEK_END)
        last = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([last[0] ^ 0xFF]))
    copy = str(tmp_path / "copy")
    shutil.copytree(d, copy)
    for cls, path in ((TCheckpointer, d), (JCheckpointer, copy)):
        tree, meta = cls(path).restore_numpy()
        assert not os.path.exists(os.path.join(path, "_tmp.2.deadbeef"))
        assert meta["step"] == 0
        np.testing.assert_array_equal(tree["x"], np.full(8, 10.0))


def test_alone_every_offer_is_this_process(tmp_path):
    """Without a ``torch.distributed`` world the trainer is JAX's: any
    offer's devices back this process (rank 0's membership is checked only
    in a world of several), and the report pickles."""
    report = te.ElasticTrainer(ToyWorkload(), TCheckpointer(str(tmp_path)),
                               lambda a: te.SliceOffer(devices=[3, 5]) if a == 0 else None,
                               2).run()
    assert report.completed
    with open(os.devnull, "wb") as f:
        pickle.dump(report, f)  # reports cross process boundaries
