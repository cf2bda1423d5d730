"""Elastic training: survive preemption, resume on whatever slice is next.
The port of ``kubeflow_tpu/training/elastic.py``.

The scheduler's drain protocol (docs/ELASTICITY.md) turns eviction into a
two-phase signal: a drain-deadline annotation lands on the victim's pods,
and deletion waits for an ack or the deadline. This module is the workload
side of that contract:

- :class:`PreemptionHandler` — polls the gang's pods between steps for the
  drain signal (or their disappearance), and acks once state is safe;
- :class:`ElasticTrainer`   — the supervising loop: train → on drain,
  urgent-checkpoint + ack → on eviction/crash, re-request a gang, accept
  WHATEVER slice is offered next, restore from the latest complete
  checkpoint, keep going;
- :class:`CompositeWorkload` — the composed-4D GPT (``parallel/composite.py``)
  as an elastic workload: snapshots are the canonical per-layer weights, so
  a (pp=4, V=1) checkpoint restores onto a (pp=2, V=2) mesh by re-chunking.

The port runs one process a device (``parallel/mesh.py``), so the trainer
is SPMD: it runs in every rank of the ``torch.distributed`` world (or
alone, without one). An offer's ``devices`` are world ranks, rank 0 among
them. Rank 0 decides: it calls ``slice_provider``, reads the checkpoint
and builds the handler, and broadcasts the offer, the restored snapshot
and each step's drain verdict, so every rank of a gang stops after the
same step. ``init``/``restore`` run in every rank (the workload's
``make_mesh`` is collective over the world) and return None outside the
offer; those ranks wait at the incarnation's end. Snapshots are collective
(every gang rank gathers) and rank 0 writes them through the port's
``Checkpointer``, which reads and writes the JAX package's format.

The ``client`` of :class:`PreemptionHandler` is JAX's duck type
(``get_opt``, ``patch``); the port has no apiserver of its own.

Metrics, JAX's: ``training_preemptions_survived_total``,
``training_restart_seconds`` (plus ``checkpoint_save_seconds`` from the
checkpointer). Every run feeds a
:class:`~kubeflow_tpu_torch.monitoring.goodput.GoodputLedger`.
"""

from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device
from ..monitoring.goodput import GoodputLedger
from ..runtime.metrics import METRICS
from ..scheduler.gang import (DRAIN_ACK_ANNOTATION, DRAIN_DEADLINE_ANNOTATION,
                              annotations_of, is_terminal)
from .checkpoint import Checkpointer

LOG = logging.getLogger(__name__)
TRAIN = METRICS.namespace("training")
#: DrainStatus.state values, by their code in the per-step broadcast
_VERDICTS = ("ok", "draining", "lost")


@dataclass(frozen=True)
class DrainStatus:
    """What the gang's pods say about this incarnation's future."""

    state: str  # "ok" | "draining" | "lost"
    deadline: Optional[float] = None  # unix seconds, when draining


@dataclass(frozen=True)
class SliceOffer:
    """One gang's worth of capacity — whatever shape it happens to be.
    ``devices`` are the world ranks backing it (rank 0 among them in a
    world of several); (pp, virtual_stages) is the factorization the
    workload should rebuild for."""

    devices: Sequence[Any]
    pp: int = 1
    virtual_stages: int = 1
    pods: Sequence[str] = ()
    namespace: Optional[str] = None

    def describe(self) -> Dict[str, Any]:
        return {
            "chips": len(self.devices),
            "pp": self.pp,
            "virtualStages": self.virtual_stages,
            "pods": list(self.pods),
        }


class PreemptionHandler:
    """Between-step watcher for the drain protocol on a gang's pods.

    ``check()`` is called once per training step, so the pod sweep is
    rate-limited to ``poll_interval``; a drain verdict is sticky (once
    draining, always draining — the scheduler never un-asks).
    ``request_local_drain`` injects the same signal in-process.
    """

    def __init__(self, client, namespace: Optional[str], pod_names: Sequence[str],
                 poll_interval: float = 0.05) -> None:
        self._client = client
        self._namespace = namespace
        self._pods = list(pod_names)
        self._poll_interval = poll_interval
        self._last_poll = 0.0
        self._cached = DrainStatus("ok")

    def request_local_drain(self, grace: float = 5.0) -> None:
        self._cached = DrainStatus("draining", time.time() + grace)

    def check(self) -> DrainStatus:
        if self._cached.state == "draining":
            return self._cached
        now = time.monotonic()
        if now - self._last_poll < self._poll_interval:
            return self._cached
        self._last_poll = now
        self._cached = self._sweep()
        return self._cached

    def _sweep(self) -> DrainStatus:
        live = 0
        deadline: Optional[float] = None
        for name in self._pods:
            pod = self._client.get_opt("v1", "Pod", name, self._namespace)
            if pod is None or is_terminal(pod):
                continue
            live += 1
            raw = annotations_of(pod).get(DRAIN_DEADLINE_ANNOTATION)
            if raw is not None:
                try:
                    d = float(raw)
                except (TypeError, ValueError):
                    d = time.time()
                deadline = d if deadline is None else min(deadline, d)
        if deadline is not None:
            return DrainStatus("draining", deadline)
        if live == 0 and self._pods:
            # gang gone without a drain signal — killed node, hard crash
            return DrainStatus("lost")
        return DrainStatus("ok")

    def ack(self, step: int) -> None:
        """Tell the scheduler our state is safe: it may evict immediately
        instead of waiting out the grace deadline."""
        for name in self._pods:
            try:
                self._client.patch(
                    "v1", "Pod", name,
                    {"metadata": {"annotations": {DRAIN_ACK_ANNOTATION: str(step)}}},
                    self._namespace,
                )
            except Exception:  # pod already deleted: the ack is moot
                continue


@dataclass
class ElasticReport:
    """What one ``ElasticTrainer.run()`` lived through (rank 0's is the
    whole story; another gang rank's has the same losses)."""

    completed: bool
    losses: Dict[int, float] = field(default_factory=dict)
    preemptions_survived: int = 0
    restarts: int = 0
    incarnations: List[Dict[str, Any]] = field(default_factory=list)


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _bcast(obj: Any, group=None) -> Any:
    """Rank 0's ``obj`` on every rank of ``group`` (the world by default)."""
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=group)
    return box[0]


class ElasticTrainer:
    """Supervising loop: (re)acquire a slice, restore-or-init, train until
    drained/lost/done, checkpoint, repeat. Run it in every rank.

    The workload is JAX's duck type:

    - ``init(offer) -> state``                      (None outside the offer)
    - ``restore(offer, snapshot, meta) -> state``   (re-chunk for the offer)
    - ``snapshot(state) -> (tree, meta)``           (factorization-free;
      collective over the gang)
    - ``run_step(state, step) -> (state, loss)``    (data chosen BY step, so
      replayed steps reproduce the same curve)

    ``slice_provider(attempt)`` blocks until a gang is granted and returns
    a :class:`SliceOffer` (or None to give up); ``handler_factory(offer)``
    builds the :class:`PreemptionHandler`-shaped watcher for that gang (None
    disables drain detection). Rank 0 alone calls them, and writes and reads
    the checkpoints.
    """

    def __init__(self, workload, checkpointer: Checkpointer,
                 slice_provider: Callable[[int], Optional[SliceOffer]], total_steps: int, *,
                 checkpoint_every: int = 0,
                 handler_factory: Optional[Callable[[SliceOffer], Any]] = None,
                 max_incarnations: int = 32, goodput: Optional[GoodputLedger] = None) -> None:
        self.workload = workload
        self.ckpt = checkpointer
        self.slice_provider = slice_provider
        self.total_steps = int(total_steps)
        self.checkpoint_every = int(checkpoint_every)
        self.handler_factory = handler_factory
        self.max_incarnations = int(max_incarnations)
        self.goodput = goodput if goodput is not None else GoodputLedger()
        self.world, self.rank = _world()

    def run(self) -> ElasticReport:
        report = ElasticReport(completed=False)
        gp = self.goodput
        gp.start()
        step_clock = getattr(self.workload, "clock", None)
        if step_clock is not None:
            gp.attach_step_clock(step_clock)
        try:
            return self._run(report)
        finally:
            gp.finish()

    def _share(self, obj: Any, group=None) -> Any:
        return obj if self.world == 1 else _bcast(obj, group)

    def _run(self, report: ElasticReport) -> ElasticReport:
        gp = self.goodput
        beacon = getattr(self.workload, "beacon", None)
        for attempt in range(self.max_incarnations):
            t0 = time.perf_counter()
            gp.begin_incarnation(attempt)
            if beacon is not None:
                # incarnation gauge bumps BEFORE any step publishes, so the
                # straggler detector reads restart-then-step-reset in order
                beacon.begin_incarnation(attempt)
            offer = self.slice_provider(attempt) if self.rank == 0 else None
            offer = self._share(offer)
            if offer is None:
                break
            if self.world > 1 and 0 not in [int(d) for d in offer.devices]:
                raise ValueError(f"an offer must hold rank 0, which decides for the gang: "
                                 f"{list(offer.devices)}")
            gp.note("scheduling_wait", time.perf_counter() - t0)
            state, start = self._restore_or_init(offer)
            gang = None
            if self.world > 1 and len(offer.devices) < self.world:
                gang = dist.new_group([int(d) for d in offer.devices])  # collective
            handler = (self.handler_factory(offer)
                       if self.handler_factory is not None and self.rank == 0 else None)
            if attempt > 0:
                # acquire + restore + reshard — the restart cost
                TRAIN.histogram("restart_seconds").observe(time.perf_counter() - t0)
                report.restarts += 1
            inc = {"attempt": attempt, "startStep": start, "offer": offer.describe()}
            report.incarnations.append(inc)
            if state is not None:
                outcome, end_step = self._train(state, start, handler, gang, report)
            else:
                outcome, end_step = None, None
            # ranks outside the offer wait here for the gang's outcome
            outcome, end_step = self._share((outcome, end_step))
            inc["outcome"] = outcome
            inc["endStep"] = end_step
            inc["goodput"] = gp.end_incarnation(outcome, end_step)
            if outcome == "completed":
                report.completed = True
                return report
            LOG.warning("elastic: incarnation %d ended %s at step %d; re-requesting slice",
                        attempt, outcome, end_step)
        return report

    # -- one incarnation -----------------------------------------------------
    def _restore_or_init(self, offer: SliceOffer) -> Tuple[Any, int]:
        t0 = time.perf_counter()
        found = None
        if self.rank == 0:
            try:
                found = self.ckpt.restore_numpy()
            except FileNotFoundError:
                found = None
        found = self._share(found)
        if found is None:
            # nothing to read — the first incarnation's build is mesh and
            # step set-up for the offered shape, i.e. the reshard bucket
            t1 = time.perf_counter()
            state = self.workload.init(offer)
            self.goodput.note("reshard", time.perf_counter() - t1)
            return state, 0
        snap, meta = found
        self.goodput.note("checkpoint_restore", time.perf_counter() - t0)
        t1 = time.perf_counter()
        state = self.workload.restore(offer, snap, meta)
        self.goodput.note("reshard", time.perf_counter() - t1)
        return state, int(meta.get("step", -1)) + 1

    def _verdict(self, handler, gang) -> DrainStatus:
        """Rank 0's drain verdict for the step just taken, on every gang
        rank: one broadcast of [state, deadline] a step."""
        if self.handler_factory is None:
            return DrainStatus("ok")
        status = handler.check() if handler is not None else None
        if self.world == 1:
            return status
        nccl = dist.get_backend(gang) == "nccl"
        box = torch.full((2,), float("nan"), dtype=torch.float64,
                         device=torch.cuda.current_device() if nccl else "cpu")
        if status is not None:
            box[0] = _VERDICTS.index(status.state)
            if status.deadline is not None:
                box[1] = status.deadline
        dist.broadcast(box, src=0, group=gang)
        code, deadline = box.tolist()
        return DrainStatus(_VERDICTS[int(code)], None if math.isnan(deadline) else deadline)

    def _train(self, state, start: int, handler, gang, report: ElasticReport):
        step = start
        while step < self.total_steps:
            s0 = time.perf_counter()
            state, loss = self.workload.run_step(state, step)
            self.goodput.step(step, time.perf_counter() - s0)
            report.losses[step] = float(loss)
            if self.checkpoint_every and (step + 1) % self.checkpoint_every == 0:
                self._save(state, step)
            status = self._verdict(handler, gang)
            if status.state == "draining":
                # the urgent save: everything up to and including this step
                # survives the eviction, so zero steps are lost
                self._save(state, step)
                if handler is not None:
                    handler.ack(step)
                TRAIN.counter("preemptions_survived_total").inc()
                report.preemptions_survived += 1
                return "preempted", step
            if status.state == "lost":
                # no drain, no save: the next incarnation replays from the
                # last periodic checkpoint
                return "lost", step
            step += 1
        return "completed", step

    def _save(self, state, step: int) -> None:
        t0 = time.perf_counter()
        snap, wmeta = self.workload.snapshot(state)  # collective over the gang
        if self.rank == 0:
            meta = {"step": step}
            meta.update(wmeta or {})
            self.ckpt.save(step, snap, meta=meta)
        self.goodput.note("checkpoint_save", time.perf_counter() - t0)


class CompositeWorkload:
    """The composed-4D pipeline GPT (``parallel/composite.py``) as an
    elastic workload. The snapshot is the CANONICAL per-layer weight tree,
    so every incarnation rebuilds its own (pp, virtual_stages) chunking
    from it; initial weights are ``init_params``'s draw at ``init_seed``
    (a ``torch.Generator``: the same logical model on every factorization).

    Batches are derived from the step index (``np.random.RandomState(
    data_seed + step)``, as JAX's), never from an in-memory iterator, so
    the checkpoint's data cursor is just the step.

    With a ``clock`` (``gpu.profiling.StepClock``) the step is phased as
    JAX's: batch synthesis under ``data_wait``, execution under ``compute``
    (ending at a device synchronize on CUDA), the loss readback under
    ``fetch``, ``beacon.throttle()`` under ``collective``. Where JAX
    compiles ahead of time once an incarnation under ``compile``, the port
    times its first-use work there: one small all-reduce on each of the
    new mesh's process groups (NCCL builds a group's communicator at its
    first collective; ROADMAP C.4).
    """

    def __init__(self, cfg=None, *, lr: float = 0.1, num_micro: int = 4, microbatch: int = 4,
                 data_seed: int = 0, init_seed: int = 0, gather_mode: str = "eager",
                 clock: Optional[Any] = None, beacon: Optional[Any] = None,
                 device: DeviceLike = "cuda") -> None:
        from ..parallel.composite import CompositeConfig

        self.cfg = cfg or CompositeConfig()
        self.lr = lr
        self.num_micro = num_micro
        self.microbatch = microbatch
        self.data_seed = data_seed
        self.init_seed = init_seed
        self.gather_mode = gather_mode
        self.clock = clock
        #: training.heartbeat.WorkerBeacon — per-step heartbeat + the chaos
        #: throttle point (slow_worker / wedge_worker land here)
        self.beacon = beacon
        self.device = resolve_device(device)

    def _setup(self, offer: SliceOffer):
        from ..parallel.composite import make_train_step
        from ..parallel.mesh import MeshConfig, make_mesh

        mesh = make_mesh(MeshConfig(data=-1, pipe=offer.pp),
                         devices=[int(d) for d in offer.devices], device=self.device)
        if mesh is None:
            return None, None
        step_fn = make_train_step(self.cfg, mesh, self.lr, virtual_stages=offer.virtual_stages,
                                  gather_mode=self.gather_mode)
        return mesh, step_fn

    def init(self, offer: SliceOffer):
        from ..parallel.composite import init_params

        mesh, step_fn = self._setup(offer)
        if mesh is None:
            return None
        params = init_params(self.cfg, mesh, seed=self.init_seed,
                             virtual_stages=offer.virtual_stages)
        return {"mesh": mesh, "step_fn": step_fn, "params": params, "offer": offer}

    def restore(self, offer: SliceOffer, snap, meta):
        from ..parallel.composite import params_from_canonical

        mesh, step_fn = self._setup(offer)
        if mesh is None:
            return None
        params = params_from_canonical(snap["params"], self.cfg, mesh,
                                       virtual_stages=offer.virtual_stages)
        return {"mesh": mesh, "step_fn": step_fn, "params": params, "offer": offer}

    def snapshot(self, state):
        from ..parallel.composite import canonical_params

        offer = state["offer"]
        canon = canonical_params(state["params"], state["mesh"],
                                 virtual_stages=offer.virtual_stages)
        return {"params": canon}, {
            "pp": offer.pp,
            "virtualStages": offer.virtual_stages,
            "dataCursor": None,  # data is step-addressed; the step IS the cursor
        }

    def _batch(self, state, step: int) -> torch.Tensor:
        from ..parallel.composite import local_ids

        rng = np.random.RandomState(self.data_seed + step)
        ids = rng.randint(0, self.cfg.vocab_size,
                          size=(self.num_micro, self.microbatch, self.cfg.seq)).astype(np.int32)
        return local_ids(ids, state["mesh"])

    def _warm(self, state) -> None:
        """First-use work of an incarnation's mesh: one small all-reduce on
        each of its process groups."""
        from ..parallel.mesh import BATCH_AXES, CANONICAL_AXES

        mesh = state["mesh"]
        for axes in [(a,) for a in CANONICAL_AXES] + [BATCH_AXES]:
            dist.all_reduce(torch.zeros(1, device=mesh.device), group=mesh.group(axes))
        self._sync(state)

    def _sync(self, state) -> None:
        if state["mesh"].device.type == "cuda":
            torch.cuda.synchronize(state["mesh"].device)

    def run_step(self, state, step: int):
        if self.clock is None:
            t0 = time.perf_counter()
            params, loss = state["step_fn"](state["params"], self._batch(state, step))
            state["params"] = params
            loss = float(loss)
            if self.beacon is not None:
                wait = self.beacon.throttle()
                self.beacon.publish(
                    {"total": time.perf_counter() - t0, "collective_wait": wait}, step)
            return state, loss
        clock = self.clock
        with clock.data_wait():
            batch = self._batch(state, step)
        if not state.get("warm"):
            with clock.compile():
                self._warm(state)
            state["warm"] = True
        with clock.compute():
            params, loss = state["step_fn"](state["params"], batch)
            self._sync(state)
        with clock.fetch():
            loss = float(loss)
        if self.beacon is not None:
            # the gradient-sync barrier stand-in: a slowed/wedged worker
            # parks HERE, inside the measured collective_wait phase
            with clock.collective():
                self.beacon.throttle()
        rec = clock.end_step()
        if self.beacon is not None:
            self.beacon.publish(rec, step)
        state["params"] = params
        return state, loss
