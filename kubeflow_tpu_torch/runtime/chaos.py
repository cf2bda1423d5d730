"""Seeded fault injection for the control plane and the serving fleet: a
trimmed copy of ``kubeflow_tpu/runtime/chaos.py``.

The control-plane kinds act on a :class:`~kubeflow_tpu_torch.apiserver.client.Client`
(and, where named, its ``Store`` and the manager's informers):

- ``kill_node``           — a host vanishes: every pod bound to the node
  flips to Failed with NO drain warning, then the Node object is deleted;
- ``preempt_gang``        — the drain protocol, chaos-issued: the drain
  deadline annotation and a ``TrainingPreempted`` Event on the gang's
  pods, then their deletion once every live pod acks or the deadline
  passes (what ``scheduler/core.py`` does for a higher-priority gang);
- ``drop_informer_watch`` — close an informer's watch stream mid-flight,
  forcing the reconnect path (``informer_watch_reconnects_total``);
- ``delay_apiserver``     — hold the store's lock for ``param`` seconds, so
  every API call in the process stalls (an etcd brown-out).

The serving kinds act on an :class:`~kubeflow_tpu_torch.serving.fleet.EngineFleet`
(or anything exposing ``live_handles()``) through the engine hooks
``step_delay_s``, ``fail_next_step`` and ``cancel_requests``:

- ``slow_replica``            — add ``param`` seconds of latency to every
  engine iteration of one replica for ``duration`` seconds (a throttled or
  noisy-neighbour card): deadlines expire, the fleet breaker opens;
- ``crash_replica_mid_decode`` — poison one replica's next engine
  iteration so it dies as a device failure would, its in-flight requests
  failing with ``EngineClosed``;
- ``client_abandon``          — cancel up to ``param`` in-flight or queued
  requests (clients disconnecting mid-generation); the engine reaps the
  slots.

:class:`Fault` and :meth:`ChaosSchedule.seeded` are JAX's, arithmetic
unchanged, so the same seed and spec give the same faults. Not ported:
``flood_apiserver`` (the apiserver's fairness gate) and ``kill9_*`` (the
durable, multi-process control plane), and by design the training-worker
kinds ``slow_worker`` and ``wedge_worker``, whose effect the straggler
driver sets on its beacons itself. ``Fault`` refuses them as JAX's refuses
an unknown kind. ``stop()`` resets every slowed engine and joins the
side threads, and every firing bumps ``chaos_faults_injected_total{kind}``.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

from ..api import meta as apimeta
from .metrics import METRICS

LOG = logging.getLogger(__name__)

KINDS = ("kill_node", "preempt_gang", "drop_informer_watch", "delay_apiserver",
         "slow_replica", "crash_replica_mid_decode", "client_abandon")

#: chaos components stamp Events under this source
COMPONENT = "chaos-monkey"


@dataclass(frozen=True)
class Fault:
    """One scheduled failure: fire ``kind`` against ``target`` ``at``
    seconds after the monkey starts. ``target`` is a node, ``"ns/gang"``,
    an informer's kind or a replica's gauge id or id (None = the first
    live one). ``param`` is kind-specific: drain grace seconds for
    preempt_gang, stall seconds for delay_apiserver, per-iteration delay
    seconds for slow_replica, request count for client_abandon;
    ``duration`` bounds how long slow_replica stays applied (0 = until the
    monkey stops)."""

    at: float
    kind: str
    target: Optional[str] = None  # node | "ns/gang" | informer kind | replica
    param: float = 0.0
    duration: float = 0.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; expected one of {KINDS}")


class ChaosSchedule:
    """An ordered fault list, built explicitly or derived from a seed with
    :meth:`seeded`: the same (seed, spec) always yields the same schedule."""

    def __init__(self, faults: Sequence[Fault]) -> None:
        self.faults: List[Fault] = sorted(faults, key=lambda f: f.at)

    @classmethod
    def seeded(
        cls,
        seed: int,
        n: int,
        duration: float,
        targets: Dict[str, Sequence[str]],
        param: Dict[str, float] = None,
    ) -> "ChaosSchedule":
        """``n`` faults uniformly over ``duration`` seconds, kinds drawn
        from ``targets``' keys, target drawn per kind."""
        rng = random.Random(seed)
        kinds = sorted(targets)
        faults = []
        for _ in range(n):
            kind = rng.choice(kinds)
            choices = list(targets[kind])
            faults.append(
                Fault(
                    at=rng.uniform(0.0, duration),
                    kind=kind,
                    target=rng.choice(choices) if choices else None,
                    param=(param or {}).get(kind, 0.0),
                )
            )
        return cls(faults)


class ChaosMonkey:
    """Fires a :class:`ChaosSchedule` at a live control plane and serving
    fleet. ``store`` is only needed for ``delay_apiserver``, ``informers``
    (any iterable of SharedInformers) only for ``drop_informer_watch``,
    ``fleet`` only for the serving kinds. A fault that cannot be injected
    (a dependency absent, no live replica, nothing to abandon) is logged
    and skipped, as JAX's are: a harness asserts each fault's effect."""

    def __init__(self, client, schedule: ChaosSchedule, *, store=None,
                 informers: Sequence[Any] = (), fleet: Any = None) -> None:
        self._client = client
        self._schedule = schedule
        self._store = store
        self._informers = list(informers)
        #: EngineFleet (or anything with ``live_handles()``): the target set
        self._fleet = fleet
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        #: engines slowed by slow_replica, reset on stop() so a finished
        #: chaos run never leaves a replica degraded
        self._slowed: List[Any] = []
        self.fired: List[Fault] = []

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ChaosMonkey":
        t = threading.Thread(target=self._run, name="chaos-monkey", daemon=True)
        self._threads.append(t)
        t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        for eng in self._slowed:
            eng.step_delay_s = 0.0
        for t in self._threads:
            t.join(timeout=5.0)

    def join(self, timeout: Optional[float] = None) -> None:
        for t in list(self._threads):
            t.join(timeout=timeout)

    def _run(self) -> None:
        t0 = time.monotonic()
        for fault in self._schedule.faults:
            delay = fault.at - (time.monotonic() - t0)
            if delay > 0 and self._stop.wait(delay):
                return
            if self._stop.is_set():
                return
            self.inject(fault)

    # -- injectors -----------------------------------------------------------
    def inject(self, fault: Fault) -> None:
        LOG.warning("chaos: injecting %s target=%s param=%s",
                    fault.kind, fault.target, fault.param)
        try:
            getattr(self, f"_{fault.kind}")(fault)
        except Exception as e:  # a failed injection must not kill the monkey
            LOG.warning("chaos: %s failed: %s", fault.kind, e)
            return
        METRICS.counter("chaos_faults_injected_total", kind=fault.kind).inc()
        self.fired.append(fault)

    def _kill_node(self, fault: Fault) -> None:
        """Hardware death: pods on the node fail with no warning, then the
        Node object disappears from the ledger's world."""
        node = fault.target
        for pod in self._client.list("v1", "Pod"):
            if (pod.get("spec") or {}).get("nodeName") != node:
                continue
            pod = dict(pod)
            pod["status"] = dict(pod.get("status") or {})
            pod["status"]["phase"] = "Failed"
            try:
                self._client.update_status(pod)
            except Exception:
                continue
        try:
            self._client.delete("v1", "Node", node)
        except Exception:
            pass

    def _preempt_gang(self, fault: Fault) -> None:
        """The drain protocol, chaos-issued: deadline annotation and
        TrainingPreempted Event now; deletion on ack or deadline (in a side
        thread, so later faults stay on schedule)."""
        from ..scheduler.gang import (DRAIN_ACK_ANNOTATION, DRAIN_DEADLINE_ANNOTATION,
                                      POD_GROUP_LABEL)

        ns, _, gang = (fault.target or "").partition("/")
        ns = ns or None
        grace = max(0.0, fault.param)
        deadline = time.time() + grace
        pods = self._client.list("v1", "Pod", ns, label_selector={POD_GROUP_LABEL: gang})
        names = [apimeta.name_of(p) for p in pods]
        for p in pods:
            self._client.patch(
                "v1", "Pod", apimeta.name_of(p),
                {"metadata": {"annotations": {DRAIN_DEADLINE_ANNOTATION: f"{deadline:.3f}"}}},
                ns)
            self._client.emit_event(
                p, "TrainingPreempted",
                f"chaos preemption: checkpoint within {grace:.1f}s "
                f"(deadline {deadline:.3f}) or be evicted",
                type_="Warning", component=COMPONENT)

        def evict_when_ready():
            while not self._stop.is_set() and time.time() < deadline:
                live = acked = 0
                for name in names:
                    pod = self._client.get_opt("v1", "Pod", name, ns)
                    if pod is None:
                        continue
                    live += 1
                    if apimeta.annotations_of(pod).get(DRAIN_ACK_ANNOTATION):
                        acked += 1
                if live == 0 or acked == live:
                    break
                self._stop.wait(0.02)
            for name in names:
                try:
                    self._client.delete("v1", "Pod", name, ns)
                except Exception:
                    continue

        t = threading.Thread(target=evict_when_ready, name="chaos-evict", daemon=True)
        self._threads.append(t)
        t.start()

    def _drop_informer_watch(self, fault: Fault) -> None:
        """Sever the watch stream; the informer must relist and reconnect."""
        dropped = 0
        for inf in self._informers:
            if fault.target and getattr(inf, "kind", None) != fault.target:
                continue
            watcher = getattr(inf, "_watcher", None)
            if watcher is None:
                continue
            try:
                watcher.close()
                dropped += 1
            except Exception:
                continue
        if not dropped:
            raise RuntimeError(f"no informer watch to drop for {fault.target!r}")

    def _delay_apiserver(self, fault: Fault) -> None:
        """etcd brown-out: hold the store's lock so every API call (and
        every watch delivery) stalls for ``param`` seconds."""
        if self._store is None:
            raise RuntimeError("delay_apiserver needs a store")
        seconds = max(0.0, fault.param)

        def hold():
            with self._store._lock:
                # an interruptible sleep: stop() must not wait out the stall
                end = time.monotonic() + seconds
                while time.monotonic() < end and not self._stop.is_set():
                    time.sleep(max(0.0, min(0.02, end - time.monotonic())))

        t = threading.Thread(target=hold, name="chaos-apiserver-delay", daemon=True)
        self._threads.append(t)
        t.start()

    def _find_replica(self, target: Optional[str]):
        """Resolve ``target`` against the fleet's live replicas by gauge id
        or replica id; None picks the first live replica."""
        if self._fleet is None:
            raise RuntimeError("serving faults need a fleet")
        handles = list(self._fleet.live_handles())
        if not handles:
            raise RuntimeError("no live replica to target")
        if target is None:
            return handles[0]
        for h in handles:
            if target in (getattr(h, "gauge_id", None), getattr(h, "id", None)):
                return h
        raise RuntimeError(f"no live replica matches {target!r}")

    def _slow_replica(self, fault: Fault) -> None:
        """Every engine iteration on the replica gains ``param`` seconds;
        after ``duration`` seconds (or stop()) the replica recovers."""
        eng = self._find_replica(fault.target).engine
        eng.step_delay_s = max(0.0, fault.param)
        self._slowed.append(eng)
        if fault.duration > 0:

            def recover():
                self._stop.wait(fault.duration)
                eng.step_delay_s = 0.0

            t = threading.Thread(target=recover, name="chaos-slow-recover", daemon=True)
            self._threads.append(t)
            t.start()

    def _crash_replica_mid_decode(self, fault: Fault) -> None:
        """Poison the replica's next engine iteration: it raises mid-decode,
        the engine shuts down, and every in-flight request fails with
        EngineClosed. An idle engine is poked so that it crashes now: JAX's
        waits for its next request and fails it, so a fleet could route
        there and answer 503 after the crash."""
        engine = self._find_replica(fault.target).engine
        engine.fail_next_step = True
        poke = getattr(engine, "poke", None)
        if poke is not None:
            poke()

    def _client_abandon(self, fault: Fault) -> None:
        """Cancel up to ``param`` in-flight or queued requests on the target
        replica, then on the others (all replicas when no target is named)."""
        want = max(1, int(fault.param or 1))
        if self._fleet is None:
            raise RuntimeError("serving faults need a fleet")
        handles = list(self._fleet.live_handles())
        if fault.target is not None:
            handles = [self._find_replica(fault.target)] + [
                h for h in handles
                if fault.target not in (getattr(h, "gauge_id", None),
                                        getattr(h, "id", None))
            ]
        cancelled = 0
        for h in handles:
            cancelled += h.engine.cancel_requests(want - cancelled)
            if cancelled >= want:
                break
        if cancelled == 0:
            raise RuntimeError("no in-flight request to abandon")
